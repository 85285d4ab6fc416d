"""Planar complex storage: (re, im) float planes behind a complex Tensor.

The model tier (STFT, PSD, ShortTimeFFT, the scipy.fft-parity transforms)
computes spectra as separate real and imaginary planes. This module lets
the public Tensor hold such a result without combining the planes into one
complex array; elementwise ops between planar tensors, and with scalars,
stay on the planes, and anything else materializes the dense complex value
lazily (``Tensor.jax``).

A ``Planar`` value is two same-shape float planes; its logical shape is the
planes' shape.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


class Planar:
    """Two float planes representing a complex value of ``shape``."""

    __slots__ = ('re', 'im', 'shape', '_dense')

    def __init__(self, re: jax.Array, im: jax.Array, shape):
        shape = tuple(shape)
        assert re.shape == im.shape == shape and re.dtype == im.dtype, (
            re.shape, im.shape, shape)
        self.re = re
        self.im = im
        self.shape = shape
        self._dense: Optional[jax.Array] = None

    # -- metadata (what _Buffer / Tensor need) ------------------------------

    @property
    def dtype(self):
        return np.dtype(
            np.complex64 if self.re.dtype == jnp.float32 else np.complex128
        )

    @property
    def nbytes(self) -> int:
        return int(self.re.nbytes) + int(self.im.nbytes)

    @property
    def ne(self) -> int:
        return int(self.re.size)

    # -- materialization ------------------------------------------------------

    def materialize(self) -> jax.Array:
        """Dense complex array (cached)."""
        if self._dense is None:
            self._dense = _combine(self.re, self.im)
        return self._dense

    def to_numpy(self) -> np.ndarray:
        """Host complex array: downloads the two float planes and combines
        them on the host."""
        out = np.empty(self.shape, dtype=self.dtype)
        out.real = np.asarray(self.re)
        out.imag = np.asarray(self.im)
        return out


@jax.jit
def _combine(re, im):
    return jax.lax.complex(re, im)


# ---------------------------------------------------------------------------
# plane arithmetic (complex formulas on planes; reference functor math,
# dsc_ops.h:46-90)
# ---------------------------------------------------------------------------


def _complex_math(ar, ai, br, bi, name):
    if name == 'add':
        return ar + br, ai + bi
    if name == 'sub':
        return ar - br, ai - bi
    if name == 'mul':
        return ar * br - ai * bi, ar * bi + ai * br
    if name == 'div':
        d = br * br + bi * bi
        return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d
    if name == 'pow':
        from .ops.kernels import _cpow_planes

        return _cpow_planes(ar, ai, br, bi)
    raise AssertionError(name)


@partial(jax.jit, static_argnames=('name',))
def _pp_jit(ar, ai, br, bi, *, name):
    return _complex_math(ar, ai, br, bi, name)


def binary_pp(name: str, a: Planar, b: Planar) -> Optional[Planar]:
    """Planar x planar elementwise op; None if shapes or precisions differ
    (the caller then falls back to dense materialization)."""
    if a.shape != b.shape or a.re.dtype != b.re.dtype:
        return None
    yr, yi = _pp_jit(a.re, a.im, b.re, b.im, name=name)
    return Planar(yr, yi, a.shape)


def binary_ps(name: str, a: Planar, s: complex, reverse: bool) -> Planar:
    """Planar x python-scalar op (scalar on the right unless
    ``reverse``)."""
    fdt = np.float32 if a.re.dtype == jnp.float32 else np.float64
    br = fdt(s.real)
    bi = fdt(s.imag)
    if reverse:
        yr, yi = _pp_jit(br, bi, a.re, a.im, name=name)
    else:
        yr, yi = _pp_jit(a.re, a.im, br, bi, name=name)
    return Planar(yr, yi, a.shape)


# ---------------------------------------------------------------------------
# unary plane ops (the reference's complex conventions, dsc.cpp:1444-1622)
# ---------------------------------------------------------------------------


@jax.jit
def neg_im(im):
    return -im


@jax.jit
def abs_planes(re, im):
    return jnp.sqrt(re * re + im * im)


@jax.jit
def angle_planes(re, im):
    return jnp.arctan2(im, re)
