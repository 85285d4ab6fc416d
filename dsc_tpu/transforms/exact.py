"""scipy.fft-parity FFT family: exact lengths, norms, n-D, shifts.

The dsc FFT surface (dsc_tpu.fft/ifft/rfft/irfft) keeps the reference's
pad-to-pow2 identity (reference dsc.cpp:2023-2028, dsc.h:384-391). This
tier mirrors ``scipy.fft`` instead — the de-facto NumPy-ecosystem FFT
contract: exact length-n transforms for ANY n (pow2 rides the planar
engine, others Bluestein — see _dft.py), ``norm`` =
backward/ortho/forward, axis/axes/s handling, Hermitian transforms,
shifts and fast-length helpers. scipy.fft is the executable spec
(tests/test_transforms.py).

Each public call compiles to ONE XLA program (moveaxis, length fitting,
the transform, and the norm scale fuse together); signals and spectra
are dsc Tensors (array-likes accepted); compute is f32/c32 on device,
design math f64 on host (tier convention, docs/PARITY.md).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import tracing
from ..fourier import plan as fft_plan
from ..planar import Planar
from ..tensor import Tensor, _finish, from_numpy
from . import _dft

__all__ = [
    'fft', 'ifft', 'rfft', 'irfft', 'hfft', 'ihfft',
    'fft2', 'ifft2', 'rfft2', 'irfft2', 'hfft2', 'ihfft2',
    'fftn', 'ifftn', 'rfftn', 'irfftn', 'hfftn', 'ihfftn',
    'fftshift', 'ifftshift', 'fftfreq', 'rfftfreq',
    'next_fast_len', 'prev_fast_len',
]

_NORMS = ('backward', 'ortho', 'forward')


def _norm_scale(norm: Optional[str], n: int, forward: bool, who: str) -> float:
    """Extra scale on top of the engine convention (forward unscaled,
    inverse 1/n)."""
    if norm is None:
        norm = 'backward'
    if norm not in _NORMS:
        raise RuntimeError(f"{who}: invalid norm {norm!r} (use 'backward', "
                           "'ortho' or 'forward')")
    if norm == 'backward':
        return 1.0
    if norm == 'ortho':
        return 1.0 / math.sqrt(n) if forward else math.sqrt(n)
    return 1.0 / n if forward else float(n)


def _as_tensor(x) -> Tensor:
    return x if isinstance(x, Tensor) else from_numpy(np.asarray(x))


def _planes_of(x: Tensor):
    """Tensor -> (re plane, im plane | None) f32, original nd shape
    (models/short_time_fft.py:_as_batched_planar convention)."""
    if x.dtype.is_complex:
        pp = x._planar
        if pp is not None and pp.shape == x.shape:
            xr, xi = pp.re, pp.im
        else:
            xj = x.jax
            xr, xi = jnp.real(xj), jnp.imag(xj)
        return xr.astype(jnp.float32), xi.astype(jnp.float32)
    return x.jax.astype(jnp.float32), None


def _resolve_axis(ndim: int, axis: int, who: str) -> int:
    ax = axis + ndim if axis < 0 else axis
    if ax < 0 or ax >= ndim:
        raise RuntimeError(f'{who}: axis {axis} is out of bounds for a '
                           f'{ndim}-D tensor')
    return ax


def _wrap_planar(yr: jax.Array, yi: jax.Array) -> Tensor:
    return Tensor._from_planar(Planar(yr, yi, tuple(yr.shape)))


# --------------------------------------------------------------------------
# jitted programs (plans passed as arguments — plan.py cache discipline)
# --------------------------------------------------------------------------


def _rows(p: jax.Array, axis: int, n: int):
    """moveaxis -> (B, len) rows -> fit the last axis to n (truncate, or
    zero-pad at the end — the np.fft n contract)."""
    if axis != p.ndim - 1:
        p = jnp.moveaxis(p, axis, -1)
    lead = tuple(p.shape[:-1])
    p = p.reshape(-1, p.shape[-1])
    cur = p.shape[-1]
    if cur > n:
        p = p[:, :n]
    elif cur < n:
        p = jnp.pad(p, ((0, 0), (0, n - cur)))
    return p, lead


def _unrows(p: jax.Array, lead: Tuple[int, ...], axis: int) -> jax.Array:
    p = p.reshape(lead + (p.shape[-1],))
    if axis != p.ndim - 1:
        p = jnp.moveaxis(p, -1, axis)
    return p


@partial(jax.jit, static_argnames=('static', 'meta'))
def _c2c_prog(xr, xi, tabs, static, meta):
    n, axis, inverse, scale = meta
    xr, lead = _rows(xr, axis, n)
    if xi is not None:
        xi, _ = _rows(xi, axis, n)
    yr, yi = _dft.dft_rows(xr, xi, tabs, static, inverse)
    if scale != 1.0:
        s = np.float32(scale)
        yr, yi = yr * s, yi * s
    return _unrows(yr, lead, axis), _unrows(yi, lead, axis)


@partial(jax.jit, static_argnames=('static', 'meta'))
def _r2c_prog(x, tabs, static, meta):
    n, axis, scale, conj_out = meta
    x, lead = _rows(x, axis, n)
    yr, yi = _dft.rdft_rows(x, tabs, static)
    s = np.float32(scale)
    if scale != 1.0:
        yr = yr * s
    yi = yi * (-s if conj_out else s) if (conj_out or scale != 1.0) else yi
    return _unrows(yr, lead, axis), _unrows(yi, lead, axis)


@partial(jax.jit, static_argnames=('static', 'meta'))
def _c2r_prog(xr, xi, tabs, static, meta):
    n, axis, scale, conj_in = meta
    m = n // 2 + 1
    xr, lead = _rows(xr, axis, m)
    if xi is None:
        xi = jnp.zeros_like(xr)
    else:
        xi, _ = _rows(xi, axis, m)
    if conj_in:
        xi = -xi
    # the c2r contract ignores the imaginary parts of the DC and (even n)
    # Nyquist bins (pocketfft/scipy behavior); the engine's untangle path
    # would otherwise fold them into the output for non-Hermitian input
    xi = xi.at[:, 0].set(0.0)
    if n % 2 == 0 and m > 1:
        xi = xi.at[:, m - 1].set(0.0)
    y = _dft.irdft_rows(xr, xi, tabs, static)
    if scale != 1.0:
        y = y * np.float32(scale)
    return _unrows(y, lead, axis)


@partial(jax.jit, static_argnames=('shifts',))
def _roll_prog(p, shifts):
    for ax, s in shifts:
        p = jnp.roll(p, s, axis=ax)
    return p


# --------------------------------------------------------------------------
# 1-D public surface
# --------------------------------------------------------------------------


def _fft_1d(x, n, axis, norm, inverse, who) -> Tensor:
    x = _as_tensor(x)
    ax = _resolve_axis(x.n_dim, axis, who)
    nn = x.shape[ax] if n is None else int(n)
    static, tabs = _dft.dft_plan(nn)
    scale = _norm_scale(norm, nn, forward=not inverse, who=who)
    xr, xi = _planes_of(x)
    with tracing.trace_op(who, 'op;transforms', tracing.tensor_args(x=x)):
        yr, yi = _c2c_prog(xr, xi, tabs, static, (nn, ax, inverse, scale))
    return _wrap_planar(yr, yi)


def fft(x, n: Optional[int] = None, axis: int = -1,
        norm: Optional[str] = None) -> Tensor:
    """Exact length-n DFT over ``axis`` (scipy.fft.fft semantics)."""
    return _fft_1d(x, n, axis, norm, inverse=False, who='tf.fft')


def ifft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None) -> Tensor:
    """Exact inverse DFT (scipy.fft.ifft semantics)."""
    return _fft_1d(x, n, axis, norm, inverse=True, who='tf.ifft')


def _real_input_planes(x: Tensor, who: str) -> jax.Array:
    if x.dtype.is_complex:
        raise RuntimeError(f'{who}: expected a real input (scipy.fft '
                           'raises here too); use fft for complex input')
    return x.jax.astype(jnp.float32)


def rfft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None) -> Tensor:
    """Half-spectrum DFT of real input, out length n//2+1
    (scipy.fft.rfft semantics)."""
    x = _as_tensor(x)
    ax = _resolve_axis(x.n_dim, axis, 'tf.rfft')
    nn = x.shape[ax] if n is None else int(n)
    xj = _real_input_planes(x, 'tf.rfft')
    static, tabs = _dft.rdft_plan(nn)
    scale = _norm_scale(norm, nn, forward=True, who='tf.rfft')
    with tracing.trace_op('tf.rfft', 'op;transforms',
                          tracing.tensor_args(x=x)):
        yr, yi = _r2c_prog(xj, tabs, static, (nn, ax, scale, False))
    return _wrap_planar(yr, yi)


def ihfft(x, n: Optional[int] = None, axis: int = -1,
          norm: Optional[str] = None) -> Tensor:
    """Inverse of hfft: conj(rfft(x, n))/n under the backward norm
    (np.fft.ihfft identity; scipy.fft.ihfft semantics)."""
    x = _as_tensor(x)
    ax = _resolve_axis(x.n_dim, axis, 'tf.ihfft')
    nn = x.shape[ax] if n is None else int(n)
    xj = _real_input_planes(x, 'tf.ihfft')
    static, tabs = _dft.rdft_plan(nn)
    scale = _norm_scale(norm, nn, forward=False, who='tf.ihfft') / nn
    with tracing.trace_op('tf.ihfft', 'op;transforms',
                          tracing.tensor_args(x=x)):
        yr, yi = _r2c_prog(xj, tabs, static, (nn, ax, scale, True))
    return _wrap_planar(yr, yi)


def _c2r_1d(x, n, axis, norm, conj_in, forward_like, who) -> Tensor:
    x = _as_tensor(x)
    ax = _resolve_axis(x.n_dim, axis, who)
    if n is None:
        nn = 2 * (x.shape[ax] - 1)
        if nn < 1:
            raise RuntimeError(f'{who}: cannot infer the output length '
                               'from a length-1 input; pass n explicitly')
    else:
        nn = int(n)
    if nn < 1:
        raise RuntimeError(f'{who}: n ({nn}) must be >= 1')
    static, tabs = _dft.rdft_plan(nn)
    # the engine's irdft carries 1/n; hfft (forward-like) wants the raw
    # sum under the backward norm -> fold n back in
    scale = _norm_scale(norm, nn, forward=forward_like, who=who)
    if forward_like:
        scale *= nn
    xr, xi = _planes_of(x)
    with tracing.trace_op(who, 'op;transforms', tracing.tensor_args(x=x)):
        y = _c2r_prog(xr, xi, tabs, static, (nn, ax, scale, conj_in))
    return _finish(y, None)


def irfft(x, n: Optional[int] = None, axis: int = -1,
          norm: Optional[str] = None) -> Tensor:
    """Inverse of rfft, real output of length n (default 2*(m-1);
    scipy.fft.irfft semantics — pass n for odd-length signals)."""
    return _c2r_1d(x, n, axis, norm, conj_in=False, forward_like=False,
                   who='tf.irfft')


def hfft(x, n: Optional[int] = None, axis: int = -1,
         norm: Optional[str] = None) -> Tensor:
    """DFT of a Hermitian-symmetric signal given its half spectrum: real
    output of length n (scipy.fft.hfft = irfft(conj(x), n) * n)."""
    return _c2r_1d(x, n, axis, norm, conj_in=True, forward_like=True,
                   who='tf.hfft')


# --------------------------------------------------------------------------
# n-D wrappers
# --------------------------------------------------------------------------


def _resolve_axes(ndim: int, s, axes, who: str):
    """(s, axes) pair resolution (the scipy.fft *n contract)."""
    if axes is None:
        if s is not None:
            axes = tuple(range(ndim - len(tuple(s)), ndim))
        else:
            axes = tuple(range(ndim))
    else:
        axes = tuple(int(a) for a in axes)
    axes = tuple(_resolve_axis(ndim, a, who) for a in axes)
    if len(set(axes)) != len(axes):
        raise RuntimeError(f'{who}: repeated axes {axes}')
    if s is not None:
        s = tuple(int(v) for v in s)
        if len(s) != len(axes):
            raise RuntimeError(f'{who}: s and axes have different lengths '
                               f'({len(s)} vs {len(axes)})')
    return s, axes


def _fftn_like(x, s, axes, norm, inverse, who) -> Tensor:
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, who)
    y = x
    for i, ax in enumerate(axes):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse, who)
    return y


def fftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """N-D DFT over ``axes`` (scipy.fft.fftn semantics)."""
    return _fftn_like(x, s, axes, norm, inverse=False, who='tf.fftn')


def ifftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """N-D inverse DFT (scipy.fft.ifftn semantics)."""
    return _fftn_like(x, s, axes, norm, inverse=True, who='tf.ifftn')


def fft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return fftn(x, s, axes, norm)


def ifft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return ifftn(x, s, axes, norm)


def rfftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """N-D DFT of real input: rfft over the last transform axis, then
    complex DFTs over the rest (scipy.fft.rfftn semantics)."""
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, 'tf.rfftn')
    n_last = s[-1] if s is not None else None
    y = rfft(x, n_last, axes[-1], norm)
    for i, ax in enumerate(axes[:-1]):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse=False, who='tf.rfftn')
    return y


def rfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return rfftn(x, s, axes, norm)


def irfftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """Inverse of rfftn (scipy.fft.irfftn semantics; pass s to pin the
    last-axis output length)."""
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, 'tf.irfftn')
    y = x
    for i, ax in enumerate(axes[:-1]):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse=True, who='tf.irfftn')
    n_last = s[-1] if s is not None else None
    return irfft(y, n_last, axes[-1], norm)


def irfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return irfftn(x, s, axes, norm)


def hfftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """N-D transform of Hermitian-symmetric input: forward DFTs over the
    leading axes, hfft over the last (scipy.fft.hfftn composition)."""
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, 'tf.hfftn')
    y = x
    for i, ax in enumerate(axes[:-1]):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse=False, who='tf.hfftn')
    n_last = s[-1] if s is not None else None
    return hfft(y, n_last, axes[-1], norm)


def hfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return hfftn(x, s, axes, norm)


def ihfftn(x, s=None, axes=None, norm: Optional[str] = None) -> Tensor:
    """Inverse of hfftn (scipy.fft.ihfftn contract: ihfft over the last
    transform axis, inverse DFTs over the rest)."""
    x = _as_tensor(x)
    s, axes = _resolve_axes(x.n_dim, s, axes, 'tf.ihfftn')
    n_last = s[-1] if s is not None else None
    y = ihfft(x, n_last, axes[-1], norm)
    for i, ax in enumerate(axes[:-1]):
        ni = s[i] if s is not None else None
        y = _fft_1d(y, ni, ax, norm, inverse=True, who='tf.ihfftn')
    return y


def ihfft2(x, s=None, axes=(-2, -1), norm: Optional[str] = None) -> Tensor:
    return ihfftn(x, s, axes, norm)


# --------------------------------------------------------------------------
# shifts and helpers
# --------------------------------------------------------------------------


def _shift_like(x, axes, sign: int, who: str) -> Tensor:
    x = _as_tensor(x)
    if axes is None:
        ax_list = tuple(range(x.n_dim))
    elif isinstance(axes, (int, np.integer)):
        ax_list = (_resolve_axis(x.n_dim, int(axes), who),)
    else:
        ax_list = tuple(_resolve_axis(x.n_dim, int(a), who) for a in axes)
    # fftshift rolls by +n//2, ifftshift by -(n//2) == +ceil(n/2)-n
    shifts = tuple(
        (a, (x.shape[a] // 2) if sign > 0 else -(x.shape[a] // 2))
        for a in ax_list
    )
    xr, xi = _planes_of(x)
    with tracing.trace_op(who, 'op;transforms', tracing.tensor_args(x=x)):
        yr = _roll_prog(xr, shifts)
        yi = _roll_prog(xi, shifts) if xi is not None else None
    if yi is None:
        return _finish(yr, None)
    return _wrap_planar(yr, yi)


def fftshift(x, axes=None) -> Tensor:
    """Shift the zero-frequency bin to the center (scipy.fft.fftshift)."""
    return _shift_like(x, axes, +1, 'tf.fftshift')


def ifftshift(x, axes=None) -> Tensor:
    """Inverse of fftshift (scipy.fft.ifftshift)."""
    return _shift_like(x, axes, -1, 'tf.ifftshift')


def fftfreq(n: int, d: float = 1.0):
    """DFT sample frequencies (scipy.fft.fftfreq signature, dsc Tensor
    out)."""
    from ..fourier import fftfreq as _ff

    return _ff(n, d)


def rfftfreq(n: int, d: float = 1.0):
    from ..fourier import rfftfreq as _rf

    return _rf(n, d)


def next_fast_len(target: int, real: bool = False) -> int:
    """Smallest length >= target that this engine transforms fastest.

    The dsc planar engine is radix-2 (Stockham/four-step,
    fourier/plan.py), so "fast" here means the next power of two
    — unlike scipy's 5-smooth answer; Bluestein covers every other
    length at a constant-factor cost. ``real`` is accepted for signature
    parity (pow2 is optimal for both paths)."""
    del real
    if target < 1:
        raise RuntimeError(f'next_fast_len: target ({target}) must be >= 1')
    return fft_plan.next_pow2(target)


def prev_fast_len(target: int, real: bool = False) -> int:
    """Largest fast (power-of-two) length <= target."""
    del real
    if target < 1:
        raise RuntimeError(f'prev_fast_len: target ({target}) must be >= 1')
    return 1 << (target.bit_length() - 1)


# --------------------------------------------------------------------------
# workers context (scipy.fft.set_workers/get_workers parity)
# --------------------------------------------------------------------------

import contextlib as _contextlib
import os as _os
import threading as _threading

_workers_local = _threading.local()


def get_workers() -> int:
    """Current workers-context value (scipy.fft.get_workers parity;
    default 1). The XLA runtime owns intra-op parallelism, so the
    value is advisory — honored as the API contract, not a thread pool."""
    return getattr(_workers_local, 'value', 1)


@_contextlib.contextmanager
def set_workers(workers: int):
    """Context manager mirroring scipy.fft.set_workers: everything inside
    sees ``get_workers() == workers``. XLA already parallelizes every
    transform across the device's compute units; this exists so code
    written against scipy.fft ports over unchanged."""
    workers = int(workers)
    if workers == 0:
        raise RuntimeError('tf.set_workers: workers must not be zero')
    if workers < 0:
        # scipy parity: -1 means "all cpus", -2 all-but-one, ...; values
        # below -cpu_count are rejected (scipy.fft._pocketfft.helper)
        ncpu = _os.cpu_count() or 1
        if workers < -ncpu:
            raise RuntimeError(
                f'tf.set_workers: workers ({workers}) exceeds the number '
                f'of available CPUs ({ncpu}); must be >= -{ncpu}'
            )
    prev = get_workers()
    _workers_local.value = workers
    try:
        yield
    finally:
        _workers_local.value = prev
