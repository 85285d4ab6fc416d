"""Public FFT API for dsc_tpu.

Rebuild of the reference FFT surface
(dsc.h:384-424, dsc/src/dsc.cpp:1955-2340):

- fft/ifft/rfft/irfft over any axis of a rank<=4 tensor
- sizes silently rounded UP to the next power of two with pad/crop of the
  input (reference dsc.cpp:2023-2028)
- rfft shape rules: out_n = n/2 + 1 forward, 2*(n-1) inverse
  (dsc.cpp:2188-2201)
- fftfreq/rfftfreq generators matching np.fft incl. odd n
  (dsc.cpp:2262-2340)
- a bounded LRU plan cache warmed by plan_fft (dsc.cpp:182-267)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import tracing
from ..dtype import DTYPE_TO_NP, Dtype
from ..tensor import Tensor, _finish
from . import core, plan
from .plan import next_pow2

__all__ = [
    'fft',
    'ifft',
    'rfft',
    'irfft',
    'fft2',
    'ifft2',
    'rfft2',
    'irfft2',
    'fftfreq',
    'rfftfreq',
    'plan_fft',
]


def _complex_dtype(dt: Dtype) -> Dtype:
    return dt.as_complex


def _work_cdtype(dt: Dtype):
    """Working complex precision for a given input dtype."""
    return DTYPE_TO_NP[dt.as_complex]


def plan_fft(n: int, dtype: Dtype = Dtype.F64, fft_type: str = 'complex'):
    """Warm the plan cache for an n-point transform (reference
    dsc_plan_fft; the Python binding's dropped fft_type arg —
    _bindings.py:85-93 — is fixed here per SURVEY Appendix B)."""
    nn = next_pow2(n)
    cdtype = np.complex128 if dtype in (Dtype.F64, Dtype.C64) else np.complex64
    plan.get_plan(nn, fft_type, cdtype)


def fft(x: Tensor, out: Optional[Tensor] = None, n: int = -1, axis: int = -1) -> Tensor:
    return _fft_like(x, out, n, axis, inverse=False)


def ifft(x: Tensor, out: Optional[Tensor] = None, n: int = -1, axis: int = -1) -> Tensor:
    return _fft_like(x, out, n, axis, inverse=True)


def _resolve_axis(x: Tensor, axis: int) -> int:
    ax = axis + x.n_dim if axis < 0 else axis
    if ax < 0 or ax >= x.n_dim:
        raise RuntimeError(f'axis {axis} is out of bounds for a {x.n_dim}-D tensor')
    return ax


def _fft_like(x: Tensor, out, n: int, axis: int, inverse: bool) -> Tensor:
    ax = _resolve_axis(x, axis)
    x_n = x.shape[ax]
    nn = next_pow2(n) if n > 0 else next_pow2(x_n)
    name = 'ifft' if inverse else 'fft'
    cdt = _work_cdtype(x.dtype)
    spec, tables = plan.get_plan(nn, 'complex', cdt)
    with tracing.trace_op(name, 'op;fft', tracing.tensor_args(x=x)) as tr:
        res = core.fft_nd(
            x.jax, tables, spec, nn, ax, inverse, np.dtype(cdt).name
        )
        if tr:
            tr.result = res
    return _finish(res, out)


def rfft(x: Tensor, out: Optional[Tensor] = None, n: int = -1, axis: int = -1) -> Tensor:
    if not x.dtype.is_real:
        raise RuntimeError('RFFT input must be real')
    ax = _resolve_axis(x, axis)
    x_n = x.shape[ax]
    # fft_order = pow2(n or x_n) >> 1; out_n = fft_order + 1
    # (reference dsc.cpp:2194-2197)
    full_n = next_pow2(n) if n > 0 else next_pow2(x_n)
    cdt = _work_cdtype(x.dtype)
    spec, tables = plan.get_plan(full_n, 'real', cdt)
    with tracing.trace_op('rfft', 'op;fft', tracing.tensor_args(x=x)) as tr:
        res = core.rfft_nd(x.jax, tables, spec, full_n, ax)
        if tr:
            tr.result = res
    return _finish(res, out)


def irfft(x: Tensor, out: Optional[Tensor] = None, n: int = -1, axis: int = -1) -> Tensor:
    if not x.dtype.is_complex:
        raise RuntimeError('IRFFT input must be complex')
    ax = _resolve_axis(x, axis)
    x_n = x.shape[ax]
    # fft_order = pow2(n-1 or x_n-1); out_n = 2 * fft_order
    # (reference dsc.cpp:2198-2201)
    order = next_pow2(n - 1) if n > 0 else next_pow2(x_n - 1)
    full_n = order * 2
    cdt = DTYPE_TO_NP[x.dtype]
    spec, tables = plan.get_plan(full_n, 'real', cdt)
    with tracing.trace_op('irfft', 'op;fft', tracing.tensor_args(x=x)) as tr:
        res = core.irfft_nd(
            x.jax, tables, spec, full_n, ax, np.dtype(cdt).name
        )
        if tr:
            tr.result = res
    return _finish(res, out)


def fftfreq(n: int, d: float = 1.0, dtype: Dtype = Dtype.F32) -> Tensor:
    """np.fft.fftfreq-compatible (reference dsc.cpp:2262-2302)."""
    if n <= 0:
        raise RuntimeError('n must be > 0')
    if dtype.is_complex:
        raise RuntimeError('fftfreq dtype must be real')
    np_dt = DTYPE_TO_NP[dtype]
    factor = 1.0 / (n * d)
    odd = n & 1
    n2 = (n - 1) // 2 if odd else n // 2
    head = np.arange(0, n2 + odd, dtype=np.float64)
    tail = np.arange(-n2, 0, dtype=np.float64)
    vals = (np.concatenate([head, tail]) * factor).astype(np_dt)
    return Tensor(vals)


def rfftfreq(n: int, d: float = 1.0, dtype: Dtype = Dtype.F32) -> Tensor:
    """np.fft.rfftfreq-compatible (reference dsc.cpp:2304-2340)."""
    if n <= 0:
        raise RuntimeError('n must be > 0')
    if dtype.is_complex:
        raise RuntimeError('rfftfreq dtype must be real')
    np_dt = DTYPE_TO_NP[dtype]
    factor = 1.0 / (n * d)
    n2 = ((n - 1) // 2 + 1) if (n & 1) else (n // 2 + 1)
    vals = (np.arange(n2, dtype=np.float64) * factor).astype(np_dt)
    return Tensor(vals)


def _axes2(x: Tensor, axes) -> tuple:
    a0, a1 = (_resolve_axis(x, a) for a in axes)
    if a0 == a1:
        raise RuntimeError(f'fft2 axes must be distinct, got {axes}')
    return a0, a1


def fft2(x: Tensor, s=(-1, -1), axes=(-2, -1)) -> Tensor:
    """2-D complex FFT: separable composition of the 1-D engine over both
    axes (np.fft.fft2 semantics, with each size rounded up to a power of
    two per the dsc pad/crop rule)."""
    a0, a1 = _axes2(x, axes)
    return fft(fft(x, n=s[1], axis=a1), n=s[0], axis=a0)


def ifft2(x: Tensor, s=(-1, -1), axes=(-2, -1)) -> Tensor:
    """2-D inverse complex FFT (np.fft.ifft2 semantics + pow2 rule)."""
    a0, a1 = _axes2(x, axes)
    return ifft(ifft(x, n=s[1], axis=a1), n=s[0], axis=a0)


def rfft2(x: Tensor, s=(-1, -1), axes=(-2, -1)) -> Tensor:
    """2-D real FFT: rfft over the last transform axis, complex fft over
    the other (np.fft.rfft2 semantics + pow2 rule)."""
    a0, a1 = _axes2(x, axes)
    return fft(rfft(x, n=s[1], axis=a1), n=s[0], axis=a0)


def irfft2(x: Tensor, s=(-1, -1), axes=(-2, -1)) -> Tensor:
    """2-D inverse real FFT (np.fft.irfft2 semantics + pow2 rule): inverse
    complex over the first axis, Hermitian inverse over the last."""
    a0, a1 = _axes2(x, axes)
    return irfft(ifft(x, n=s[0], axis=a0), n=s[1], axis=a1)
