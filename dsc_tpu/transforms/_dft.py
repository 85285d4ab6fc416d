"""Exact-length batched DFT on planar planes — the engine under
``dsc_tpu.transforms`` (the scipy.fft-parity tier).

The dsc FFT family keeps the reference identity "sizes round up to the
next power of two" (reference dsc.cpp:2023-2028). This tier instead
evaluates the length-n DFT *exactly* for any n: powers of two ride the
planar FFT engine directly (fourier/core.py — Stockham, four-step),
every other length rides Bluestein's identity
nk = (n^2 + k^2 - (k-n)^2)/2 as one circular convolution at the next
power of two >= 2n-1.

Plans (chirp tables + the pow2 engine plan underneath) are cached in a
bounded LRU mirroring the reference plan cache discipline
(dsc.cpp:182-267): tables are device arrays passed to jitted programs as
*arguments*, never closed over, so eviction cannot invalidate compiled
code. Chirp phases use EXACT integer reduction ``k^2 mod 2n`` before the
float multiply (models/czt.py precision rule — float theta*k^2 loses the
angle past k ~ 1e6); the chirp-kernel spectrum is computed host-side in
f64 (np.fft) at plan time, like every design-time table in this tier.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fourier import core as fft_core
from ..fourier import plan as fft_plan

_lock = threading.Lock()
_plans: 'OrderedDict[Tuple, Tuple[Tuple, Any]]' = OrderedDict()


def _cache_get(key: Tuple):
    with _lock:
        if key in _plans:
            _plans.move_to_end(key)
            return _plans[key]
    return None


def _cache_put(key: Tuple, value) -> None:
    with _lock:
        _plans[key] = value
        while len(_plans) > fft_plan.MAX_FFT_PLANS:
            _plans.popitem(last=False)


def _unit_chirp(num: np.ndarray, denom: int, sign: float) -> np.ndarray:
    """exp(sign * 1j * pi * num / denom), integer quadratic ``num``
    reduced mod 2*denom BEFORE the float multiply (exact at any index)."""
    red = np.mod(num, 2 * denom).astype(np.float64)
    return np.exp(sign * 1j * np.pi * red / denom)


def _planes(table: np.ndarray) -> Tuple[jax.Array, jax.Array]:
    return (jnp.asarray(table.real.astype(np.float32)),
            jnp.asarray(table.imag.astype(np.float32)))


def dft_plan(n: int) -> Tuple[Tuple, Any]:
    """(static, tables) for an exact length-n c2c DFT of (B, n) rows.

    ``static`` is hashable (goes into jit static args); ``tables`` is a
    pytree of device arrays (passed as traced arguments)."""
    if n < 1:
        raise RuntimeError(f'transforms: n ({n}) must be >= 1')
    key = ('c2c', n)
    hit = _cache_get(key)
    if hit is not None:
        return hit
    if n & (n - 1) == 0:
        spec, tables = fft_plan.get_plan(n, 'complex', np.complex64)
        entry = (('pow2', n, spec), (tables,))
    else:
        m = fft_plan.next_pow2(2 * n - 1)
        spec, tables = fft_plan.get_plan(m, 'complex', np.complex64)
        k = np.arange(n, dtype=np.int64)
        pre = _unit_chirp(k * k, n, -1.0)  # w^(k^2/2), w = exp(-2j*pi/n)
        kc = np.arange(-(n - 1), n, dtype=np.int64)  # conv kernel support
        v = np.zeros(m, dtype=np.complex128)
        v[: 2 * n - 1] = _unit_chirp(kc * kc, n, +1.0)
        vspec = np.fft.fft(v)  # host f64 design math
        entry = (
            ('blue', n, m, spec),
            (tables, *_planes(pre), *_planes(vspec)),
        )
    _cache_put(key, entry)
    return entry


def rdft_plan(n: int) -> Tuple[Tuple, Any]:
    """Plan for an exact length-n r2c transform: pow2 n uses the engine's
    real plan (half-size packing, fourier/plan.py); other n
    shares the Bluestein c2c plan and slices the half spectrum."""
    if n < 1:
        raise RuntimeError(f'transforms: n ({n}) must be >= 1')
    if n & (n - 1) == 0:
        key = ('r2c', n)
        hit = _cache_get(key)
        if hit is not None:
            return hit
        spec, tables = fft_plan.get_plan(n, 'real', np.complex64)
        entry = (('pow2r', n, spec), (tables,))
        _cache_put(key, entry)
        return entry
    return dft_plan(n)


def dft_rows(xr: jax.Array, xi: Optional[jax.Array], tabs: Any,
             static: Tuple, inverse: bool) -> Tuple[jax.Array, jax.Array]:
    """(B, n) planar -> (B, n) planar exact DFT (trace-time building
    block; callers jit). ``xi=None`` means a zero imaginary plane.
    Inverse applies the backward 1/n scale."""
    kind = static[0]
    if kind == 'pow2':
        _, n, spec = static
        (tables,) = tabs
        if xi is None:
            xi = jnp.zeros_like(xr)
        return fft_core.fft_batched_p(xr, xi, spec, tables, inverse)
    _, n, m, spec = static
    tables, pr, pi, vr, vi = tabs
    if xi is not None and inverse:
        xi = -xi
    # chirp pre-multiply
    if xi is None:
        ur, ui = xr * pr, xr * pi
    else:
        ur, ui = xr * pr - xi * pi, xr * pi + xi * pr
    pad = ((0, 0), (0, m - n))
    ur, ui = jnp.pad(ur, pad), jnp.pad(ui, pad)
    fr, fi = fft_core.fft_batched_p(ur, ui, spec, tables, False)
    gr, gi = fr * vr - fi * vi, fr * vi + fi * vr
    cr, ci = fft_core.fft_batched_p(gr, gi, spec, tables, True)
    cr = cr[:, n - 1: 2 * n - 1]
    ci = ci[:, n - 1: 2 * n - 1]
    yr = cr * pr - ci * pi
    yi = cr * pi + ci * pr
    if inverse:
        s = np.float32(1.0 / n)
        return yr * s, -yi * s
    return yr, yi


def rdft_rows(x: jax.Array, tabs: Any, static: Tuple
              ) -> Tuple[jax.Array, jax.Array]:
    """(B, n) real -> (B, n//2+1) planar exact half spectrum."""
    if static[0] == 'pow2r':
        _, n, spec = static
        (tables,) = tabs
        return fft_core.rfft_batched_p(x, spec, tables, n)
    n = static[1]
    yr, yi = dft_rows(x, None, tabs, static, inverse=False)
    return yr[:, : n // 2 + 1], yi[:, : n // 2 + 1]


def irdft_rows(xr: jax.Array, xi: jax.Array, tabs: Any, static: Tuple
               ) -> jax.Array:
    """(B, n//2+1) planar half spectrum -> (B, n) real (backward 1/n),
    treating the input as the lower half of a Hermitian spectrum (the
    c2r convention: only the real part of the DC/Nyquist bins and the
    given interior bins contribute)."""
    if static[0] == 'pow2r':
        _, n, spec = static
        (tables,) = tabs
        return fft_core.irfft_batched_p(xr, xi, spec, tables, n)
    n = static[1]
    # assemble the full Hermitian spectrum: bins 1..ceil(n/2)-1 mirror
    # conjugated into the upper half; Re(ifft(full)) is then exactly the
    # c2r transform for ANY input (unpaired imaginary parts cancel out
    # of the real plane)
    mr = xr[:, 1: (n + 1) // 2][:, ::-1]
    mi = -xi[:, 1: (n + 1) // 2][:, ::-1]
    fr = jnp.concatenate([xr, mr], axis=1)
    fi = jnp.concatenate([xi, mi], axis=1)
    yr, _ = dft_rows(fr, fi, tabs, static, inverse=True)
    return yr
