"""FFT compute core: Stockham autosort + Bailey four-step, pure JAX.

Rebuild of the reference FFT engine (dsc/include/dsc_fft.h,
dsc/src/dsc.cpp:1955-2340). The reference uses a recursive radix-2 DIT
split with per-row scratch copies; that shape is hostile to XLA (dynamic
recursion, strided scalar loops), so the rebuild uses:

- **Stockham autosort** (iterative, no bit-reversal, unit-stride batches)
  for base-size transforms — every stage is a dense elementwise op over the
  whole batch, which XLA fuses;
- **Bailey four-step** (n = n1*n2: column FFTs -> twiddle -> row FFTs ->
  transpose) for large transforms, the same decomposition logic the survey
  maps to blockwise/sequence-parallel processing (SURVEY §5.7).

Internally complex values travel as (re, im) float pairs, so rfft never
materializes a complex input (its input is real) and irfft never
materializes a complex output.

Inverse transforms use the conjugation identity ifft(x) = conj(fft(conj(x)))/n
— on planar data a conjugation is just negating the imaginary plane, which
XLA fuses into the neighboring ops for free.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Tuple

import jax
import jax.numpy as jnp

Planar = Tuple[jax.Array, jax.Array]


def _cmul(ar, ai, br, bi) -> Planar:
    return ar * br - ai * bi, ar * bi + ai * br


def stockham_fft_p(xr: jax.Array, xi: jax.Array, w: Planar) -> Planar:
    """Forward DFT of each row (B, n), Stockham autosort radix-2 DIF on
    planar data.

    ``w`` holds the stage twiddles w[p] = exp(-2i*pi*p/n), p < n/2; the
    stage with current length ``cur`` uses the strided subset
    w[::n//cur][:cur//2]. Output is in natural order — no bit-reversal.
    """
    wr, wi = w
    b, n = xr.shape
    if n == 1:
        return xr, xi
    cur, s = n, 1
    while cur > 1:
        m = cur // 2
        x3r = xr.reshape(b, cur, s)
        x3i = xi.reshape(b, cur, s)
        ar, ai = x3r[:, :m], x3i[:, :m]
        br_, bi_ = x3r[:, m:], x3i[:, m:]
        wpr = wr[::s][:m].reshape(1, m, 1)
        wpi = wi[::s][:m].reshape(1, m, 1)
        dr, di = ar - br_, ai - bi_
        pr, pi = _cmul(dr, di, wpr, wpi)
        xr = jnp.stack([ar + br_, pr], axis=2).reshape(b, n)
        xi = jnp.stack([ai + bi_, pi], axis=2).reshape(b, n)
        cur, s = m, s * 2
    return xr, xi


def fft_apply_p(xr: jax.Array, xi: jax.Array, spec: Tuple, tables: Any) -> Planar:
    """Forward FFT of each row (B, n) following the factorization ``spec``
    (see plan.build_spec), planar in/out."""
    kind = spec[0]
    if kind == 'base':
        return stockham_fft_p(xr, xi, tables)

    _, n1, n2, s1, s2 = spec
    (ttr, tti), t1, t2 = tables
    b = xr.shape[0]
    n = n1 * n2

    # x[j] with j = n2*j1 + j2  ->  M[j1, j2]
    mr = xr.reshape(b, n1, n2).transpose(0, 2, 1).reshape(b * n2, n1)
    mi = xi.reshape(b, n1, n2).transpose(0, 2, 1).reshape(b * n2, n1)
    # column FFTs (over j1): batch the n2 columns as rows
    ar, ai = fft_apply_p(mr, mi, s1, t1)
    ar = ar.reshape(b, n2, n1)
    ai = ai.reshape(b, n2, n1)
    # inter-stage twiddle Tt[j2, k1] = exp(-2i*pi*k1*j2/n)
    ar, ai = _cmul(ar, ai, ttr[None], tti[None])
    # row FFTs (over j2)
    br_ = ar.transpose(0, 2, 1).reshape(b * n1, n2)
    bi_ = ai.transpose(0, 2, 1).reshape(b * n1, n2)
    cr, ci = fft_apply_p(br_, bi_, s2, t2)
    # X[k1 + n1*k2] = C[k1, k2]  ->  flatten transposed
    cr = cr.reshape(b, n1, n2).transpose(0, 2, 1).reshape(b, n)
    ci = ci.reshape(b, n1, n2).transpose(0, 2, 1).reshape(b, n)
    return cr, ci


def fft_batched_p(
    xr: jax.Array, xi: jax.Array, spec: Tuple, tables: Any, inverse: bool
) -> Planar:
    """(B, n) planar -> (B, n) planar, forward or inverse (1/n scaled)."""
    n = xr.shape[-1]
    if inverse:
        yr, yi = fft_apply_p(xr, -xi, spec, tables)
        scale = _one_over(n, xr.dtype)
        return yr * scale, -yi * scale
    return fft_apply_p(xr, xi, spec, tables)


def _one_over(n, dtype):
    import numpy as np

    return np.dtype(dtype).type(1.0 / n)


def rfft_batched_p(
    x: jax.Array, spec: Tuple, tables: Any, n: int
) -> Planar:
    """(B, n) real -> (B, n/2+1) planar.

    Small n: half-size complex transform + untangling pass (reference
    dsc_real_fft, dsc_fft.h:178-238). Large n (tables without untangle
    twiddles, plan.RFFT_PACK_MAX): full-size transform of x + 0i.
    """
    w_tables, wu = tables
    b = x.shape[0]
    nh = n // 2
    if wu is None:
        yr, yi = fft_apply_p(x, jnp.zeros_like(x), spec, w_tables)
        return yr[:, : nh + 1], yi[:, : nh + 1]
    wur, wui = wu
    if nh == 0:
        return x.astype(wur.dtype), jnp.zeros_like(x, dtype=wur.dtype)
    zr = x[:, 0::2].astype(wur.dtype)
    zi = x[:, 1::2].astype(wur.dtype)
    zfr, zfi = fft_apply_p(zr, zi, spec, w_tables)
    # extend with Z[nh] = Z[0], then Zr[k] = conj(Z[nh-k])
    zer = jnp.concatenate([zfr, zfr[:, :1]], axis=1)
    zei = jnp.concatenate([zfi, zfi[:, :1]], axis=1)
    zrr = zer[:, ::-1]
    zri = -zei[:, ::-1]
    er, ei = 0.5 * (zer + zrr), 0.5 * (zei + zri)
    dr, di = zer - zrr, zei - zri
    # odd = -0.5i * wu * d
    tr, ti = _cmul(dr, di, wur[None], wui[None])
    outr = er + 0.5 * ti
    outi = ei - 0.5 * tr
    return outr, outi


def irfft_batched_p(
    xr: jax.Array, xi: jax.Array, spec: Tuple, tables: Any, n: int
) -> jax.Array:
    """(B, n/2+1) planar -> (B, n) real: full-spectrum reconstruction +
    full-size inverse (large n), or inverse untangle + half-size inverse
    (small n)."""
    w_tables, wu = tables
    b = xr.shape[0]
    nh = n // 2
    if wu is None:
        # full spectrum from the half: X[n-k] = conj(X[k])
        fr = jnp.concatenate([xr, xr[:, 1:nh][:, ::-1]], axis=1)
        fi = jnp.concatenate([xi, -xi[:, 1:nh][:, ::-1]], axis=1)
        yr, yi = fft_apply_p(fr, -fi, spec, w_tables)
        return yr * _one_over(n, yr.dtype)
    wur, wui = wu
    if nh == 0:
        return xr
    # Xr[k] = conj(X[nh-k]), k = 0..nh
    xrr = xr[:, ::-1]
    xri = -xi[:, ::-1]
    fr_, fi_ = xr[:, :nh], xi[:, :nh]
    err, eri = 0.5 * (fr_ + xrr[:, :nh]), 0.5 * (fi_ + xri[:, :nh])
    dr, di = fr_ - xrr[:, :nh], fi_ - xri[:, :nh]
    # odd = 0.5i * conj(wu) * d
    tr, ti = _cmul(dr, di, wur[None, :nh], -wui[None, :nh])
    zr = err - 0.5 * ti
    zi = eri + 0.5 * tr
    # half-size inverse
    yr, yi = fft_apply_p(zr, -zi, spec, w_tables)
    scale = _one_over(nh, yr.dtype)
    yr, yi = yr * scale, -yi * scale
    out = jnp.stack([yr, yi], axis=-1).reshape(b, n)
    return out


# ---------------------------------------------------------------------------
# complex-typed wrappers (used by the parallel/sharded paths and models)
# ---------------------------------------------------------------------------


def fft_apply(x: jax.Array, spec: Tuple, tables: Any) -> jax.Array:
    yr, yi = fft_apply_p(jnp.real(x), jnp.imag(x), spec, tables)
    return jax.lax.complex(yr, yi)


def fft_batched(x: jax.Array, spec: Tuple, tables: Any, inverse: bool) -> jax.Array:
    yr, yi = fft_batched_p(jnp.real(x), jnp.imag(x), spec, tables, inverse)
    return jax.lax.complex(yr, yi)


def rfft_batched(x: jax.Array, spec: Tuple, tables: Any, n: int) -> jax.Array:
    yr, yi = rfft_batched_p(x, spec, tables, n)
    return jax.lax.complex(yr, yi)


def irfft_batched(x: jax.Array, spec: Tuple, tables: Any, n: int) -> jax.Array:
    return irfft_batched_p(jnp.real(x), jnp.imag(x), spec, tables, n)


# ---------------------------------------------------------------------------
# N-D entry points: pad/crop + axis handling, fully jitted
# ---------------------------------------------------------------------------


def _pad_crop(x: jax.Array, target: int) -> jax.Array:
    """Crop or zero-pad the last axis to ``target`` (reference pad/crop to
    pow2, dsc.cpp:2019-2032)."""
    cur = x.shape[-1]
    if cur == target:
        return x
    if cur > target:
        return x[..., :target]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, target - cur)]
    return jnp.pad(x, pad)


@partial(jax.jit, static_argnames=('spec', 'n', 'axis', 'inverse', 'cdtype'))
def fft_nd(x, tables, spec, n, axis, inverse, cdtype):
    # the input cast happens inside jit, where it fuses into the transform
    x = x.astype(cdtype)
    x = _pad_crop(jnp.moveaxis(x, axis, -1), n)
    lead = x.shape[:-1]
    xb = x.reshape(-1, n)
    yr, yi = fft_batched_p(jnp.real(xb), jnp.imag(xb), spec, tables, inverse)
    y = jax.lax.complex(yr, yi).reshape(*lead, n)
    return jnp.moveaxis(y, -1, axis)


@partial(jax.jit, static_argnames=('spec', 'n', 'axis'))
def rfft_nd(x, tables, spec, n, axis):
    x = _pad_crop(jnp.moveaxis(x, axis, -1), n)
    lead = x.shape[:-1]
    xb = x.reshape(-1, n)
    yr, yi = rfft_batched_p(xb, spec, tables, n)
    y = jax.lax.complex(yr, yi).reshape(*lead, n // 2 + 1)
    return jnp.moveaxis(y, -1, axis)


@partial(jax.jit, static_argnames=('spec', 'n', 'axis', 'cdtype'))
def irfft_nd(x, tables, spec, n, axis, cdtype):
    x = x.astype(cdtype)
    x = _pad_crop(jnp.moveaxis(x, axis, -1), n // 2 + 1)
    lead = x.shape[:-1]
    xb = x.reshape(-1, n // 2 + 1)
    y = irfft_batched_p(jnp.real(xb), jnp.imag(xb), spec, tables, n)
    y = y.reshape(*lead, n)
    return jnp.moveaxis(y, -1, axis)
