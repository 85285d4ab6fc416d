"""Sharded FFTs over a device mesh.

Two parallelism strategies (SURVEY §2.4 obligations):

1. **Batch sharding (DP)** — ``sharded_batched_fft``: each device
   transforms its shard of the batch independently; zero communication.

2. **Transform sharding (TP/SP analog)** — ``distributed_fft``: one FFT of
   n = n1*n2 points factorized Bailey-style across devices. Column FFTs
   run locally on n2-sharded data, the inter-stage twiddle is sharded with
   the data, and the four-step "transpose" becomes a single
   ``jax.lax.all_to_all``, which XLA hands to the device interconnect
   (NCCL over NVLink on GPUs). This is the decomposition the single-device
   engine uses for large transforms (SURVEY §5.7), lifted one level.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..fourier import core as fft_core
from ..fourier import plan as fft_plan


def shard_batch(x: jax.Array, mesh: Mesh, axis: str = 'data') -> jax.Array:
    """Place a (batch, ...) array with the batch dim sharded over ``axis``."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def sharded_batched_fft(
    x: jax.Array, mesh: Mesh, inverse: bool = False, axis: str = 'data'
) -> jax.Array:
    """Batched FFT with the batch dimension sharded over the mesh (DP).
    x: (b, n) complex, b divisible by mesh axis size."""
    n = x.shape[-1]
    spec, tables = fft_plan.get_plan(n, 'complex', x.dtype)
    sharding = NamedSharding(mesh, P(axis, None))

    @partial(jax.jit, static_argnames=('fspec', 'inv'), out_shardings=sharding)
    def run(xx, tt, fspec, inv):
        xx = jax.lax.with_sharding_constraint(xx, sharding)
        return fft_core.fft_batched(xx, fspec, tt, inv)

    return run(x, tables, fspec=spec, inv=inverse)


def _choose_split(n: int, d: int) -> Tuple[int, int]:
    """n = n1 * n2 with both divisible by the mesh size d."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n1 % d or n2 % d:
        raise RuntimeError(
            f'distributed fft needs n1 ({n1}) and n2 ({n2}) divisible by '
            f'the mesh axis size ({d})'
        )
    return n1, n2


def _twiddle_planes(n1: int, n2: int, fdt):
    """Four-step inter-stage twiddle Tt[j2, k1] = exp(-2i*pi*k1*j2/n) as
    (re, im) planes computed in host f64; sharded over j2 like the data."""
    j2 = np.arange(n2, dtype=np.float64)
    k1 = np.arange(n1, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(j2, k1) / (n1 * n2)
    return (jnp.asarray(np.cos(ang).astype(fdt)),
            jnp.asarray(np.sin(ang).astype(fdt)))


def _fft_rows_fn(mesh: Mesh, axis: str, n: int, dtype):
    """(fwd, tables): fwd(x, tables) is the traceable forward FFT of (b, n)
    complex rows in natural order, with the transform factorized over the
    mesh axis: local column FFTs -> sharded twiddle -> all_to_all -> local
    row FFTs. Each device runs the plain single-device engine
    (fourier/core.py) on its block. The tables are device arrays passed as
    arguments, never baked into the program."""
    d = mesh.shape[axis]
    n1, n2 = _choose_split(n, d)
    spec1, tables1 = fft_plan.get_plan(n1, 'complex', dtype)
    spec2, tables2 = fft_plan.get_plan(n2, 'complex', dtype)
    fdt = np.float32 if np.dtype(dtype) == np.complex64 else np.float64
    ttr, tti = _twiddle_planes(n1, n2, fdt)

    def local(xb, ttr_l, tti_l, t1, t2):
        # xb: (b, n1, n2/d) — this device's j2 columns
        bb, _, n2d = xb.shape
        # column FFTs over j1 (fully local)
        a = xb.transpose(0, 2, 1).reshape(bb * n2d, n1)
        a = fft_core.fft_batched(a, spec1, t1, False).reshape(bb, n2d, n1)
        # sharded twiddle: rows j2_local of Tt
        a = a * jax.lax.complex(ttr_l, tti_l)[None]
        # the four-step transpose: one all-to-all across the devices
        # (b, n2/d, n1) -> (b, n2, n1/d)
        a = jax.lax.all_to_all(a, axis, split_axis=2, concat_axis=1, tiled=True)
        # row FFTs over j2 (fully local for our k1 shard)
        n1d = a.shape[2]
        c = a.transpose(0, 2, 1).reshape(bb * n1d, n2)
        c = fft_core.fft_batched(c, spec2, t2, False).reshape(bb, n1d, n2)
        return c  # C[b, k1_local, k2]

    mapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, None, axis), P(axis, None), P(axis, None), P(), P()),
        out_specs=P(None, axis, None),
        check_vma=False,
    )

    def fwd(x, tables):
        b = x.shape[0]
        c = mapped(x.reshape(b, n1, n2), *tables)  # sharded over k1
        return c.transpose(0, 2, 1).reshape(b, n)  # X[k1 + n1*k2] = C[k1,k2]

    return fwd, (ttr, tti, tables1, tables2)


@lru_cache(maxsize=32)
def _dist_program(kind: str, mesh: Mesh, axis: str, n: int, dtype):
    """(jitted program, its device-array arguments) of one distributed
    transform. Cached per (kind, mesh, axis, n, dtype), so repeat calls
    neither rebuild the tables nor retrace, and no table is baked into the
    program as a constant. ``n`` is the complex four-step size (half the
    real length for 'rfft'/'irfft')."""
    fwd, tables = _fft_rows_fn(mesh, axis, n, dtype)
    if kind in ('fft', 'ifft'):
        @partial(jax.jit, out_shardings=NamedSharding(mesh, P(None, axis)))
        def run(x, tables):
            if kind == 'ifft':
                return jnp.conj(fwd(jnp.conj(x), tables)) * (1.0 / n)
            return fwd(x, tables)

        return run, tables

    h = n
    fdt = np.float32 if np.dtype(dtype) == np.complex64 else np.float64
    phasors = _half_phasors(2 * h, fdt)
    if kind == 'rfft':
        @jax.jit
        def run(xr, args):
            tables, (wr, wi) = args
            z2 = xr.reshape(h, 2)  # even/odd pack: z = x[2t] + i x[2t+1]
            zf = fwd(jax.lax.complex(z2[:, 0], z2[:, 1])[None], tables)[0]
            zfr = jnp.concatenate([jnp.real(zf), jnp.real(zf)[:1]])
            zfi = jnp.concatenate([jnp.imag(zf), jnp.imag(zf)[:1]])
            mr, mi = zfr[::-1], zfi[::-1]  # Z[(h-k) mod h]
            er, ei = 0.5 * (zfr + mr), 0.5 * (zfi - mi)
            outr, outi = 0.5 * (zfi + mi), -0.5 * (zfr - mr)  # O=-i(Z-Z~*)/2
            return jax.lax.complex(er + wr * outr - wi * outi,
                                   ei + wr * outi + wi * outr)

        return run, (tables, phasors)

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P(axis)))
    def run(xc, args):
        tables, (wr, wi) = args
        xr_, xi_ = jnp.real(xc), jnp.imag(xc)
        mr, mi = xr_[::-1], xi_[::-1]  # X[h-k]
        er, ei = 0.5 * (xr_ + mr), 0.5 * (xi_ - mi)
        dr, di = 0.5 * (xr_ - mr), 0.5 * (xi_ + mi)
        # O = conj(w) * D; Z = E + i O, k = 0..h-1
        outr = wr * dr + wi * di
        outi = wr * di - wi * dr
        z = jax.lax.complex((er - outi)[:h], (ei + outr)[:h])
        # z = IFFT_h(Z) = conj(FFT_h(conj(Z))) / h
        y = fwd(jnp.conj(z)[None], tables)[0] * (1.0 / h)
        # x[2t] = Re z[t], x[2t+1] = Im z[t]
        return jnp.stack([jnp.real(y), -jnp.imag(y)], axis=-1).reshape(2 * h)

    return run, (tables, phasors)


def distributed_fft(
    x: jax.Array, mesh: Mesh, axis: str = 'model', inverse: bool = False
) -> jax.Array:
    """FFT of each row of x (b, n), with the *transform* factorized over the
    mesh axis (see _fft_rows_fn). Returns (b, n) in natural order, sharded
    over the mesh axis along n.
    """
    _, n = x.shape
    run, tables = _dist_program('ifft' if inverse else 'fft', mesh, axis, n,
                                np.dtype(x.dtype))
    return run(x, tables)


def distributed_fft_stream(
    x: jax.Array, mesh: Mesh, axis: str = 'model', inverse: bool = False
) -> jax.Array:
    """ONE large FFT of a single (n,) complex vector with the four-step
    sharded over the mesh: each device transforms its column block, the
    four-step transpose is ONE ``all_to_all``, and each device transforms
    its k1 shard (the single-vector form of distributed_fft). n = n1*n2 a
    power of two with both factors divisible by the mesh axis size.
    Returns (n,) in natural order, sharded over the mesh axis."""
    n = x.shape[-1]
    if x.ndim != 1:
        raise RuntimeError(
            f'distributed_fft_stream expects a single (n,) vector, got '
            f'{x.ndim}-D (batch rows shard with sharded_batched_fft)'
        )
    return distributed_fft(x.reshape(1, n), mesh, axis, inverse).reshape(n)


def _half_phasors(n: int, fdt):
    """Untangle phasors w_k = exp(-2i*pi*k/n), k = 0..n/2, as planes
    computed in host f64 (the plan tables' twiddle discipline)."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    ang = -2.0 * np.pi * k / n
    return (jnp.asarray(np.cos(ang).astype(fdt)),
            jnp.asarray(np.sin(ang).astype(fdt)))


def _dist_rfft_half(n: int, who: str) -> int:
    if n % 2:
        raise RuntimeError(f'{who}: n must be even, got {n}')
    return n // 2


def distributed_rfft_stream(
    x: jax.Array, mesh: Mesh, axis: str = 'model'
) -> jax.Array:
    """ONE large REAL FFT sharded over the mesh: the classic half-size
    packing (z[t] = x[2t] + i*x[2t+1], reference dsc_fft.h:178-238) on
    top of the sharded four-step of distributed_fft at n/2, then the
    Hermitian untangle ``X[k] = E[k] + w_k O[k]`` under jit on the sharded
    spectrum (XLA lays its mirror reversal down as collectives).

    x: (n,) real, n/2 = n1*n2 with both factors divisible by the mesh
    axis size. Returns the (n/2+1,) complex half spectrum.
    """
    n = x.shape[-1]
    if x.ndim != 1:
        raise RuntimeError(
            f'distributed_rfft_stream expects a single (n,) vector, got '
            f'{x.ndim}-D (batch rows shard with sharded_batched_rfft)'
        )
    h = _dist_rfft_half(n, 'distributed_rfft_stream')
    cdt = np.complex64 if x.dtype == jnp.float32 else np.complex128
    run, tables = _dist_program('rfft', mesh, axis, h, np.dtype(cdt))
    return run(x, tables)


def distributed_irfft_stream(
    x: jax.Array, mesh: Mesh, axis: str = 'model'
) -> jax.Array:
    """Inverse of distributed_rfft_stream: (n/2+1,) complex Hermitian
    half spectrum -> (n,) real, via the entangle
    ``Z[k] = E[k] + i conj(w_k) D[k]`` (D = (X[k] - conj(X[h-k]))/2)
    followed by the sharded inverse four-step at n/2 and the even/odd
    re-interleave. The result is sharded over the mesh axis."""
    nh = x.shape[-1]
    if x.ndim != 1:
        raise RuntimeError(
            f'distributed_irfft_stream expects a single (n/2+1,) '
            f'vector, got {x.ndim}-D'
        )
    h = _dist_rfft_half(2 * (nh - 1), 'distributed_irfft_stream')
    run, tables = _dist_program('irfft', mesh, axis, h, np.dtype(x.dtype))
    return run(x, tables)


def sharded_batched_rfft(
    x: jax.Array, mesh: Mesh, axis: str = 'data'
) -> jax.Array:
    """Batch-sharded REAL FFT: rows of x (b, n) f32 are transformed
    independently, one shard of rows per device, each device running the
    single-device rfft engine on its local rows via shard_map. Returns
    (b, n/2+1) complex64."""
    b, n = x.shape
    spec, tables = fft_plan.get_plan(n, 'real', np.complex64)

    def local(xb, tt):
        return fft_core.rfft_batched(xb, spec, tt, n)

    mapped = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P()),
        out_specs=P(axis, None),
        check_vma=False,
    )
    return jax.jit(mapped)(x, tables)
