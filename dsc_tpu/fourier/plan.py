"""FFT plan cache for dsc_tpu.

Rebuild of the reference plan cache (dsc/src/dsc.cpp:182-267,
dsc/include/dsc_fft.h:33-55).

A "plan" holds precomputed twiddle tables as device arrays plus a static
recursion *spec* describing how the transform is factorized. Twiddles are
computed host-side in float64 and downcast to the working precision —
mirroring dsc_init_plan's real-typed twiddle tables and keeping 2^24-point
f32 transforms within 1e-4 of NumPy.

The cache is bounded (DSC_MAX_FFT_PLANS, default 16 like the reference) with
LRU eviction (the reference uses a pseudo-LRU last_used counter,
dsc.cpp:198-247). Plans are always passed to jitted functions as *arguments*,
never closed over, so evicting a plan cannot invalidate compiled code.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_FFT_PLANS = int(os.environ.get('DSC_MAX_FFT_PLANS', '16'))

# Largest transform handled by a single base-case Stockham pass; above
# this the four-step factorization splits the work (SURVEY §5.7: the
# blockwise decomposition of large transforms).
BASE_MAX = 4096

# Largest real transform using the half-size even/odd packing; above this
# the full-size complex engine wins (see get_plan).
RFFT_PACK_MAX = 2**16

_plans: 'OrderedDict[Tuple, Any]' = OrderedDict()
_lock = threading.Lock()


def clear_plans() -> None:
    with _lock:
        _plans.clear()


def num_plans() -> int:
    return len(_plans)


def next_pow2(n: int) -> int:
    """dsc_pow2_n equivalent (reference dsc.h:122-132): next power of two
    >= n."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def build_spec(n: int) -> Tuple:
    """Static factorization spec for an n-point transform (n = power of 2).

    ('base', n)                      — single-pass Stockham FFT
    ('split', n1, n2, spec1, spec2)  — Bailey four-step, n = n1*n2
    """
    if n <= BASE_MAX:
        return ('base', n)
    # balanced factors, each as close to sqrt(n) as possible while fitting
    # the base kernel — e.g. 2^24 -> 4096 x 4096 (one level), not
    # 2048 x 8192 (which would force a nested split)
    n1 = min(1 << (n.bit_length() // 2), BASE_MAX)
    n2 = n // n1
    return ('split', n1, n2, build_spec(n1), build_spec(n2))


def _planar(table: np.ndarray, cdtype) -> Tuple:
    """Complex table -> planar (re, im) device pair, the form the planar
    engine (core.py) consumes."""
    fdtype = np.float32 if np.dtype(cdtype) == np.complex64 else np.float64
    return (
        jnp.asarray(np.ascontiguousarray(table.real).astype(fdtype)),
        jnp.asarray(np.ascontiguousarray(table.imag).astype(fdtype)),
    )


def _w_table(n: int) -> np.ndarray:
    """Stockham stage twiddles: w[p] = exp(-2*pi*i*p/n), p < n/2, computed in
    f64 (dsc_init_plan parity, dsc_fft.h:33-55)."""
    p = np.arange(max(n // 2, 1), dtype=np.float64)
    return np.exp(-2j * np.pi * p / n)


def _split_twiddle(n1: int, n2: int) -> np.ndarray:
    """Four-step inter-stage twiddle, stored transposed and ready to apply to
    the column-FFT output laid out (n2, k1): Tt[n2, k1] = exp(-2i*pi*k1*n2/n)."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    return np.exp(-2j * np.pi * np.outer(j2, k1) / n)


def _build_tables(spec: Tuple, cdtype) -> Any:
    kind = spec[0]
    if kind == 'base':
        return _planar(_w_table(spec[1]), cdtype)
    _, n1, n2, s1, s2 = spec
    return (
        _planar(_split_twiddle(n1, n2), cdtype),
        _build_tables(s1, cdtype),
        _build_tables(s2, cdtype),
    )


def _rfft_untangle(n: int) -> np.ndarray:
    """Real-FFT untangling twiddles: exp(-2i*pi*k/n), k = 0..n/2 (the
    reference RFFT plan's extra twiddle set, dsc_fft.h:178-238)."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    return np.exp(-2j * np.pi * k / n)


def get_plan(n: int, fft_type: str, cdtype) -> Tuple[Tuple, Any]:
    """Probe-or-build a plan for an n-point transform (n = power of 2).

    fft_type: 'complex' or 'real' (reference dsc_fft_type).
    Returns (spec, tables) where tables is a pytree of device arrays.
    """
    cdtype = np.dtype(cdtype)
    key = (n, fft_type, cdtype.str)
    with _lock:
        if key in _plans:
            _plans.move_to_end(key)
            return _plans[key]

    # A plan may be built mid-trace (the first FFT inside a dsc.compile
    # region, fuse.py); without this the jnp.asarray constants would be
    # DynamicJaxprTracers and caching them would leak the trace
    # (UnexpectedTracerError on the next lookup). Tables must be concrete
    # device arrays no matter who triggers the build.
    with jax.ensure_compile_time_eval():
        spec, tables = _build_plan(n, fft_type, cdtype)

    with _lock:
        _plans[key] = (spec, tables)
        while len(_plans) > MAX_FFT_PLANS:
            _plans.popitem(last=False)
    return spec, tables


def _build_plan(n: int, fft_type: str, cdtype) -> Tuple[Tuple, Any]:
    if fft_type == 'real':
        if n > RFFT_PACK_MAX:
            # Large real transforms run through the full-size complex
            # engine instead of the half-size even/odd packing.
            spec = build_spec(n)
            tables = (_build_tables(spec, cdtype), None)
        else:
            nh = n // 2 if n > 1 else 1
            spec = build_spec(nh)
            tables = (
                _build_tables(spec, cdtype),
                _planar(_rfft_untangle(n), cdtype),
            )
    else:
        spec = build_spec(n)
        tables = _build_tables(spec, cdtype)
    return spec, tables
