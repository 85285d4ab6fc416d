"""Context + memory management for dsc_tpu.

Rebuild of the reference context (dsc/src/dsc.cpp:140-322,
python/dsc/context.py).

The reference pre-allocates a main pool (general-purpose allocator) and a
scratch pool (linear arena) so steady-state execution performs zero host
allocations. Here XLA/PJRT already pre-allocates the device arena and manages
op temporaries, so the *observable* contract is what we keep:

- ``init(main_mem, scratch_mem)``  — sets the capacity cap; double-init raises
  (reference context.py:29-34)
- auto-init with 10% of available memory + a warning if the user never calls
  ``init`` (reference context.py:13-26)
- ``used_mem`` / ``print_mem_usage`` — live byte accounting of every tensor
  buffer (reference dsc.cpp:310-322)
- allocation beyond the cap fails fast (reference dsc_allocator.cpp:112-114)
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Optional

import jax

# f64/c64 are first-class dtypes in the reference test matrix
# (test_ops.py:42); JAX needs x64 enabled before any array is created.
jax.config.update('jax_enable_x64', True)

# Persistent compilation cache. JAX_COMPILATION_CACHE_DIR, when set, is
# JAX's own setting and the only directory used; otherwise the cache lives
# at the fixed <repo>/.jax_cache, so a later process finds what an earlier
# one compiled (the path is part of the cache key: a moving directory never
# hits). An embedding application's own cache configuration wins: if
# jax_compilation_cache_dir is already set, we leave it alone.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), '.jax_cache')


def compile_cache_dir(environ, platforms: str) -> Optional[str]:
    """Directory to point JAX's compile cache at, or None to set nothing.

    CPU runs must NOT touch the persistent cache: XLA:CPU entries are AOT
    executables specialized to the compiling host's CPU features, and
    loading one on a host with different features SIGILLs/segfaults
    (observed: a full-suite crash in backend_compile_and_load after
    cpu_aot_loader feature-mismatch errors). CPU-forced flows set
    jax_platforms (config API or JAX_PLATFORMS env) before importing
    dsc_tpu, so gate on it here — on the FIRST (preferred) platform only,
    since a list such as 'cuda,cpu' names cpu as a mere fallback."""
    if environ.get('JAX_COMPILATION_CACHE_DIR'):
        return None
    if platforms.split(',')[0].strip() == 'cpu':
        return None
    return REPO_CACHE_DIR


_cache_dir = compile_cache_dir(os.environ, jax.config.jax_platforms or '')
if _cache_dir is not None and not jax.config.jax_compilation_cache_dir:
    jax.config.update('jax_compilation_cache_dir', _cache_dir)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)


class DscContext:
    def __init__(self, main_mem: int, scratch_mem: int):
        self.main_mem = int(main_mem)
        # Scratch exists only for API parity: op temporaries are XLA-managed
        # (the reference's linear arena, dsc_allocator.cpp:223-304,
        # has no observable Python-facing behavior beyond existing).
        self.scratch_mem = int(scratch_mem)
        self._used = 0
        self._lock = threading.Lock()
        self._n_buffers = 0
        # PRNG state for randn: proper JAX keys, deliberately NOT copying the
        # reference bug where randn returns identical values every call
        # (dsc.cpp:501-513; SURVEY Appendix B).
        seed = int(os.environ.get('DSC_SEED', '0'))
        self._key = jax.random.PRNGKey(seed)

    # -- memory accounting ------------------------------------------------

    def alloc(self, nbytes: int) -> None:
        with self._lock:
            if self._used + nbytes > self.main_mem:
                raise MemoryError(
                    f'error allocating {nbytes} bytes: '
                    f'{self._used}/{self.main_mem} bytes already in use '
                    f'(grow the pool via dsc.init)'
                )
            self._used += nbytes
            self._n_buffers += 1

    def free(self, nbytes: int) -> None:
        with self._lock:
            self._used -= nbytes
            self._n_buffers -= 1

    @property
    def used_mem(self) -> int:
        return self._used

    # -- PRNG --------------------------------------------------------------

    def next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def manual_seed(self, seed: int) -> None:
        self._key = jax.random.PRNGKey(seed)


_ctx: Optional[DscContext] = None
_ctx_lock = threading.Lock()


def _default_mem() -> int:
    """10% of device memory, mirroring the reference's 10% of
    system RAM fallback (context.py:13-26)."""
    try:
        dev = jax.devices()[0]
        stats = dev.memory_stats()
        if stats and 'bytes_limit' in stats:
            return int(stats['bytes_limit'] * 0.1)
    except Exception:
        pass
    try:
        import psutil

        return int(psutil.virtual_memory().total * 0.1)
    except Exception:
        return 4 * 2**30


def _get_ctx() -> DscContext:
    global _ctx
    if _ctx is None:
        with _ctx_lock:
            if _ctx is None:
                mem = _default_mem()
                print(
                    f'dsc_tpu: init() was not called, defaulting to {mem} bytes '
                    f'for both the main and the scratch pool'
                )
                _ctx = DscContext(mem, mem)
    return _ctx


def init(main_mem: int, scratch_mem: int = 0) -> None:
    """Initialize the dsc context with a main pool cap of ``main_mem`` bytes.

    Mirrors dsc.init (reference context.py:29-34): raises on double-init.
    ``scratch_mem`` is accepted for API parity; op temporaries live in
    XLA-managed device memory.
    """
    global _ctx
    with _ctx_lock:
        if _ctx is not None:
            raise RuntimeError('dsc is already initialized')
        _ctx = DscContext(main_mem, scratch_mem if scratch_mem else main_mem)


def clear() -> None:
    """Reset caches (FFT plans, jitted closures stay valid).

    The reference dsc.clear() resets the whole main buffer
    (dsc.cpp:287-291); with live-object accounting this maps to clearing
    the plan cache and letting GC reap dead buffers.
    """
    import gc

    from .fourier import plan as _plan

    _plan.clear_plans()
    gc.collect()


def shutdown() -> None:
    """Tear down the context entirely (reference dsc_ctx_free)."""
    global _ctx
    with _ctx_lock:
        _ctx = None


def used_mem() -> int:
    return _get_ctx().used_mem


def print_mem_usage() -> None:
    ctx = _get_ctx()
    print(
        f'dsc_tpu: using {ctx.used_mem}/{ctx.main_mem} bytes '
        f'({100.0 * ctx.used_mem / max(ctx.main_mem, 1):.1f}%) '
        f'across {ctx._n_buffers} buffers'
    )


def manual_seed(seed: int) -> None:
    _get_ctx().manual_seed(seed)


def default_device():
    return jax.devices()[0]

