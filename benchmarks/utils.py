"""Benchmark helpers.

The reference times each op per call: 2 warmups, latency = min of 5
(benchmarks/python/utils.py:11-12, perf.md:18-24). ``bench`` does the same
for a public-API call on the device, ending each timed call in
``block_until_ready`` (JAX returns before the device finishes; the
helper is chip_smoke.ready, which also waits on planar Tensors);
``bench_host`` does it for NumPy.
"""

import time

from chip_smoke import ready

WARMUP = 2
BENCH_STEPS = 5


def bench(fn) -> float:
    """Best-of-BENCH_STEPS wall time of ``fn()``, each call ending when
    its results are ready on the device."""
    for _ in range(WARMUP):
        ready(fn())
    best = float('inf')
    for _ in range(BENCH_STEPS):
        t0 = time.perf_counter()
        ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def bench_host(fn) -> float:
    """Best-of-BENCH_STEPS per-call wall time of a host (NumPy) call."""
    for _ in range(WARMUP):
        fn()
    best = float('inf')
    for _ in range(BENCH_STEPS):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best
