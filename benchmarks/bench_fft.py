"""FFT benchmark vs NumPy (reference benchmarks/python/bench_fft.py:
forward only, GFLOPS via 5*N*log2(N) for fft and 2.5*N*log2(N) for rfft;
sweep extended to 2^24 per BASELINE config 3, with a batched suite and
>16-plan cache stress). Emits benchmarks/results_fft.json."""

import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # repo root
import dsc_tpu as dsc
from dsc_tpu.fourier import plan as fft_plan
from utils import bench, bench_host

RESULTS = []


def _out_path():
    return os.path.join(os.path.dirname(__file__), 'results_fft.json')


def _dump():
    """Merge-write results after every section so a timed-out run still
    leaves its finished measurements on disk."""
    merged = RESULTS
    if os.path.exists(_out_path()):
        with open(_out_path()) as f:
            old = json.load(f)
        keys = {(r.get('bench'), r.get('log2n'), r.get('batch'))
                for r in RESULTS}
        merged = [r for r in old if (r.get('bench'), r.get('log2n'),
                                     r.get('batch')) not in keys] + RESULTS
    with open(_out_path(), 'w') as f:
        json.dump(merged, f, indent=1)


def main():
    dsc.init(int(8 * 2**30))
    part = os.environ.get('DSC_BENCH_PART', 'all')

    print('== 1-D fft/rfft forward, f32/c32 (public API) ==')
    print(f'{"N":>9} {"dsc fft":>12} {"np fft":>12} {"dsc GF/s":>9} '
          f'{"np GF/s":>9} {"rfft GF/s":>10}')
    # 2^25 and 2^26 included: a size cliff shows as a 2^25/2^26 time out
    # of proportion to the 2^24 time
    for e in ((*range(8, 25, 2), 25, 26) if part in ('all', '1d') else ()):
        n = 2**e
        flops_c = 5 * n * e
        flops_r = 2.5 * n * e

        xc = (np.random.randn(n) + 1j * np.random.randn(n)).astype(np.complex64)
        xr = np.random.randn(n).astype(np.float32)
        xcd = dsc.from_numpy(xc)
        xrd = dsc.from_numpy(xr)

        def _sync(t):
            # planar results sync via their planes; dense via .jax
            pp = t._planar
            return (pp.re, pp.im) if pp is not None else t.jax

        td = bench(lambda: _sync(dsc.fft(xcd)))
        # host numpy at 2^26 needs ~1.5 GB of temporaries — skip above 2^24
        tn = bench_host(lambda: np.fft.fft(xc)) if e <= 24 else float('nan')
        tr = bench(lambda: _sync(dsc.rfft(xrd)))
        RESULTS.append({'bench': 'fft1d', 'log2n': e, 'fft_s': td,
                        'rfft_s': tr, 'numpy_fft_s': tn,
                        'fft_gflops': flops_c / td / 1e9,
                        'rfft_gflops': flops_r / tr / 1e9})

        _dump()
        print(f'2^{e:<7} {td * 1e6:10.1f}us {tn * 1e6:10.1f}us '
              f'{flops_c / td / 1e9:9.1f} {flops_c / tn / 1e9:9.1f} '
              f'{flops_r / tr / 1e9:10.1f}')

    def _sync2(t):
        pp = t._planar
        return (pp.re, pp.im) if pp is not None else t.jax

    print('\n== batched fft suite (BASELINE config 3) ==')
    for b, e in (((2048, 12), (256, 16), (64, 18), (16, 20), (4, 22))
                 if part in ('all', 'batched') else ()):
        n = 2**e
        x = (np.random.randn(b, n) + 1j * np.random.randn(b, n)).astype(
            np.complex64
        )
        xd = dsc.from_numpy(x)
        td = bench(lambda: _sync2(dsc.fft(xd)))
        gf = 5 * n * e * b / td / 1e9
        tn = bench_host(lambda: np.fft.fft(x, axis=-1))
        RESULTS.append({'bench': 'fft_batched', 'batch': b, 'log2n': e,
                        'dsc_s': td, 'numpy_s': tn, 'gflops': gf})
        _dump()
        print(f'  {b:5d} x 2^{e:<3}: dsc {td * 1e3:8.2f} ms ({gf:7.1f} GF/s)  '
              f'numpy {tn * 1e3:8.2f} ms  ({tn / td:6.2f}x)')

    print('\n== batched over non-last axis (reference axis uniformity, '
          'dsc.cpp:2121-2142) ==')
    if part in ('all', 'batched'):
        b, e = 64, 18
        n = 2**e
        x = np.random.randn(b, n).astype(np.float32)
        xT = np.ascontiguousarray(x.T)  # (n, b): transform over axis 0
        xd, xdT = dsc.from_numpy(x), dsc.from_numpy(xT)
        t_last = bench(lambda: _sync2(dsc.rfft(xd)))
        t_ax0 = bench(lambda: _sync2(dsc.rfft(xdT, axis=0)))
        RESULTS.append({'bench': 'fft_axis', 'batch': b, 'log2n': e,
                        'last_s': t_last, 'axis0_s': t_ax0,
                        'ratio': t_ax0 / t_last})
        _dump()
        print(f'  rfft (64 x 2^{e}) axis=-1 {t_last * 1e3:.2f} ms vs '
              f'axis=0 {t_ax0 * 1e3:.2f} ms  (x{t_ax0 / t_last:.2f})')

    print('\n== plan-cache stress (>16 plans) ==')
    t0 = time.perf_counter()
    n_plans = 0
    # 2^6-2^15 plans, then two large plans (2^18, 2^20) so LRU eviction
    # of big twiddle sets is exercised on the device (reference cache
    # semantics dsc.cpp:182-267)
    sizes = [(e, k) for e in range(6, 16) for k in ('c', 'r')] + \
        [(18, 'r'), (20, 'r')]
    for e, kind in (sizes if part in ('all', 'stress') else ()):
        n = 2**e
        if kind == 'c':
            x = dsc.from_numpy(
                (np.random.randn(n) + 0j).astype(np.complex64))
            res = _sync2(dsc.fft(x))
        else:
            x = dsc.from_numpy(np.random.randn(n).astype(np.float32))
            res = _sync2(dsc.rfft(x))
        jax.block_until_ready(res)
        n_plans += 1
    dt = time.perf_counter() - t0
    RESULTS.append({'bench': 'plan_stress', 'plans': n_plans, 'seconds': dt,
                    'cache_cap': fft_plan.MAX_FFT_PLANS,
                    'cache_now': fft_plan.num_plans()})
    print(f'  {n_plans} distinct plans executed in {dt:.1f}s '
          f'(cache cap {fft_plan.MAX_FFT_PLANS}, holding '
          f'{fft_plan.num_plans()})')

    _dump()
    print(f'\n{len(RESULTS)} measurements -> {_out_path()}')


if __name__ == '__main__':
    sys.exit(main())
