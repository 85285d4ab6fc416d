"""Elementwise / unary / reduction benchmark vs NumPy.

Workload parity with the reference (benchmarks/python/bench_simple.py:76-193):
x = [60, 60000], all 4 dtypes, binary ops add/sub/mul/div with tensor AND
scalar RHS (out= where possible), 9 unary ops
(sin/sinc/cos/logn/log2/log10/exp/sqrt/i0), reductions sum/mean/max/min
over axis=0. Methodology: 2 warmups, best of 5 (reference
benchmarks/python/utils.py:11-12).

Plus BASELINE config 2: a 1 KB - 256 MiB size sweep with broadcasting
(same-shape, scalar RHS, broadcast row) and a reduction sweep.

Emits machine-readable JSON to benchmarks/results_simple.json (one entry
per measurement) so one command regenerates every BASELINE workload row.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # repo root
import dsc_tpu as dsc
from utils import bench, bench_host

RESULTS = []

OUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'results_simple.json')


def record(**kw):
    RESULTS.append(kw)


_EXISTING = set()
if os.environ.get('DSC_BENCH_RESUME') and os.path.exists(OUT_PATH):
    with open(OUT_PATH) as _f:
        _EXISTING = {
            (r.get('bench'), r.get('dtype'), r.get('op'), r.get('rhs'),
             r.get('log2n'))
            for r in json.load(_f)
        }


def have(bench_kind, dtype=None, op=None, rhs=None, log2n=None):
    """True when DSC_BENCH_RESUME=1 and this row is already on disk."""
    return (bench_kind, dtype, op, rhs, log2n) in _EXISTING


def dump():
    """Merge-write after every row so a timed-out run keeps its rows."""
    merged = RESULTS
    if os.path.exists(OUT_PATH):
        with open(OUT_PATH) as f:
            old = json.load(f)
        keys = {(r.get('bench'), r.get('dtype'), r.get('op'), r.get('rhs'),
                 r.get('log2n')) for r in RESULTS}
        merged = [r for r in old if (r.get('bench'), r.get('dtype'),
                                     r.get('op'), r.get('rhs'),
                                     r.get('log2n')) not in keys] + RESULTS
    with open(OUT_PATH, 'w') as f:
        json.dump(merged, f, indent=1)


def fmt(t: float) -> str:
    return f'{t * 1e6:9.1f} us'


DTYPES = [
    (np.float32, dsc.Dtype.F32),
    (np.float64, dsc.Dtype.F64),
    (np.complex64, dsc.Dtype.C32),
    (np.complex128, dsc.Dtype.C64),
]


def _rand(shape, np_dt):
    x = np.random.randn(*shape)
    if np.dtype(np_dt).kind == 'c':
        x = x + 1j * np.random.randn(*shape)
    return x.astype(np_dt)


def reference_workloads():
    """The reference's exact op grid at x = [60, 60000]."""
    shape = (60, 60000)
    only = os.environ.get('DSC_BENCH_DTYPES')  # e.g. 'float32,complex64'
    print(f'== reference workload parity @ {shape} ==')
    for np_dt, dsc_dt in DTYPES:
        if only and np_dt.__name__ not in only.split(','):
            continue
        x, y = _rand(shape, np_dt), _rand(shape, np_dt)
        xd, yd = dsc.from_numpy(x), dsc.from_numpy(y)
        out = dsc.empty(shape, dtype=dsc_dt)
        npo = np.empty_like(x)

        # binary: tensor RHS and scalar RHS (reference :76-122)
        binaries = [
            ('add', dsc.add, np.add),
            ('sub', dsc.sub, np.subtract),
            ('mul', dsc.mul, np.multiply),
            ('div', dsc.true_div, np.true_divide),
        ]
        for name, dfn, nfn in binaries:
            for rhs_kind, rd, rn in (('tensor', yd, y), ('scalar', 1.5, 1.5)):
                if have('binary', np_dt.__name__, name, rhs_kind):
                    continue
                td = bench(lambda: dfn(xd, rd, out=out).jax)
                tn = bench_host(lambda: nfn(x, rn, out=npo))
                record(bench='binary', dtype=np_dt.__name__, op=name,
                       rhs=rhs_kind, shape=list(shape), dsc_s=td, numpy_s=tn)
                dump()
                print(f'{np_dt.__name__:>10} {name:>5}/{rhs_kind:<6}: '
                      f'dsc {fmt(td)}  numpy {fmt(tn)}  ({tn / td:6.2f}x)')

        # unary (reference :125-165)
        unaries = [
            ('sin', dsc.sin, np.sin), ('sinc', dsc.sinc, np.sinc),
            ('cos', dsc.cos, np.cos), ('logn', dsc.logn, np.log),
            ('log2', dsc.log2, np.log2), ('log10', dsc.log10, np.log10),
            ('exp', dsc.exp, np.exp), ('sqrt', dsc.sqrt, np.sqrt),
        ]
        for name, dfn, nfn in unaries:
            if have('unary', np_dt.__name__, name):
                continue
            needs_abs = (name.startswith('log') or name == 'sqrt') \
                and np.dtype(np_dt).kind != 'c'
            xa = np.abs(x) if needs_abs else x
            xda = dsc.from_numpy(xa)
            td = bench(lambda: dfn(xda, out=out).jax)
            tn = bench_host(lambda: nfn(xa))
            record(bench='unary', dtype=np_dt.__name__, op=name,
                   shape=list(shape), dsc_s=td, numpy_s=tn)
            dump()
            print(f'{np_dt.__name__:>10} {name:>5}: dsc {fmt(td)}  '
                  f'numpy {fmt(tn)}  ({tn / td:6.2f}x)')
        if np.dtype(np_dt).kind != 'c' and not have('unary', np_dt.__name__, 'i0'):
            xa = np.abs(x)
            xda = dsc.from_numpy(xa)
            td = bench(lambda: dsc.i0(xda).jax)
            tn = bench_host(lambda: np.i0(xa.reshape(-1)))
            record(bench='unary', dtype=np_dt.__name__, op='i0',
                   shape=list(shape), dsc_s=td, numpy_s=tn)
            dump()
            print(f'{np_dt.__name__:>10}    i0: dsc {fmt(td)}  '
                  f'numpy {fmt(tn)}  ({tn / td:6.2f}x)')

        # reductions over axis=0 (reference :168-193)
        reductions = [
            ('sum', dsc.sum, np.sum), ('mean', dsc.mean, np.mean),
            ('max', dsc.max, np.max), ('min', dsc.min, np.min),
        ]
        for name, dfn, nfn in reductions:
            if have('reduction', np_dt.__name__, name):
                continue
            td = bench(lambda: dfn(xd, axis=0).jax)
            tn = bench_host(lambda: nfn(x, axis=0))
            record(bench='reduction', dtype=np_dt.__name__, op=name,
                   shape=list(shape), dsc_s=td, numpy_s=tn)
            dump()
            print(f'{np_dt.__name__:>10} {name:>5}: dsc {fmt(td)}  '
                  f'numpy {fmt(tn)}  ({tn / td:6.2f}x)')
        dump()


def size_sweep():
    """BASELINE config 2: 1 KB - 256 MiB, f32, with broadcasting.

    DSC_SWEEP_SIZES='16,17' restricts to those log2 sizes."""
    only = os.environ.get('DSC_SWEEP_SIZES')
    sizes = ([int(s) for s in only.split(',')] if only
             else list(range(8, 27)))
    print('\n== elementwise size sweep 1 KB - 256 MiB (f32 add) ==')
    print(f'{"size":>10} {"same-shape":>22} {"scalar RHS":>22} '
          f'{"broadcast row":>22}')
    for log2n in sizes:
        ne = 2**log2n
        rows = max(ne // 4096, 1)
        cols = ne // rows
        x = dsc.randn((rows, cols))
        y = dsc.randn((rows, cols))
        row = dsc.randn((1, cols))
        out = dsc.empty((rows, cols))

        cells = []
        for label, fn in (
            ('same', lambda: dsc.add(x, y, out=out).jax),
            ('scalar', lambda: dsc.add(x, 1.5, out=out).jax),
            ('bcast', lambda: dsc.add(x, row, out=out).jax),
        ):
            if have('sweep', op=f'add/{label}', log2n=log2n):
                cells.append('(kept)')
                continue
            t = bench(fn)
            gbs = 3 * ne * 4 / t / 1e9  # 2 reads + 1 write (nominal)
            record(bench='sweep', op=f'add/{label}', log2n=log2n,
                   dsc_s=t, gbs=gbs)
            dump()
            cells.append(f'{t * 1e6:9.1f}us {gbs:6.1f}GB/s')
        dump()
        print(f'2^{log2n:<8} {cells[0]:>22} {cells[1]:>22} {cells[2]:>22}')

    print('\n== f64 add at scale ==')
    for log2n in [s for s in sizes if s in (22, 24, 25)]:
        ne = 2**log2n
        rows = max(ne // 4096, 1)
        x64 = dsc.randn((rows, ne // rows), dtype=dsc.Dtype.F64)
        y64 = dsc.randn((rows, ne // rows), dtype=dsc.Dtype.F64)
        o64 = dsc.empty((rows, ne // rows), dtype=dsc.Dtype.F64)
        if have('sweep', op='add/f64', log2n=log2n):
            continue
        t = bench(lambda: dsc.add(x64, y64, out=o64).jax)
        gbs = 3 * ne * 8 / t / 1e9
        record(bench='sweep', op='add/f64', log2n=log2n, dsc_s=t, gbs=gbs)
        dump()
        print(f'  2^{log2n:2d} ({ne * 8 / 2**20:8.2f} MiB): '
              f'{t * 1e6:9.1f} us  {gbs:7.1f} GB/s')

    print('\n== reduction size sweep (f32 sum, axis=-1) ==')
    for log2n in [s for s in (sizes if only else range(12, 27, 2))
                  if s >= 12]:
        ne = 2**log2n
        rows = max(ne // 65536, 1)
        x = dsc.randn((rows, ne // rows))
        if have('sweep', op='sum', log2n=log2n):
            continue
        t = bench(lambda: dsc.sum(x, axis=-1).jax)
        gbs = ne * 4 / t / 1e9
        record(bench='sweep', op='sum', log2n=log2n, dsc_s=t, gbs=gbs)
        dump()
        print(f'  2^{log2n:2d} ({ne * 4 / 2**20:8.2f} MiB): '
              f'{t * 1e6:9.1f} us  {gbs:7.1f} GB/s')


def main():
    dsc.init(int(8 * 2**30))
    part = os.environ.get('DSC_BENCH_PART', 'all')
    if part in ('all', 'ref'):
        reference_workloads()
    if part in ('all', 'sweep'):
        size_sweep()
    dump()
    print(f'\n{len(RESULTS)} measurements -> {OUT_PATH}')


if __name__ == '__main__':
    sys.exit(main())
