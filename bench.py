"""dsc_tpu headline benchmark: one process, public API, GPU only.

Rows (each warmed up once, then timed over REPS calls that each end in
``block_until_ready``; median and spread reported):
  - rfft -> irfft of 2^24 float32 samples
  - fft -> ifft of 2^24 complex64 samples
  - fma ``a * b + c`` (one dsc.map program) and ``dsc.sin`` on 256 MiB f32

FFT rates use the conventional 2.5*N*log2(N) (real) and 5*N*log2(N)
(complex) flop counts per transform (reference
benchmarks/python/bench_fft.py:32-78); elementwise rates are bytes read
plus bytes written over time. Prints the per-row table to stderr and ONE
JSON line to stdout naming the platform, device kind, device count and the
card's power limit. Exits non-zero without a GPU: a CPU time is not a
device number.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np

import jax

import dsc_tpu as dsc
from chip_smoke import card_info, card_label, ready

N_FFT = 2**24
N_ELEM = 2**26  # 256 MiB of float32
REPS = 5


def _time(fn):
    ready(fn())
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(max(ts) - min(ts))


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        print(f'bench.py needs a GPU; JAX found {dev.platform}',
              file=sys.stderr)
        return 1
    cards = card_info()
    card = card_label(cards)
    dsc.init(int(16 * 2**30))
    rng = np.random.default_rng(0)
    x = dsc.from_numpy(rng.standard_normal(N_FFT).astype(np.float32))
    z = dsc.from_numpy((rng.standard_normal(N_FFT)
                        + 1j * rng.standard_normal(N_FFT)).astype(np.complex64))
    a, b, c = (dsc.from_numpy(rng.standard_normal(N_ELEM).astype(np.float32))
               for _ in range(3))
    fma = dsc.map(lambda p, q, r: p * q + r)
    lg = math.log2(N_FFT)
    nb = N_ELEM * 4
    rows = {
        'rfft_irfft_2^24_f32': (lambda: dsc.irfft(dsc.rfft(x)),
                                'GFLOP/s', 2 * 2.5 * N_FFT * lg),
        'fft_ifft_2^24_c64': (lambda: dsc.ifft(dsc.fft(z)),
                              'GFLOP/s', 2 * 5 * N_FFT * lg),
        'fma_256MiB_f32': (lambda: fma(a, b, c), 'GB/s', 4 * nb),
        'sin_256MiB_f32': (lambda: dsc.sin(a), 'GB/s', 2 * nb),
    }
    out = {}
    for name, (fn, unit, work) in rows.items():
        med, spread = _time(fn)
        rate = work / med / 1e9
        out[name] = {'median_ms': med * 1e3, 'spread_ms': spread * 1e3,
                     unit: rate}
        print(f'{name}: {med * 1e3:.3f} ms (spread {spread * 1e3:.3f} ms), '
              f'{rate:.1f} {unit} [{card}]', file=sys.stderr)
    print(json.dumps({
        'platform': dev.platform, 'device_kind': dev.device_kind,
        'device_count': len(jax.devices()),
        'card_power_limit': cards, 'reps': REPS, 'rows': out,
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
