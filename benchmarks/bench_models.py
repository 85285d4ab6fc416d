"""Model-pipeline benchmarks: STFT, ISTFT, OverlapSave, FilterFFT.

The reference has no models — these pipelines are the
extension tier (dsc_tpu/models/), each running as ONE fused XLA program.
Throughput is reported in Msamples/s of *input* audio (the number a
streaming-DSP user cares about) plus the per-call device time, vs the
equivalent NumPy formulation per reference methodology (README.md:173:
NumPy is the executable specification). Emits
benchmarks/results_models.json with per-row merge dumps (timeout-safe,
same contract as bench_fft.py).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # repo root
import dsc_tpu as dsc
from utils import bench, bench_host

RESULTS = []


def _out_path():
    return os.path.join(os.path.dirname(__file__), 'results_models.json')


def _dump():
    if int(os.environ.get('DSC_BENCH_QUICK', '0')):
        return  # quick-mode numbers are meaningless; never record them
    merged = RESULTS
    if os.path.exists(_out_path()):
        with open(_out_path()) as f:
            old = json.load(f)
        keys = {(r.get('bench'), r.get('config')) for r in RESULTS}
        merged = [r for r in old if (r.get('bench'), r.get('config'))
                  not in keys] + RESULTS
    with open(_out_path(), 'w') as f:
        json.dump(merged, f, indent=1)


def _sync(t):
    pp = t._planar
    return (pp.re, pp.im) if pp is not None else t.jax


def main():
    from dsc_tpu.models import ISTFT, STFT, FilterFFT, OverlapSave

    dsc.init(int(8 * 2**30))
    rng = np.random.default_rng(42)
    # DSC_BENCH_QUICK=1: tiny shapes, one timed call — CPU-feasible smoke
    # of the full suite logic (the recorded numbers are then meaningless)
    quick = bool(int(os.environ.get('DSC_BENCH_QUICK', '0')))
    sh = (lambda n: max(n // 64, 4096)) if quick else (lambda n: n)
    if quick:
        import utils

        utils.BENCH_STEPS = 1

    print('== STFT (frame=1024, hop=256, hann, log-power) ==')
    for name, b, n in (('1x2^20', 1, sh(2**20)), ('16x2^18', 16, sh(2**18))):
        x = rng.standard_normal((b, n)).astype(np.float32)
        xd = dsc.from_numpy(x if b > 1 else x[0])
        stft = STFT(frame=1024, hop=256)
        td = bench(lambda: _sync(stft(xd)))
        win = np.hanning(1024).astype(np.float32)
        nf = 1 + (n - 1024) // 256

        def np_stft():
            idx = np.arange(nf)[:, None] * 256 + np.arange(1024)[None, :]
            fr = x.reshape(b, -1)[:, idx] * win
            return np.log(np.abs(np.fft.rfft(fr, axis=-1)) ** 2 + 1e-10)

        tn = bench_host(np_stft)
        ms = b * n / td / 1e6
        RESULTS.append({'bench': 'stft', 'config': name, 'dsc_s': td,
                        'numpy_s': tn, 'msamples_s': ms})
        _dump()
        print(f'  {name:>9}: dsc {td * 1e3:8.2f} ms ({ms:8.1f} Msample/s)  '
              f'numpy {tn * 1e3:8.2f} ms  ({tn / td:6.2f}x)')

    print('== STFT complex -> ISTFT round-trip (frame=1024, hop=256) ==')
    for name, b, n in (('4x2^18', 4, 2**18),):
        x = rng.standard_normal((b, n)).astype(np.float32)
        xd = dsc.from_numpy(x)
        stft = STFT(frame=1024, hop=256, mode='complex')
        istft = ISTFT(frame=1024, hop=256)
        Z = stft(xd)
        td = bench(lambda: _sync(istft(stft(xd))))
        RESULTS.append({'bench': 'stft_istft', 'config': name, 'dsc_s': td,
                        'msamples_s': b * n / td / 1e6})
        _dump()
        print(f'  {name:>9}: dsc {td * 1e3:8.2f} ms '
              f'({b * n / td / 1e6:8.1f} Msample/s roundtrip)')
        del Z

    print('== OverlapSave FIR (129 taps, fft_n=8192) ==')
    for name, b, n in (('1x2^22', 1, 2**22), ('8x2^20', 8, 2**20)):
        x = rng.standard_normal((b, n)).astype(np.float32)
        taps = rng.standard_normal(129).astype(np.float32)
        xd = dsc.from_numpy(x if b > 1 else x[0])
        ola = OverlapSave(taps, fft_n=8192)
        td = bench(lambda: _sync(ola(xd)))
        tn = bench_host(lambda: np.stack(
            [np.convolve(row, taps) for row in x]))
        ms = b * n / td / 1e6
        RESULTS.append({'bench': 'overlap_save', 'config': name,
                        'dsc_s': td, 'numpy_s': tn, 'msamples_s': ms})
        _dump()
        print(f'  {name:>9}: dsc {td * 1e3:8.2f} ms ({ms:8.1f} Msample/s)  '
              f'np.convolve {tn * 1e3:8.2f} ms  ({tn / td:6.2f}x)')

    print('== FilterFFT streaming block (2^20 block, 129 taps) ==')
    n = 2**20
    x = rng.standard_normal(n).astype(np.float32)
    taps = rng.standard_normal(129).astype(np.float32)
    filt = FilterFFT(taps, block_size=n)
    xd = dsc.from_numpy(x)
    td = bench(lambda: _sync(filt(xd)))
    tn = bench_host(lambda: np.fft.irfft(
        np.fft.rfft(x, 2**21) * np.fft.rfft(taps, 2**21))[: n + 128])
    RESULTS.append({'bench': 'filter_fft', 'config': '2^20', 'dsc_s': td,
                    'numpy_s': tn, 'msamples_s': n / td / 1e6})
    _dump()
    print(f'  2^20     : dsc {td * 1e3:8.2f} ms '
          f'({n / td / 1e6:8.1f} Msample/s)  '
          f'numpy {tn * 1e3:8.2f} ms  ({tn / td:6.2f}x)')

    print('== sosfilt assoc-scan IIR (butter(4, 0.25) lowpass) ==')
    import scipy.signal as sps

    from dsc_tpu.models import butter, sosfilt, welch

    sos = butter(4, 0.25, 'low')
    for name, b, n in (('1x2^22', 1, sh(2**22)), ('8x2^20', 8, sh(2**20))):
        x = rng.standard_normal((b, n)).astype(np.float32)
        xd = dsc.from_numpy(x if b > 1 else x[0])
        td = bench(lambda: _sync(sosfilt(sos, xd)))
        tn = bench_host(lambda: sps.sosfilt(sos, x, axis=-1))
        ms = b * n / td / 1e6
        RESULTS.append({'bench': 'sosfilt', 'config': name, 'dsc_s': td,
                        'scipy_s': tn, 'msamples_s': ms})
        _dump()
        print(f'  {name:>9}: dsc {td * 1e3:8.2f} ms ({ms:8.1f} Msample/s)  '
              f'scipy {tn * 1e3:8.2f} ms  ({tn / td:6.2f}x)')

    print('== welch PSD (nperseg=1024, hann, density) ==')
    for name, b, n in (('1x2^22', 1, sh(2**22)), ('16x2^18', 16, sh(2**18))):
        x = rng.standard_normal((b, n)).astype(np.float32)
        xd = dsc.from_numpy(x if b > 1 else x[0])
        td = bench(lambda: _sync(welch(xd, nperseg=1024)[1]))
        tn = bench_host(lambda: sps.welch(x, nperseg=1024, axis=-1)[1])
        ms = b * n / td / 1e6
        RESULTS.append({'bench': 'welch', 'config': name, 'dsc_s': td,
                        'scipy_s': tn, 'msamples_s': ms})
        _dump()
        print(f'  {name:>9}: dsc {td * 1e3:8.2f} ms ({ms:8.1f} Msample/s)  '
              f'scipy {tn * 1e3:8.2f} ms  ({tn / td:6.2f}x)')

    print('== CWT ricker (64 widths, batched planar FFT) ==')
    from scipy.signal._peak_finding import _cwt as sp_cwt
    from scipy.signal._peak_finding import _ricker as sp_ricker

    from dsc_tpu.models import ShortTimeFFT, cwt, ricker

    for name, n, nw in (('2^16x64', sh(2**16), 64),):
        x = rng.standard_normal(n).astype(np.float32)
        widths = np.arange(1, nw + 1).astype(np.float64)
        xd = dsc.from_numpy(x)
        td = bench(lambda: _sync(cwt(xd, ricker, widths)))
        tn = bench_host(lambda: sp_cwt(x.astype(np.float64), sp_ricker,
                                       widths))
        ms = n * nw / td / 1e6
        RESULTS.append({'bench': 'cwt', 'config': name, 'dsc_s': td,
                        'scipy_s': tn, 'msamples_s': ms})
        _dump()
        print(f'  {name:>9}: dsc {td * 1e3:8.2f} ms ({ms:8.1f} Msample/s)  '
              f'scipy {tn * 1e3:8.2f} ms  ({tn / td:6.2f}x)')

    print('== ShortTimeFFT.stft (hann 1024 / hop 256) ==')
    for name, n in (('2^20', sh(2**20)),):
        x = rng.standard_normal(n).astype(np.float32)
        xd = dsc.from_numpy(x)
        w64 = sps.get_window('hann', 1024).astype(np.float64)
        SFT = ShortTimeFFT(w64, hop=256, fs=1.0)
        SFT_ref = sps.ShortTimeFFT(w64, hop=256, fs=1.0)
        td = bench(lambda: _sync(SFT.stft(xd)))
        tn = bench_host(lambda: SFT_ref.stft(x.astype(np.float64)))
        ms = n / td / 1e6
        RESULTS.append({'bench': 'short_time_fft', 'config': name,
                        'dsc_s': td, 'scipy_s': tn, 'msamples_s': ms})
        _dump()
        print(f'  {name:>9}: dsc {td * 1e3:8.2f} ms ({ms:8.1f} Msample/s)  '
              f'scipy {tn * 1e3:8.2f} ms  ({tn / td:6.2f}x)')

    print(f'\nresults -> {_out_path()}')


if __name__ == '__main__':
    main()
