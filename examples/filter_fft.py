"""filterFFT — the flagship example (reference README.md:110-137):
denoise a signal by FFT-convolving it with a lowpass filter, under the
profiler.

Run: python examples/filter_fft.py       (JAX's default device)
     JAX_PLATFORMS=cpu python examples/filter_fft.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # repo root

import dsc_tpu as dsc
from dsc_tpu.models import FilterFFT, fft_convolve

dsc.init(int(2**30))

n = 2**16
fs = 48_000.0
t = np.arange(n, dtype=np.float32) / fs

# 440 Hz tone buried in noise
clean = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
noisy = clean + 0.8 * np.random.randn(n).astype(np.float32)

# windowed-sinc lowpass at 1 kHz
taps_n = 255
cutoff = 1000.0 / fs
k = np.arange(taps_n) - (taps_n - 1) / 2
taps = (2 * cutoff * np.sinc(2 * cutoff * k) * np.blackman(taps_n)).astype(
    np.float32
)

signal = dsc.from_numpy(noisy)
kernel = dsc.from_numpy(taps)

with dsc.profile('traces.json', serve=False):
    filtered = fft_convolve(signal, kernel, mode='same')
    spec_mag = dsc.absolute(dsc.rfft(filtered))
    peak_bin = float(dsc.max(spec_mag, axis=-1, keepdims=False)[0])

out = filtered.numpy()
ref = np.convolve(noisy, taps, mode='same')
print(f'filtered vs np.convolve max err: {np.abs(out - ref).max():.3e}')
print(f'peak spectral magnitude: {peak_bin:.1f}')
print(f'residual vs clean tone (should be small): '
      f'{np.abs(out[taps_n:-taps_n] - clean[taps_n:-taps_n]).std():.3f}')

# streaming form: kernel spectrum cached across blocks
filt = FilterFFT(taps, block_size=4096)
block = dsc.from_numpy(noisy[:4096])
print(f'streaming block out: {filt(block).shape}')
print('trace written to traces.json (open in ui.perfetto.dev)')
