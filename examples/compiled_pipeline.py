"""dsc.compile — fuse a whole DSP pipeline into one device program.

The eager API dispatches one device call per op (like the reference's
one-C-call-per-op design, README.md:110-137); ``dsc.compile`` traces the
same public-API code once into a single XLA program, so elementwise
intermediates fuse and the per-op dispatch cost is paid once per call. This example spectrally gates a noisy tone: the rfft, the mask
multiply, and the irfft all run as ONE dispatch.

Run: python examples/compiled_pipeline.py       (JAX's default device)
     JAX_PLATFORMS=cpu python examples/compiled_pipeline.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # repo root

import dsc_tpu as dsc

dsc.init(int(2**30))

n = 2**18
fs = 48_000.0
t = np.arange(n, dtype=np.float32) / fs
clean = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
noisy = clean + 0.5 * np.random.randn(n).astype(np.float32)

# keep only bins below 1 kHz — a hard spectral gate
freqs = np.fft.rfftfreq(n, d=1.0 / fs)
mask = (freqs < 1000.0).astype(np.float32)


@dsc.compile
def denoise(signal, gate):
    spec = dsc.rfft(signal)
    return dsc.irfft(spec * gate)


sig = dsc.from_numpy(noisy)
gate = dsc.from_numpy(mask)

out = denoise(sig, gate).numpy()        # first call traces + compiles
t0 = time.perf_counter()
out = denoise(sig, gate).numpy()        # subsequent calls: one dispatch
dt = time.perf_counter() - t0

ref = np.fft.irfft(np.fft.rfft(noisy) * mask)
print(f'compiled denoise vs np.fft max err: {np.abs(out - ref).max():.3e}')
print(f'residual vs clean tone: {np.abs(out - clean).std():.3f}')
print(f'programs cached: {denoise.n_programs} (one per argument signature)')
print(f'steady-state call (1 dispatch incl. download): {dt * 1e3:.2f} ms')
