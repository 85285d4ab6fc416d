"""AM demodulation: hilbert -> envelope -> fused post-chain -> resample.

End-to-end demo of the spectral model layer (dsc_tpu.models.hilbert /
resample) plus the dsc.map fusion tier: an amplitude-modulated carrier
is demodulated by taking the analytic-signal envelope, the envelope is
normalized with ONE fused pass (dsc.map), and decimated 16x
with Fourier resampling. Recovered message is compared against the
known modulator.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # repo root

import dsc_tpu as dsc
from dsc_tpu.models import hilbert, resample

dsc.init(int(2**30))

fs = 65_536.0
n = 2**18  # 4 s
t = np.arange(n, dtype=np.float64) / fs
message = 0.5 * (1.0 + 0.8 * np.sin(2 * np.pi * 3.0 * t))   # 3 Hz modulator
carrier = np.sin(2 * np.pi * 4000.0 * t)                    # 4 kHz carrier
am = (message * carrier).astype(np.float32)

# analytic signal; |x + i*HT(x)| is the instantaneous amplitude
env = dsc.absolute(hilbert(dsc.from_numpy(am)))

# fused post-processing: remove the 0.5 bias and rescale, one HBM pass
post = dsc.map(lambda e: dsc.clip((e - 0.5) * 2.5, -2.0, 2.0))
demod = post(env)

# decimate 16x via Fourier resampling for the "audio-rate" message
msg = resample(demod, n // 16).numpy()

want = ((message - 0.5) * 2.5).astype(np.float32)[::16]
sl = slice(256, len(msg) - 256)  # edge transients excluded
err = float(np.abs(msg[sl] - want[sl]).max())
print(f'recovered message: {len(msg)} samples, max err {err:.3e}')
assert err < 5e-2, err
print('AM demodulation OK')
