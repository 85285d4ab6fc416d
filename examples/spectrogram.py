"""STFT spectrogram pipeline (BASELINE.md config 4): sliding-window rfft
+ |.|^2 + log over streaming audio, traced end-to-end with dsc.profile()."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # repo root

import dsc_tpu as dsc
from dsc_tpu.models import STFT

dsc.init(int(2**30))

fs = 16_000.0
dur = 4.0
n = int(fs * dur)
t = np.arange(n, dtype=np.float32) / fs
# chirp from 100 Hz to 4 kHz
sig = np.sin(2 * np.pi * (100 + (4000 - 100) * t / dur / 2) * t).astype(
    np.float32
)

stft = STFT(frame=512, hop=128, window='hann', log=True)

# DSC_XPROF=<dir> merges the device timeline (XLA ops, DMA) into the same
# trace file, one Perfetto view of dsc ops over device ops
xprof_dir = os.environ.get('DSC_XPROF') or None

with dsc.profile('stft_traces.json', serve=False, xprof_dir=xprof_dir):
    spec = stft(dsc.from_numpy(sig))

s = spec.numpy()
print(f'spectrogram: {s.shape} (frames x bins), '
      f'range [{s.min():.1f}, {s.max():.1f}] dB-ish')
frame_of_peak = int(np.argmax(s.max(axis=1)))
print(f'energy peak at frame {frame_of_peak} / {s.shape[0]}')
print('trace written to stft_traces.json')
