"""Overlap-save block convolution: FIR-filter an arbitrarily long signal
with a BOUNDED FFT size.

The reference's filterFFT example (README.md:110-137) transforms the whole
signal at once, so its FFT grows with the input. Overlap-save is the
classic DSP decomposition — overlapping fft_n-sample blocks, one batched
rfft·K·irfft, keep the last hop = fft_n - (taps-1) samples of each block —
and it is the natural shape for long signals: every block rides the
batched FFT engine (fourier/core.py) as ONE jitted program of static
shapes, with the framing expressed as pure data movement.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import tracing
from ..fourier import core as fft_core
from ..fourier import plan as fft_plan
from ..tensor import Tensor, from_numpy


@partial(
    jax.jit,
    static_argnames=('fft_n', 'hop', 'n_blocks', 'k', 'out_len', 'spec'),
)
def _ola_program(x, kre, kim, tables, fft_n, hop, n_blocks, k, out_len,
                 spec):
    """pad -> frame -> batched rfft -> spectrum multiply -> batched irfft
    -> discard the k-1 wrap samples per block -> concatenate. One device
    dispatch for the whole signal batch. ``x`` is (b, n); all b*n_blocks
    blocks go through the FFT engine as one batch."""
    b = x.shape[0]
    pad_front = k - 1
    total = (n_blocks - 1) * hop + fft_n
    xp = jnp.zeros((b, total), x.dtype).at[
        :, pad_front : pad_front + x.shape[1]
    ].set(x)
    from .stft import _frame_dense

    frames = _frame_dense(xp, fft_n, hop, n_blocks)  # (b, n_blocks, fft_n)
    z = fft_core.rfft_batched(frames.reshape(-1, fft_n), spec, tables, fft_n)
    z = z * jax.lax.complex(kre, kim)[None, :]
    y = fft_core.irfft_batched(z, spec, tables, fft_n)
    y = y.reshape(b, n_blocks, fft_n)
    return y[:, :, k - 1 :].reshape(b, -1)[:, :out_len]


class OverlapSave:
    """Streaming FIR filter over long signals with a fixed FFT size.

    ``OverlapSave(taps)(x)`` equals ``np.convolve(x, taps)`` (mode='full')
    for any signal length, using fft_n-point transforms regardless of
    ``len(x)`` — unlike ``fft_convolve`` whose transform grows with the
    signal. The kernel spectrum is computed once at construction.
    """

    def __init__(self, taps, fft_n: Optional[int] = None):
        if isinstance(taps, np.ndarray):
            taps = from_numpy(taps)
        k = taps.shape[-1]
        if fft_n is None:
            # ~87% useful samples per block while staying kernel-friendly
            fft_n = max(fft_plan.next_pow2(8 * k), 256)
        if fft_n & (fft_n - 1):
            raise RuntimeError(f'fft_n must be a power of two, got {fft_n}')
        if fft_n < fft_plan.next_pow2(2 * k):
            raise RuntimeError(
                f'fft_n ({fft_n}) too small for {k} taps: need >= '
                f'{fft_plan.next_pow2(2 * k)}'
            )
        self.n_taps = k
        self.fft_n = fft_n
        self.hop = fft_n - (k - 1)
        # hold the plan tuple directly: cache eviction cannot invalidate it
        self._spec, self._tables = fft_plan.get_plan(
            fft_n, 'real', np.complex64
        )
        tj = jnp.pad(taps.jax.astype(jnp.float32), (0, fft_n - k))
        zk = fft_core.rfft_batched(
            tj.reshape(1, fft_n), self._spec, self._tables, fft_n
        )[0]
        self._kre = jnp.real(zk)
        self._kim = jnp.imag(zk)

    def __call__(self, x: Tensor) -> Tensor:
        """x: (n,) or (batch, n) f32 -> (n + n_taps - 1,) f32 full
        convolution (with a leading batch dim for batched input)."""
        if x.n_dim not in (1, 2):
            raise RuntimeError(
                f'expected a 1-D or 2-D signal, got {x.n_dim}-D'
            )
        batched = x.n_dim == 2
        n = x.shape[-1]
        out_len = n + self.n_taps - 1
        n_blocks = -(-out_len // self.hop)
        xj = x.jax.astype(jnp.float32)
        if not batched:
            xj = xj[None, :]
        with tracing.trace_op(
            'overlap_save', 'op;pipeline', tracing.tensor_args(x=x)
        ) as tr:
            out = _ola_program(
                xj, self._kre, self._kim,
                self._tables, self.fft_n, self.hop, n_blocks, self.n_taps,
                out_len, self._spec,
            )
            if tr:
                tr.result = out
        return Tensor._from_jax(out if batched else out[0])


def overlap_save_convolve(
    signal: Tensor, taps: Tensor, fft_n: Optional[int] = None
) -> Tensor:
    """One-shot ``np.convolve(signal, taps)`` via overlap-save blocks."""
    return OverlapSave(taps, fft_n=fft_n)(signal)
