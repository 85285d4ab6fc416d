"""FFT-based convolution (the reference README's filterFFT example,
README.md:110-137): out = irfft(rfft(signal) * rfft(taps))[:n+taps-1].

``FilterFFT`` precomputes the kernel spectrum once (the "weights") and
reuses it across calls — the natural shape for a streaming filter.
Each block runs through ONE ``dsc.compile`` program (rfft + spectrum
multiply + irfft + crop fused into a single device dispatch), instead of
the reference's one-C-call-per-op eager chain.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

import numpy as np

from ..fourier import irfft, irfft2, rfft, rfft2
from ..fourier.plan import next_pow2
from ..fuse import compile as _compile
from ..tensor import Tensor, from_numpy, mul


def fft_convolve(signal: Tensor, taps: Tensor, mode: str = 'full') -> Tensor:
    """1-D convolution via the frequency domain (np.convolve semantics,
    modes 'full'/'same'/'valid'). ``signal`` may be (n,) or batched
    (b, n) with 1-D ``taps``."""
    n = signal.shape[-1]
    k = taps.shape[-1]
    out_len = n + k - 1
    fft_n = next_pow2(out_len)
    spec = mul(
        rfft(signal, n=fft_n),
        rfft(taps, n=fft_n),
    )
    conv = irfft(spec)
    batched = signal.n_dim == 2

    def crop(lo, hi):
        return conv[:, lo:hi] if batched else conv[lo:hi]

    if mode == 'full':
        return crop(0, out_len)
    if mode == 'same':
        start = (k - 1) // 2
        return crop(start, start + n)
    if mode == 'valid':
        lo, hi = (min(n, k) - 1), max(n, k)
        return crop(lo, hi)
    raise RuntimeError(f'unknown convolution mode {mode!r}')


def fft_convolve2(a: Tensor, k: Tensor, mode: str = 'full') -> Tensor:
    """2-D convolution via the frequency domain
    (scipy.signal.fftconvolve semantics for 2-D real inputs, modes
    'full' / 'same' / 'valid'; 'valid' needs the kernel no larger than
    the image on both axes). Rides the rfft2/irfft2 family — each
    transform axis pads to the next power of two."""
    if a.n_dim != 2 or k.n_dim != 2:
        raise RuntimeError(
            f'fft_convolve2: expected 2-D inputs, got {a.n_dim}-D and '
            f'{k.n_dim}-D'
        )
    if a.dtype.is_complex or k.dtype.is_complex:
        raise RuntimeError('fft_convolve2 expects real inputs')
    m, n = a.shape
    p, q = k.shape
    om, on = m + p - 1, n + q - 1
    s = (next_pow2(om), next_pow2(on))
    spec = mul(rfft2(a, s=s), rfft2(k, s=s))
    full = irfft2(spec)[:om, :on]
    if mode == 'full':
        return full
    if mode == 'same':
        sm, sn = (p - 1) // 2, (q - 1) // 2
        return full[sm : sm + m, sn : sn + n]
    if mode == 'valid':
        if p > m or q > n:
            raise RuntimeError(
                'fft_convolve2: valid mode needs the kernel no larger '
                'than the image'
            )
        return full[p - 1 : m, q - 1 : n]
    raise RuntimeError(f'unknown convolution mode {mode!r}')


def correlate2d(a: Tensor, k: Tensor, mode: str = 'full') -> Tensor:
    """2-D cross-correlation (scipy.signal.correlate2d semantics for
    real inputs, boundary='fill'): convolution with the doubly-flipped
    kernel via :func:`fft_convolve2`."""
    if k.n_dim != 2:
        raise RuntimeError(f'correlate2d: expected a 2-D kernel, got {k.n_dim}-D')
    return fft_convolve2(a, k[::-1, ::-1], mode=mode)


def correlate(a: Tensor, v: Tensor, mode: str = 'valid') -> Tensor:
    """1-D cross-correlation via the frequency domain (np.correlate
    semantics: ``c[k] = sum_n a[n+k] v[n]``, modes 'valid' (default) /
    'same' / 'full'). Real signals, ``len(a) >= len(v)``. A 1-element
    result unwraps to a Python scalar (the dsc __getitem__ rule,
    reference tensor.py:91-103)."""
    if a.dtype.is_complex or v.dtype.is_complex:
        raise RuntimeError('correlate expects real signals')
    n, k = a.shape[-1], v.shape[-1]
    if n < k:
        raise RuntimeError(
            f'correlate: len(a) ({n}) must be >= len(v) ({k})'
        )
    full = fft_convolve(a, v[::-1], mode='full')  # length n + k - 1
    if mode == 'full':
        return full
    if mode == 'same':
        start = (k - 1) // 2
        return full[start : start + n]
    if mode == 'valid':
        return full[k - 1 : n]
    raise RuntimeError(f'unknown correlation mode {mode!r}')


class FilterFFT:
    """Streaming FIR filter: kernel spectrum cached, one rfft+mul+irfft per
    call."""

    def __init__(self, taps, block_size: int):
        if isinstance(taps, np.ndarray):
            taps = from_numpy(taps)
        self.n_taps = taps.shape[-1]
        self.block_size = block_size
        self.out_len = block_size + self.n_taps - 1
        self.fft_n = next_pow2(self.out_len)
        self.kernel_spec = rfft(taps, n=self.fft_n)
        fft_n, out_len = self.fft_n, self.out_len

        @_compile
        def _step(block: Tensor, kspec: Tensor) -> Tensor:
            return irfft(mul(rfft(block, n=fft_n), kspec))[:out_len]

        @_compile
        def _step_b(block: Tensor, kspec: Tensor) -> Tensor:
            return irfft(mul(rfft(block, n=fft_n), kspec))[:, :out_len]

        self._step = _step
        self._step_b = _step_b

    def __call__(self, block: Tensor) -> Tensor:
        """block: (block_size,) or (batch, block_size) f32."""
        if block.n_dim not in (1, 2):
            raise RuntimeError(
                f'expected a 1-D or 2-D block, got {block.n_dim}-D'
            )
        if block.shape[-1] != self.block_size:
            raise RuntimeError(
                f'expected block of {self.block_size} samples, '
                f'got {block.shape[-1]}'
            )
        step = self._step_b if block.n_dim == 2 else self._step
        return step(block, self.kernel_spec)


def convolve(in1: Tensor, in2: Tensor, mode: str = 'full',
             method: str = 'auto') -> Tensor:
    """scipy.signal.convolve for 1-D and 2-D Tensors. Every ``method``
    routes to the FFT engine ('direct' included; results match the
    direct sum to f32 rounding, which the tests pin)."""
    if method not in ('auto', 'fft', 'direct'):
        raise RuntimeError(f'convolve: unknown method {method!r}')
    if in2.n_dim == 2 and in1.n_dim == 2:
        return fft_convolve2(in1, in2, mode=mode)
    if in2.n_dim != 1:
        raise RuntimeError('convolve: in2 must be 1-D (or both 2-D)')
    return fft_convolve(in1, in2, mode=mode)


def oaconvolve(in1: Tensor, in2: Tensor, mode: str = 'full') -> Tensor:
    """scipy.signal.oaconvolve: block convolution with bounded FFT size
    for long-signal/short-kernel pairs (the overlap-save engine,
    models/ola.py), falling back to one whole-signal FFT when blocking
    would not help. 1-D real Tensors."""
    if in1.n_dim not in (1, 2) or in2.n_dim != 1:
        raise RuntimeError('oaconvolve: expected (n,)/(b, n) in1 and 1-D '
                           'in2')
    n, k = in1.shape[-1], in2.shape[-1]
    if mode not in ('full', 'same', 'valid'):
        raise RuntimeError(f'oaconvolve: unknown mode {mode!r}')
    # blocking pays off when the signal is much longer than the kernel
    if n >= 8 * k and k <= 1 << 15:
        from .ola import OverlapSave

        full = OverlapSave(in2)(in1)
        out_len = n + k - 1
        lo = {'full': 0, 'same': (k - 1) // 2,
              'valid': min(n, k) - 1}[mode]
        hi = {'full': out_len, 'same': (k - 1) // 2 + n,
              'valid': max(n, k)}[mode]
        return full[:, lo:hi] if in1.n_dim == 2 else full[lo:hi]
    return fft_convolve(in1, in2, mode=mode)


def convolve2d(in1: Tensor, in2: Tensor, mode: str = 'full',
               boundary: str = 'fill', fillvalue: float = 0.0) -> Tensor:
    """2-D convolution with boundary handling
    (scipy.signal.convolve2d semantics): ``boundary`` in {'fill' (pad
    with ``fillvalue``), 'wrap' (circular), 'symm' (symmetric
    reflection)}. Non-zero boundaries pre-extend the image by the
    kernel radius in-program, then ride the same rfft2 engine."""
    if in1.n_dim != 2 or in2.n_dim != 2:
        raise RuntimeError('convolve2d: expected 2-D inputs')
    if mode not in ('full', 'same', 'valid'):
        raise RuntimeError(f'convolve2d: unknown mode {mode!r}')
    if boundary == 'fill' and fillvalue == 0.0:
        return fft_convolve2(in1, in2, mode=mode)
    p, q = in2.shape
    m, n = in1.shape
    if boundary == 'fill':
        xp = jnp.pad(in1.jax, ((p - 1, p - 1), (q - 1, q - 1)),
                     constant_values=float(fillvalue))
    elif boundary == 'wrap':
        xp = jnp.pad(in1.jax, ((p - 1, p - 1), (q - 1, q - 1)),
                     mode='wrap')
    elif boundary == 'symm':
        xp = jnp.pad(in1.jax, ((p - 1, p - 1), (q - 1, q - 1)),
                     mode='symmetric')
    else:
        raise RuntimeError(f'convolve2d: unknown boundary {boundary!r}')
    full = fft_convolve2(Tensor._from_jax(xp), in2, mode='valid')
    # 'valid' of the extended image == 'full' of the original
    if mode == 'full':
        return full
    if mode == 'same':
        r0, c0 = (p - 1) // 2, (q - 1) // 2
        return full[r0:r0 + m, c0:c0 + n]
    return full[p - 1:m, q - 1:n]
