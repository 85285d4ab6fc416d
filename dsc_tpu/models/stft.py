"""STFT / spectrogram pipeline (BASELINE.md config 4: sliding-window rfft
+ |.|^2 + log over streaming audio, traced end-to-end with dsc.profile()).

Framing uses a strided gather expressed as reshape+slice so XLA lowers it to
pure data movement; the window multiply fuses into the rfft input pass.
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
from ..planar import Planar
from ..tensor import Tensor


def _make_window(window, frame: int) -> np.ndarray:
    """Window spec -> f32 host array. Accepts a name ('hann', 'hamming',
    'blackman', 'rect'/None — SYMMETRIC np.* convention; any other
    scipy.signal.get_window name or (name, *params) tuple resolves via
    ``windows.design_window`` symmetric), a dsc Tensor (e.g.
    dsc.kaiser(frame, beta)), or any array-like of length ``frame``."""
    if isinstance(window, Tensor):
        win = window.numpy()
    elif window == 'hann':
        win = np.hanning(frame)
    elif window == 'hamming':
        win = np.hamming(frame)
    elif window == 'blackman':
        win = np.blackman(frame)
    elif window is None or (isinstance(window, str) and window == 'rect'):
        win = np.ones(frame)
    elif isinstance(window, str) or (
        isinstance(window, tuple) and window
        and isinstance(window[0], str)
    ):
        from ..windows import design_window
        win = design_window(window, frame, fftbins=False)
    else:
        win = np.asarray(window)
    win = np.asarray(win, dtype=np.float32)
    if win.shape != (frame,):
        raise RuntimeError(
            f'window has shape {win.shape}, expected ({frame},)'
        )
    return win


def _frame_dense(x, frame: int, hop: int, n_frames: int):
    """Sliding-window framing as PURE LAYOUT data movement: ceil(frame/hop)
    shifted hop-wide phase slices, each a strided reshape, concatenated
    along the window axis — frames[:, i, c*hop + j] = x[:, (i+c)*hop + j].
    A vmap(dynamic_slice) formulation lowers to a gather; this version is
    plain slices XLA fuses into the consumer's input pass. ``x`` is (b, n)."""
    b = x.shape[0]
    kph = -(-frame // hop)
    need = (n_frames + kph - 1) * hop
    if x.shape[1] < need:  # the zero tail is cropped before use below
        x = jnp.pad(x, ((0, 0), (0, need - x.shape[1])))
    return jnp.concatenate(
        [
            x[:, c * hop : (c + n_frames) * hop].reshape(b, n_frames, hop)
            for c in range(kph)
        ],
        axis=2,
    )[:, :, :frame]


@partial(
    jax.jit,
    static_argnames=('frame', 'hop', 'n_frames', 'spec', 'fft_n', 'log_eps',
                     'complex_out'),
)
def _stft_program(x, window, tables, frame, hop, n_frames, spec, fft_n,
                  log_eps, complex_out=False):
    """The whole pipeline (frame -> window -> rfft -> power -> log) as ONE
    XLA program: framing lowers to pure data movement that feeds the rfft
    input pass directly, and the power/log epilogue fuses into the last
    FFT stage's output — one device dispatch per call. ``x`` is (b, n);
    all b*n_frames windows ride the batched FFT engine as one pass."""
    frames = _frame_dense(x, frame, hop, n_frames)  # (b, n_frames, frame)
    fx = (frames * window[None, None, :]).reshape(-1, frame)
    if frame != fft_n:  # non-pow2 frame: zero-pad to the transform size
        fx = jnp.pad(fx, ((0, 0), (0, fft_n - frame)))
    z = fft_core.rfft_batched(fx, spec, tables, fft_n)
    z = z.reshape(x.shape[0], n_frames, fft_n // 2 + 1)
    if complex_out:
        return jnp.real(z), jnp.imag(z)
    power = jnp.real(z) ** 2 + jnp.imag(z) ** 2
    if log_eps is not None:
        power = jnp.log(power + log_eps)
    return power


class STFT:
    """Short-time Fourier transform producing (log-)power spectrograms."""

    def __init__(
        self,
        frame: int = 1024,
        hop: int = 256,
        window='hann',
        log: bool = True,
        log_eps: float = 1e-10,
        mode: Optional[str] = None,
    ):
        """``mode``: 'log' (default), 'power', or 'complex' (the raw
        spectrogram, invertible with :class:`ISTFT`). ``log=False`` is a
        shorthand for mode='power'."""
        self.frame = frame
        self.hop = hop
        self.fft_n = fft_plan.next_pow2(frame)
        if mode is None:
            mode = 'log' if log else 'power'
        if mode not in ('log', 'power', 'complex'):
            raise RuntimeError(f'unknown STFT mode {mode!r}')
        self.mode = mode
        self.log_eps = log_eps if mode == 'log' else None
        self._window = jnp.asarray(_make_window(window, frame))

    def __call__(self, x: Tensor) -> Tensor:
        """x: (n,) or (batch, n) f32 -> (n_frames, fft_n//2+1) f32
        (log-)power (with a leading batch dim for batched input), or c32
        spectrogram in mode='complex'."""
        if x.n_dim > 2:
            raise RuntimeError(f'expected a 1-D or 2-D signal, got {x.n_dim}-D')
        batched = x.n_dim == 2
        n = x.shape[-1]
        if n < self.frame:
            raise RuntimeError(f'signal ({n}) shorter than frame ({self.frame})')
        n_frames = 1 + (n - self.frame) // self.hop
        spec, tables = fft_plan.get_plan(self.fft_n, 'real', np.complex64)
        xj = x.jax if batched else x.jax[None, :]
        with tracing.trace_op(
            'stft', 'op;pipeline', tracing.tensor_args(x=x)
        ) as tr:
            out = _stft_program(
                xj, self._window, tables, self.frame, self.hop,
                n_frames, spec, self.fft_n, self.log_eps,
                complex_out=self.mode == 'complex',
            )
            if tr:
                tr.result = out[0] if self.mode == 'complex' else out
        if self.mode == 'complex':
            re, im = out
            if not batched:
                re, im = re[0], im[0]
            return Tensor._from_planar(Planar(re, im, tuple(re.shape)))
        return Tensor._from_jax(out if batched else out[0])


def spectrogram(x: Tensor, frame: int = 1024, hop: int = 256, **kw) -> Tensor:
    return STFT(frame=frame, hop=hop, **kw)(x)


@partial(
    jax.jit,
    static_argnames=('frame', 'hop', 'n_frames', 'spec', 'fft_n', 'out_n'),
)
def _istft_program(zre, zim, window, inv_wsq, tables, frame, hop, n_frames,
                   spec, fft_n, out_n):
    """batched irfft -> synthesis window -> overlap-add -> multiply by the
    precomputed 1/sum(w^2) (exact weighted-least-squares reconstruction
    wherever the window coverage is nonzero). One device dispatch.
    ``zre``/``zim`` are (b, n_frames, bins).

    When hop divides frame the overlap-add runs as frame/hop dense
    shifted slice-adds (pure vector adds XLA fuses), not a scatter. The
    1/sum(w^2) denominator depends only on (window, hop, n_frames), so it
    is computed host-side in f64 and baked as a constant."""
    b = zre.shape[0]
    z = jax.lax.complex(zre, zim).reshape(b * n_frames, -1)
    frames = fft_core.irfft_batched(z, spec, tables, fft_n)[:, :frame]
    frames = frames.reshape(b, n_frames, frame) * window[None, None, :]
    if frame % hop == 0:
        k = frame // hop
        y = jnp.zeros((b, out_n), frames.dtype)
        flat_len = n_frames * hop
        for c in range(k):
            part = frames[:, :, c * hop : (c + 1) * hop].reshape(b, -1)
            y = y.at[:, c * hop : c * hop + flat_len].add(part)
    else:
        pos = (
            jnp.arange(n_frames)[:, None] * hop + jnp.arange(frame)[None, :]
        ).reshape(-1)
        y = jnp.zeros((b, out_n), frames.dtype).at[:, pos].add(
            frames.reshape(b, -1)
        )
    return y * inv_wsq[None, :]


class ISTFT:
    """Inverse STFT: reconstruct the signal from a mode='complex'
    spectrogram by windowed overlap-add.

    Uses the same window as analysis (weighted least squares synthesis:
    each sample is sum(w·frame)/sum(w²)), so ``ISTFT(...)(STFT(...,
    mode='complex')(x))`` reproduces ``x`` exactly wherever the window
    coverage is nonzero — for a hann window, everywhere except the first
    and last ~frame samples.
    """

    def __init__(self, frame: int = 1024, hop: int = 256, window='hann'):
        self.frame = frame
        self.hop = hop
        self.fft_n = fft_plan.next_pow2(frame)
        self._window_np = _make_window(window, frame)
        self._window = jnp.asarray(self._window_np)
        self._inv_wsq_cache: dict = {}

    def _inv_wsq(self, n_frames: int, span: int) -> np.ndarray:
        """1 / sum-of-squared-windows at each output sample — depends only
        on (window, hop, n_frames), so computed host-side in f64 once per
        spectrogram length and baked into the program as a constant."""
        got = self._inv_wsq_cache.get(n_frames)
        if got is None:
            w2 = (self._window_np.astype(np.float64)) ** 2
            wsq = np.zeros(span, np.float64)
            for i in range(0, n_frames * self.hop, self.hop):
                wsq[i : i + self.frame] += w2
            tiny = float(np.finfo(np.float32).tiny)
            got = (1.0 / np.maximum(wsq, tiny)).astype(np.float32)
            self._inv_wsq_cache[n_frames] = got
        return got

    def __call__(self, z: Tensor, length: Optional[int] = None) -> Tensor:
        """z: (n_frames, fft_n//2+1) c32 (or with a leading batch dim)
        -> (length,) / (batch, length) f32 signal. ``length`` defaults to
        the full span (n_frames-1)*hop + frame."""
        if z.n_dim not in (2, 3):
            raise RuntimeError(
                f'expected a 2-D or 3-D spectrogram, got {z.n_dim}-D'
            )
        batched = z.n_dim == 3
        n_frames, n_freq = z.shape[-2], z.shape[-1]
        if n_freq != self.fft_n // 2 + 1:
            raise RuntimeError(
                f'spectrogram has {n_freq} bins, expected {self.fft_n // 2 + 1}'
            )
        span = (n_frames - 1) * self.hop + self.frame
        length = span if length is None else length
        if length > span:
            raise RuntimeError(
                f'length {length} exceeds the frame span {span}'
            )
        pp = z._planar
        if pp is not None:
            zre, zim = pp.re, pp.im
        else:
            zj = z.jax
            zre, zim = jnp.real(zj), jnp.imag(zj)
        if not batched:
            zre, zim = zre[None], zim[None]
        spec, tables = fft_plan.get_plan(self.fft_n, 'real', np.complex64)
        with tracing.trace_op(
            'istft', 'op;pipeline', tracing.tensor_args(z=z)
        ) as tr:
            out = _istft_program(
                zre, zim, self._window, self._inv_wsq(n_frames, span),
                tables, self.frame, self.hop, n_frames, spec, self.fft_n,
                span,
            )
            if tr:
                tr.result = out
        out = out[:, :length]
        return Tensor._from_jax(out if batched else out[0])
