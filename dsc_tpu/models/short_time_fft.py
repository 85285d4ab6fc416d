"""scipy.signal.ShortTimeFFT parity class.

The reference framework has no time-frequency class (its closest surface
is the FFT family, reference dsc.h:384-424); this module belongs to the
model tier where scipy.signal is the executable spec (docs/PARITY.md).
Division of labor follows the tier convention:

- Host f64 NumPy owns every piece of design-time math: window
  validation, the canonical dual window, scaling factors, and all
  slice/border index arithmetic (``p_min``/``k_max``/border methods are
  O(m_num) window scans run once and cached).
- The hot path — slicing the signal into overlapping frames, per-frame
  detrending, windowing, the phase-shift roll and the batched FFT over
  every slice — runs as ONE jitted XLA program per call on the dsc
  planar FFT engine when ``mfft`` is a power of two. Any other ``mfft``
  routes the framed signal through a pre-planned Bluestein CZT
  (models/czt.py), so there is no transform-length cliff.
- The inverse is the same shape backwards: one program for batched
  inverse FFTs, the dual-window multiply and a dense shifted-slice
  overlap-add (no scatter when ``hop`` divides ``m_num``).

This class raises ``ValueError`` on bad parameters, mirroring scipy
exactly (the functional dsc models raise RuntimeError per the dsc
convention; a drop-in class keeps the oracle's exception contract).
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
from ..tensor import Tensor, from_numpy
from ..windows import design_window
from .psd import _detrend_segs
from .stft import _frame_dense
from .stft_scipy import _overlap_add_diag

_FFT_MODES = ('twosided', 'centered', 'onesided', 'onesided2X')
# padding name -> (jnp.pad mode, extra kwargs as a hashable tuple)
_PADDINGS = {
    'zeros': ('constant', ()),
    'edge': ('edge', ()),
    'even': ('reflect', ()),
    'odd': ('reflect', (('reflect_type', 'odd'),)),
}


def _calc_dual_canonical_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical (minimal-L2) dual window; raises ValueError when the
    frame operator is singular (scipy _calc_dual_canonical_window)."""
    if hop > len(win):
        raise ValueError(f'hop={hop} is larger than window length '
                         f'{len(win)} => STFT not invertible!')
    if issubclass(win.dtype.type, np.integer):
        raise ValueError('Parameter win cannot be of integer type '
                         '=> STFT not invertible!')
    dd = _overlap_add_diag(win.real ** 2 + win.imag ** 2, hop)
    if not np.all(dd >= np.finfo(win.dtype).resolution * dd.max()):
        raise ValueError('Short-time Fourier Transform not invertible!')
    return win / dd


def _as_batched_planar(x, name: str, axis: int = -1):
    """Tensor | array-like -> ((b, n) f32 re, (b, n) f32 im | None,
    leading shape after ``axis`` is moved last). Real input keeps
    im=None so the real-input rfft path stays planar-free."""
    if not isinstance(x, Tensor):
        x = from_numpy(np.asarray(x))
    if x.n_dim > 3:
        raise ValueError(f'{name}: at most 3-D input (rank-4 Tensor cap '
                         'with the added frequency axis)')
    if not -x.n_dim <= axis < x.n_dim:
        raise ValueError(f'{name}: axis {axis} out of range for '
                         f'{x.n_dim}-D input')
    if x.dtype.is_complex:
        pp = x._planar
        if pp is not None:
            xr, xi = pp.re, pp.im
        else:
            xj = x.jax
            xr, xi = jnp.real(xj), jnp.imag(xj)
    else:
        xr, xi = x.jax, None
    xr = xr.astype(jnp.float32)
    if axis % xr.ndim != xr.ndim - 1:
        xr = jnp.moveaxis(xr, axis, -1)
        if xi is not None:
            xi = jnp.moveaxis(xi, axis, -1)
    lead = tuple(xr.shape[:-1])
    xr = xr.reshape(-1, xr.shape[-1])
    if xi is not None:
        xi = xi.astype(jnp.float32).reshape(xr.shape)
    return xr, xi, lead


def _cmul(ar, ai, br, bi):
    """(ar + i*ai) * (br + i*bi) with None meaning a zero plane."""
    if ai is None and bi is None:
        return ar * br, None
    if ai is None:
        return ar * br, ar * bi
    if bi is None:
        return ar * br, ai * br
    return ar * br - ai * bi, ar * bi + ai * br


@partial(
    jax.jit,
    static_argnames=('geom', 'pad', 'm_num', 'hop', 'q_num', 'detr',
                     'mfft', 'p_s', 'spec', 'mode', 'fac', 'want_frames'),
)
def _stft_program(xr, xi, win_r, win_i, tables, geom, pad, m_num, hop,
                  q_num, detr, mfft, p_s, spec, mode, fac, want_frames):
    """(b, n) planar -> (b, f_pts, q_num) planar spectrum, or — for the
    non-pow2 CZT route (want_frames) — the windowed (b*q_num, mfft)
    frames. Slice extraction, boundary padding, detrend, windowing,
    phase roll and the batched FFT are one XLA program."""
    i0, i1, pl, pr = geom
    pad_mode, pad_kw = pad

    def prep(p):
        p = p[:, i0:i1]
        if pl or pr:
            if pad_mode == 'constant':
                p = jnp.pad(p, ((0, 0), (pl, pr)))
            else:
                p = jnp.pad(p, ((0, 0), (pl, pr)), mode=pad_mode,
                            **dict(pad_kw))
        segs = _frame_dense(p, m_num, hop, q_num)
        return _detrend_segs(segs, m_num, detr)

    sr = prep(xr)
    si = prep(xi) if xi is not None else None
    # scipy windows with win.conj()
    fr, fi = _cmul(sr, si, win_r[None, None, :],
                   None if win_i is None else -win_i[None, None, :])

    def finish(p):
        p = p.reshape(-1, m_num)
        if m_num != mfft:
            p = jnp.pad(p, ((0, 0), (0, mfft - m_num)))
        if p_s:
            p = jnp.roll(p, -p_s, axis=-1)
        return p

    fr = finish(fr)
    fi = finish(fi) if fi is not None else None
    if want_frames:
        return fr, (jnp.zeros_like(fr) if fi is None else fi)
    if mode in ('onesided', 'onesided2X'):
        zr, zi = fft_core.rfft_batched_p(fr, spec, tables, mfft)
        if mode == 'onesided2X':
            # mfft is even on this (pow2) path: the last bin is unpaired
            vec = jnp.ones((zr.shape[-1],), zr.dtype).at[1:-1].set(fac)
            zr, zi = zr * vec, zi * vec
    else:
        zr, zi = fft_core.fft_batched_p(
            fr, jnp.zeros_like(fr) if fi is None else fi, spec, tables,
            False)
        if mode == 'centered':
            zr = jnp.roll(zr, mfft // 2, axis=-1)
            zi = jnp.roll(zi, mfft // 2, axis=-1)
    b = xr.shape[0]
    zr = jnp.swapaxes(zr.reshape(b, q_num, -1), 1, 2)
    zi = jnp.swapaxes(zi.reshape(b, q_num, -1), 1, 2)
    return zr, zi


@partial(
    jax.jit,
    static_argnames=('mfft', 'm_num', 'hop', 'q_num', 'spec', 'mode',
                     'p_s', 'fac', 'off', 'buf_n', 'lpad', 'out_n'),
)
def _istft_program(zr, zi, dwin_r, dwin_i, tables, mfft, m_num, hop,
                   q_num, spec, mode, p_s, fac, off, buf_n, lpad, out_n):
    """(b, f_pts, q_num) planar spectrum -> (b, out_n) signal planar.
    Batched inverse FFT, dual-window multiply and a dense shifted-slice
    overlap-add (frame q lands at sample off + q*hop of a margin-padded
    buffer; the margins absorb scipy's k0/k1 edge clipping)."""
    b = zr.shape[0]
    zr = jnp.swapaxes(zr, 1, 2).reshape(b * q_num, -1)
    zi = jnp.swapaxes(zi, 1, 2).reshape(b * q_num, -1)
    if mode in ('onesided', 'onesided2X'):
        if mode == 'onesided2X':
            vec = jnp.ones((zr.shape[-1],), zr.dtype).at[1:-1].set(
                np.float32(1.0 / fac))
            zr, zi = zr * vec, zi * vec
        fr = fft_core.irfft_batched_p(zr, zi, spec, tables, mfft)
        fi = None
    else:
        if mode == 'centered':  # ifftshift
            zr = jnp.roll(zr, -(mfft // 2), axis=-1)
            zi = jnp.roll(zi, -(mfft // 2), axis=-1)
        fr, fi = fft_core.fft_batched_p(zr, zi, spec, tables, True)

    def crop(p):
        if p_s:
            p = jnp.roll(p, p_s, axis=-1)
        return p[:, :m_num].reshape(b, q_num, m_num)

    fr = crop(fr)
    fi = crop(fi) if fi is not None else None
    fr, fi = _cmul(fr, fi, dwin_r[None, None, :],
                   None if dwin_i is None else dwin_i[None, None, :])

    def ola(p):
        y = jnp.zeros((b, buf_n), p.dtype)
        if m_num % hop == 0:
            flat = q_num * hop
            for c in range(m_num // hop):
                part = p[:, :, c * hop: (c + 1) * hop].reshape(b, -1)
                s = off + c * hop
                y = y.at[:, s: s + flat].add(part)
        else:
            pos = (off + jnp.arange(q_num)[:, None] * hop
                   + jnp.arange(m_num)[None, :]).reshape(-1)
            y = y.at[:, pos].add(p.reshape(b, -1))
        return y[:, lpad: lpad + out_n]

    return ola(fr), (None if fi is None else ola(fi))


class ShortTimeFFT:
    """Short-time FFT with scipy.signal.ShortTimeFFT semantics: a
    sliding ``win`` advancing ``hop`` samples per slice, FFT length
    ``mfft`` (any length — powers of two ride the planar FFT engine,
    everything else the Bluestein CZT), with the zeroth slice centered
    at sample 0. See the scipy class for the full parameter contract;
    every property/method mirrors it (oracle: tests/test_short_time_fft
    .py). Signals and spectra are dsc Tensors (array-likes accepted);
    compute is f32/c32 on device, design math f64 on host."""

    def __init__(self, win: np.ndarray, hop: int, fs: float, *,
                 fft_mode: str = 'onesided', mfft: Optional[int] = None,
                 dual_win: Optional[np.ndarray] = None,
                 scale_to: Optional[str] = None,
                 phase_shift: Optional[int] = 0):
        win = win.numpy().copy() if isinstance(win, Tensor) \
            else np.asarray(win)
        if not (win.ndim == 1 and win.size > 0):
            raise ValueError(f'Parameter win must be 1d, but {win.shape=}!')
        if not np.all(np.isfinite(win)):
            raise ValueError('Parameter win must have finite entries!')
        if not (hop >= 1 and isinstance(hop, (int, np.integer))):
            raise ValueError(f'Parameter {hop=} is not an integer >= 1!')
        if not np.iscomplexobj(win):
            win = win.astype(np.float64)
        self._win, self._hop = win, int(hop)
        self.fs = fs
        self._scaling: Optional[str] = None
        self._fac_mag = self._fac_psd = None
        self._pre_pad_cache = None
        self._post_pad_cache = (None, None)
        self._lower_border_cache = None
        self._upper_border_cache = (None, None)
        self._czt_cache = (None, None)
        self.mfft = len(win) if mfft is None else mfft
        if dual_win is not None:
            dual_win = np.asarray(dual_win)
            if dual_win.shape != win.shape:
                raise ValueError(f'{dual_win.shape=} must equal '
                                 f'{win.shape=}!')
            if not np.all(np.isfinite(dual_win)):
                raise ValueError('Parameter dual_win must be a finite '
                                 'array!')
        self._dual_win = dual_win  # set before scaling
        if scale_to is not None:  # set before fft_mode
            self.scale_to(scale_to)
        self.fft_mode, self.phase_shift = fft_mode, phase_shift

    # -- alternate constructors -----------------------------------------
    @classmethod
    def from_dual(cls, dual_win: np.ndarray, hop: int, fs: float, *,
                  fft_mode: str = 'onesided', mfft: Optional[int] = None,
                  scale_to: Optional[str] = None,
                  phase_shift: Optional[int] = 0) -> 'ShortTimeFFT':
        """Instantiate from the dual window: ``win`` is its canonical
        dual (the involution property of the canonical dual)."""
        dual_win = np.asarray(dual_win)
        win = _calc_dual_canonical_window(dual_win, hop)
        return cls(win=win, hop=hop, fs=fs, fft_mode=fft_mode, mfft=mfft,
                   dual_win=dual_win, scale_to=scale_to,
                   phase_shift=phase_shift)

    @classmethod
    def from_window(cls, win_param, fs: float, nperseg: int,
                    noverlap: int, *, symmetric_win: bool = False,
                    fft_mode: str = 'onesided', mfft: Optional[int] = None,
                    scale_to: Optional[str] = None,
                    phase_shift: Optional[int] = 0) -> 'ShortTimeFFT':
        """Instantiate via the get_window designer (periodic by default,
        ``symmetric_win=True`` for the symmetric variant)."""
        win = design_window(win_param, nperseg, fftbins=not symmetric_win)
        return cls(win, hop=nperseg - noverlap, fs=fs, fft_mode=fft_mode,
                   mfft=mfft, scale_to=scale_to, phase_shift=phase_shift)

    @classmethod
    def from_win_equals_dual(cls, desired_win: np.ndarray, hop: int,
                             fs: float, *, fft_mode: str = 'onesided',
                             mfft: Optional[int] = None,
                             scale_to: Optional[str] = None,
                             phase_shift: Optional[int] = 0) \
            -> 'ShortTimeFFT':
        """Window equal to its own dual (up to scaling), closest to
        ``desired_win`` in least squares: normalize each of the ``hop``
        comb subsequences to unit L2 norm. ``scale_to='unitary'`` makes
        the STFT a unitary map (win / sqrt(mfft), dual * sqrt(mfft))."""
        desired_win = np.asarray(desired_win)
        if not (desired_win.ndim == 1 and desired_win.size > 0):
            raise ValueError('Parameter desired_win is not 1d, but '
                             f'{desired_win.shape=}!')
        if issubclass(desired_win.dtype.type, np.integer):
            raise ValueError('Parameter desired_win cannot be of integer '
                             'type => cast to float | complex')
        if not np.all(np.isfinite(desired_win)):
            raise ValueError('Parameter desired_win must have finite '
                             'entries!')
        if not (1 <= hop <= len(desired_win)
                and isinstance(hop, (int, np.integer))):
            raise ValueError(f'Parameter {hop=} is not an integer between'
                             f' 1 and {len(desired_win)=}!')
        if scale_to not in ('magnitude', 'psd', 'unitary', None):
            raise ValueError(f"Parameter {scale_to=} not in "
                             "['magnitude', 'psd', 'unitary', None]!")
        mfft_ = len(desired_win) if mfft is None else mfft
        s_fac = np.sqrt(mfft_) if scale_to == 'unitary' else 1
        win = desired_win.astype(
            np.complex128 if np.iscomplexobj(desired_win) else np.float64)
        rel_res = np.finfo(win.dtype).resolution * np.max(win.real)
        for m in range(hop):
            a = np.linalg.norm(desired_win[m::hop])
            if not a > rel_res:
                raise ValueError('Parameter desired_win does not have a '
                                 f'valid STFT dual window for {hop=}!')
            win[m::hop] /= a
        sft = cls(win=win / s_fac, hop=hop, fs=fs, fft_mode=fft_mode,
                  mfft=mfft_, dual_win=win * s_fac,
                  phase_shift=phase_shift,
                  scale_to=None if scale_to == 'unitary' else scale_to)
        if scale_to == 'unitary':
            sft._scaling = 'unitary'
        return sft

    # -- simple attributes -----------------------------------------------
    @property
    def win(self) -> np.ndarray:
        """Window as a host f64/c128 array (read via copy to mutate)."""
        return self._win

    @property
    def hop(self) -> int:
        return self._hop

    @property
    def fs(self) -> float:
        return self._fs

    @fs.setter
    def fs(self, v: float):
        if not v > 0:
            raise ValueError(f'Sampling frequency fs={v} must be positive!')
        self._fs = v

    @property
    def T(self) -> float:
        return 1.0 / self._fs

    @T.setter
    def T(self, v: float):
        if not v > 0:
            raise ValueError(f'Sampling interval T={v} must be positive!')
        self._fs = 1.0 / v

    @property
    def fft_mode(self) -> str:
        return self._fft_mode

    @fft_mode.setter
    def fft_mode(self, t: str):
        if t not in _FFT_MODES:
            raise ValueError(f"fft_mode='{t}' not in {_FFT_MODES}!")
        if t in ('onesided', 'onesided2X') and np.iscomplexobj(self.win):
            raise ValueError(f"One-sided spectra, i.e., fft_mode='{t}', "
                             'are not allowed for complex-valued windows!')
        if t == 'onesided2X' and self.scaling is None:
            raise ValueError(f"For scaling is None, fft_mode='{t}' is "
                             "invalid! Do scale_to('psd') or "
                             "scale_to('magnitude')!")
        self._fft_mode = t

    @property
    def mfft(self) -> int:
        return self._mfft

    @mfft.setter
    def mfft(self, n_: int):
        if not n_ >= self.m_num:
            raise ValueError(f'Attribute mfft={n_} needs to be at least '
                             f'the window length m_num={self.m_num}!')
        self._mfft = int(n_)

    @property
    def scaling(self) -> Optional[str]:
        return self._scaling

    def scale_to(self, scaling: str):
        """Scale window (and dual) in place so every STFT column is a
        'magnitude' or 'psd' spectrum."""
        if scaling not in ('magnitude', 'psd'):
            raise ValueError(f"{scaling=} not in {{'magnitude', 'psd'}}!")
        if self._scaling == scaling:
            return
        s_fac = self.fac_psd if scaling == 'psd' else self.fac_magnitude
        self._win = self._win * s_fac
        if self._dual_win is not None:
            self._dual_win = self._dual_win / s_fac
        self._fac_mag, self._fac_psd = None, None
        self._scaling = scaling

    @property
    def phase_shift(self) -> Optional[int]:
        return self._phase_shift

    @phase_shift.setter
    def phase_shift(self, v: Optional[int]):
        if v is None:
            self._phase_shift = None
            return
        if not isinstance(v, (int, np.integer)):
            raise ValueError(f'phase_shift={v} has the unit samples and '
                             'hence must be an int or None!')
        if not -self.mfft < v < self.mfft:
            raise ValueError(f'-mfft < phase_shift < mfft does not hold '
                             f'for mfft={self.mfft}, phase_shift={v}!')
        self._phase_shift = int(v)

    # -- scaling factors ---------------------------------------------------
    @property
    def fac_magnitude(self) -> float:
        """Factor scaling STFT values to a magnitude spectrum."""
        if self.scaling == 'magnitude':
            return 1
        if self._fac_mag is None:
            self._fac_mag = 1 / abs(np.sum(self.win))
        return self._fac_mag

    @property
    def fac_psd(self) -> float:
        """Factor scaling STFT values to a PSD spectrum."""
        if self.scaling == 'psd':
            return 1
        if self._fac_psd is None:
            self._fac_psd = 1 / np.sqrt(
                np.sum(self.win.real ** 2 + self.win.imag ** 2) / self.T)
        return self._fac_psd

    # -- window geometry -----------------------------------------------
    @property
    def m_num(self) -> int:
        return len(self._win)

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    def _w2(self) -> np.ndarray:
        return self._win.real ** 2 + self._win.imag ** 2

    def _pre_padding(self):
        """(k_min, p_min): shift the window left until its overlap with
        t >= 0 vanishes (zero-aware: trailing window zeros don't count)."""
        if self._pre_pad_cache is not None:
            return self._pre_pad_cache
        w2 = self._w2()
        n0 = -self.m_num_mid
        for p_, n_ in enumerate(range(n0, n0 - self.m_num - 1, -self.hop)):
            n_next = n_ - self.hop
            if n_next + self.m_num <= 0 or not w2[n_next:].any():
                self._pre_pad_cache = (n_, -p_)
                return self._pre_pad_cache
        raise RuntimeError('unreachable: window has no nonzero sample')

    @property
    def k_min(self) -> int:
        """Leftmost sample index touched by the lowest slice (<= 0)."""
        return self._pre_padding()[0]

    @property
    def p_min(self) -> int:
        """Smallest slice index with window overlap into t >= 0 (<= 0)."""
        return self._pre_padding()[1]

    def _post_padding(self, n: int):
        """(k_max, p_max) for an n-sample signal: shift the window right
        until the overlap for t < t[n] vanishes."""
        if not n >= (m2p := self.m_num - self.m_num_mid):
            raise ValueError(f'Parameter n must be >= ceil(m_num/2) = '
                             f'{m2p}!')
        if self._post_pad_cache[0] == n:
            return self._post_pad_cache[1]
        w2 = self._w2()
        q1 = n // self.hop
        k1 = q1 * self.hop - self.m_num_mid
        for q_, k_ in enumerate(range(k1, n + self.m_num, self.hop),
                                start=q1):
            n_next = k_ + self.hop
            if n_next >= n or not w2[:n - n_next].any():
                self._post_pad_cache = (n, (k_ + self.m_num, q_ + 1))
                return self._post_pad_cache[1]
        raise RuntimeError('unreachable: window has no nonzero sample')

    def k_max(self, n: int) -> int:
        """First sample index after the signal end not touched by any
        time slice."""
        return self._post_padding(n)[0]

    def p_max(self, n: int) -> int:
        """Index of the first non-overlapping upper time slice."""
        return self._post_padding(n)[1]

    def p_num(self, n: int) -> int:
        """Number of time slices: p_max(n) - p_min."""
        return self.p_max(n) - self.p_min

    @property
    def lower_border_end(self):
        """(sample, slice) indices where pre-padding effects end."""
        if self._lower_border_cache is not None:
            return self._lower_border_cache
        w2 = self._w2()
        m0 = int(np.flatnonzero(w2)[0])
        k0 = -self.m_num_mid + m0
        for q_, k_ in enumerate(range(k0, self.hop + 1, self.hop)):
            if k_ + self.hop >= 0:
                self._lower_border_cache = (k_ + self.m_num, q_ + 1)
                return self._lower_border_cache
        self._lower_border_cache = (0, max(self.p_min, 0))
        return self._lower_border_cache

    def upper_border_begin(self, n: int):
        """(sample, slice) indices where post-padding effects begin."""
        if not n >= (m2p := self.m_num - self.m_num_mid):
            raise ValueError(f'Parameter n must be >= ceil(m_num/2) = '
                             f'{m2p}!')
        if self._upper_border_cache[0] == n:
            return self._upper_border_cache[1]
        w2 = self._w2()
        q2 = n // self.hop + 1
        q1 = max((n - self.m_num) // self.hop - 1, -1)
        for q_ in range(q2, q1, -1):
            k_ = q_ * self.hop + (self.m_num - self.m_num_mid)
            if k_ <= n or not w2[n - k_:].any():
                ret = ((q_ + 1) * self.hop - self.m_num_mid, q_ + 1)
                self._upper_border_cache = (n, ret)
                return ret
        raise RuntimeError('unreachable: window has no nonzero sample')

    # -- time/frequency axes ---------------------------------------------
    @property
    def delta_t(self) -> float:
        """Time increment between slices: T * hop."""
        return self.T * self.hop

    @property
    def delta_f(self) -> float:
        """Width of the frequency bins: 1 / (mfft * T)."""
        return 1.0 / (self.mfft * self.T)

    @property
    def f_pts(self) -> int:
        """Number of points along the frequency axis."""
        return self.mfft // 2 + 1 if self.onesided_fft else self.mfft

    @property
    def onesided_fft(self) -> bool:
        return self.fft_mode in ('onesided', 'onesided2X')

    @property
    def f(self) -> np.ndarray:
        """Frequency values of the STFT (host f64 array)."""
        if self.onesided_fft:
            return np.fft.rfftfreq(self.mfft, self.T)
        freqs = np.fft.fftfreq(self.mfft, self.T)
        return np.fft.fftshift(freqs) if self.fft_mode == 'centered' \
            else freqs

    def p_range(self, n: int, p0: Optional[int] = None,
                p1: Optional[int] = None):
        """Validated slice index range [p0, p1) for an n-sample signal."""
        p_max = self.p_max(n)
        p0_ = self.p_min if p0 is None else p0
        p1_ = p_max if p1 is None else p1
        if not self.p_min <= p0_ < p1_ <= p_max:
            raise ValueError(f'Invalid Parameter {p0=}, {p1=}, i.e., '
                             f'{self.p_min=} <= p0 < p1 <= {p_max=} does '
                             f'not hold for signal length {n=}!')
        return p0_, p1_

    def t(self, n: int, p0: Optional[int] = None, p1: Optional[int] = None,
          k_offset: int = 0) -> np.ndarray:
        """Slice center times for an n-sample signal (host f64 array)."""
        if not (n > 0 and isinstance(n, (int, np.integer))):
            raise ValueError(f'Parameter {n=} is not a positive integer!')
        p0, p1 = self.p_range(n, p0, p1)
        return np.arange(p0, p1) * self.delta_t + k_offset * self.T

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        """Nearest sample index k_p <= k (or >= k) landing on a slice
        center grid point (a multiple of hop)."""
        p_q, remainder = divmod(k, self.hop)
        if remainder == 0:
            return k
        return p_q * self.hop if left else (p_q + 1) * self.hop

    def extent(self, n: int, axes_seq: str = 'tf',
               center_bins: bool = False):
        """(t0, t1, f0, f1) bounding box for imshow-style plotting."""
        if axes_seq not in ('tf', 'ft'):
            raise ValueError(f"Parameter {axes_seq=} not in ['tf', 'ft']!")
        if self.onesided_fft:
            q0, q1 = 0, self.f_pts
        elif self.fft_mode == 'centered':
            q0 = -(self.mfft // 2)
            q1 = self.mfft // 2 if self.mfft % 2 == 0 \
                else self.mfft // 2 + 1
        else:
            raise ValueError(f'Attribute fft_mode={self.fft_mode} must be '
                             "in ['centered', 'onesided', 'onesided2X']")
        p0, p1 = self.p_min, self.p_max(n)
        if center_bins:
            t0, t1 = self.delta_t * (p0 - 0.5), self.delta_t * (p1 - 0.5)
            f0, f1 = self.delta_f * (q0 - 0.5), self.delta_f * (q1 - 0.5)
        else:
            t0, t1 = self.delta_t * p0, self.delta_t * p1
            f0, f1 = self.delta_f * q0, self.delta_f * q1
        return (t0, t1, f0, f1) if axes_seq == 'tf' else (f0, f1, t0, t1)

    # -- dual window ----------------------------------------------------
    @property
    def dual_win(self) -> np.ndarray:
        """Dual window (canonical dual by default, computed lazily)."""
        if self._dual_win is None:
            self._dual_win = _calc_dual_canonical_window(self.win, self.hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        """True when the canonical dual window exists."""
        try:
            return len(self.dual_win) > 0
        except ValueError:
            return False

    # -- transform plumbing ----------------------------------------------
    def _is_pow2(self) -> bool:
        return self.mfft & (self.mfft - 1) == 0

    def _plan(self, real: bool):
        kind = 'real' if real else 'complex'
        return fft_plan.get_plan(self.mfft, kind, np.complex64)

    def _czt_plan(self):
        """Cached length-mfft unit-circle CZT (the exact any-length DFT)."""
        if self._czt_cache[0] != self.mfft:
            from .czt import CZT
            self._czt_cache = (self.mfft, CZT(self.mfft))
        return self._czt_cache[1]

    def _win_planes(self, w: np.ndarray):
        wr = jnp.asarray(w.real.astype(np.float32))
        wi = jnp.asarray(w.imag.astype(np.float32)) \
            if np.iscomplexobj(w) else None
        return wr, wi

    def _p_s(self) -> Optional[int]:
        if self.phase_shift is None:
            return None
        return (self.phase_shift + self.m_num_mid) % self.m_num

    def _x2_fac(self) -> float:
        return float(np.sqrt(2)) if self.scaling == 'psd' else 2.0

    # -- forward transforms ----------------------------------------------
    def stft(self, x, p0: Optional[int] = None, p1: Optional[int] = None,
             *, k_offset: int = 0, padding: str = 'zeros',
             axis: int = -1) -> Tensor:
        """Short-time Fourier transform of ``x`` (Tensor or array-like):
        a complex Tensor with the frequency axis where ``axis`` was and
        the p1-p0 time slices last."""
        return self.stft_detrend(x, None, p0, p1, k_offset=k_offset,
                                 padding=padding, axis=axis)

    def stft_detrend(self, x, detr, p0: Optional[int] = None,
                     p1: Optional[int] = None, *, k_offset: int = 0,
                     padding: str = 'zeros', axis: int = -1) -> Tensor:
        """STFT with a per-slice trend removed first. ``detr`` is
        'constant' | 'linear' (fused into the device program) | a host
        callable applied slice-wise (host framing path) | None."""
        if padding not in _PADDINGS:
            raise ValueError(f'Parameter padding={padding!r} not in '
                             f'{tuple(_PADDINGS)}!')
        callable_detr = callable(detr)
        if not (detr is None or callable_detr
                or detr in ('constant', 'linear')):
            raise ValueError(f'Parameter {detr=} is not a str, function '
                             'or None!')
        xr, xi, lead = _as_batched_planar(x, 'stft', axis)
        if self.onesided_fft and xi is not None:
            raise ValueError('Complex-valued x not allowed for '
                             f'fft_mode={self.fft_mode!r}! Set fft_mode '
                             "to 'twosided' or 'centered'.")
        n = xr.shape[-1]
        if not n >= (m2p := self.m_num - self.m_num_mid):
            raise ValueError(f'Signal length n={n} of axis={axis} must '
                             f'be >= ceil(m_num/2) = {m2p}!')
        p0, p1 = self.p_range(n, p0, p1)
        q_num = p1 - p0
        k0 = p0 * self.hop - self.m_num_mid + k_offset
        k1 = k0 + q_num * self.hop + self.m_num
        geom = (max(k0, 0), min(k1, n), -min(k0, 0), max(k1 - n, 0))
        hop_eff = self.hop
        if callable_detr:
            # pre-framed on host: consecutive m_num-blocks, re-framed
            # trivially on device with hop == m_num
            xr, xi = self._host_detrend_frames(xr, xi, detr, geom, q_num,
                                               padding)
            geom = (0, xr.shape[-1], 0, 0)
            hop_eff = self.m_num
            detr_key = 'none'
        else:
            detr_key = detr if detr else 'none'
        wr, wi = self._win_planes(self.win)
        pow2 = self._is_pow2()
        mode = self.fft_mode
        spec, tables = self._plan(self.onesided_fft) if pow2 \
            else ((), None)
        with tracing.trace_op('ShortTimeFFT.stft', 'op;pipeline',
                              tracing.tensor_args()) as tr:
            zr, zi = _stft_program(
                xr, xi, wr, wi, tables, geom, _PADDINGS[padding],
                self.m_num, hop_eff, q_num, detr_key, self.mfft,
                self._p_s(), spec, mode, np.float32(self._x2_fac()),
                not pow2)
            if not pow2:
                zr, zi = self._czt_post(zr, zi, xr.shape[0], q_num)
            if tr:
                tr.result = zr
        out_shape = lead + (self.f_pts, q_num)
        zr = zr.reshape(out_shape)
        zi = zi.reshape(out_shape)
        out = Tensor._from_planar(Planar(zr, zi, out_shape))
        return self._place_axes(out, lead, axis)

    def _host_detrend_frames(self, xr, xi, detr, geom, q_num, padding):
        """Host path for callable detrenders: frame in NumPy, apply the
        callable per slice (scipy passes each (..., m_num) slice), and
        hand back pre-framed planes flattened as (b, q_num*m_num) so the
        device program re-frames them trivially with hop == m_num."""
        mode, kw = _PADDINGS[padding]
        def one(plane):
            if plane is None:
                return None
            p = np.asarray(plane)
            i0, i1, pl, pr = geom
            p = p[:, i0:i1]
            if pl or pr:
                if mode == 'constant':
                    p = np.pad(p, ((0, 0), (pl, pr)))
                else:
                    p = np.pad(p, ((0, 0), (pl, pr)), mode=mode,
                               **dict(kw))
            frames = np.stack(
                [p[:, q * self.hop: q * self.hop + self.m_num]
                 for q in range(q_num)], axis=1)
            return frames
        fr, fi = one(xr), one(xi)
        if fi is None:
            fr = np.stack([detr(fr[:, q]) for q in range(q_num)], axis=1)
        else:
            z = fr + 1j * fi
            z = np.stack([detr(z[:, q]) for q in range(q_num)], axis=1)
            fr, fi = z.real, z.imag
        b = fr.shape[0]
        out_r = jnp.asarray(
            fr.reshape(b, -1).astype(np.float32))
        out_i = None if fi is None else jnp.asarray(
            fi.reshape(b, -1).astype(np.float32))
        return out_r, out_i

    def _czt_post(self, fr, fi, b, q_num):
        """Non-pow2 mfft: run the windowed frames (b*q, mfft) through the
        Bluestein CZT and apply the fft_mode post-processing."""
        frames = Tensor._from_planar(
            Planar(fr, fi, tuple(fr.shape)))
        z = self._czt_plan()(frames)
        pp = z._planar
        zr, zi = (pp.re, pp.im) if pp is not None \
            else (jnp.real(z.jax), jnp.imag(z.jax))
        mode, mfft = self.fft_mode, self.mfft
        if mode in ('onesided', 'onesided2X'):
            zr, zi = zr[:, :self.f_pts], zi[:, :self.f_pts]
            if mode == 'onesided2X':
                fac = self._x2_fac()
                hi = None if mfft % 2 else -1
                vec = np.ones(self.f_pts, np.float32)
                vec[1:hi] = fac
                zr, zi = zr * vec, zi * vec
        elif mode == 'centered':
            zr = jnp.roll(zr, mfft // 2, axis=-1)
            zi = jnp.roll(zi, mfft // 2, axis=-1)
        zr = jnp.swapaxes(zr.reshape(b, q_num, -1), 1, 2)
        zi = jnp.swapaxes(zi.reshape(b, q_num, -1), 1, 2)
        return zr, zi

    def _place_axes(self, out: Tensor, lead, axis: int) -> Tensor:
        """scipy output axis contract: frequency lands where the input
        axis was, time slices stay last."""
        nd = len(lead) + 1
        if nd == 1:
            return out
        axis = axis if axis >= 0 else axis + nd
        if axis == nd - 1:
            return out
        perm = list(range(len(lead) + 2))
        perm.insert(axis, perm.pop(len(lead)))
        from ..tensor import transpose
        return transpose(out, tuple(perm))

    def spectrogram(self, x, y=None, detr=None, *,
                    p0: Optional[int] = None, p1: Optional[int] = None,
                    k_offset: int = 0, padding: str = 'zeros',
                    axis: int = -1) -> Tensor:
        """|STFT|^2 of ``x`` (real Tensor), or the cross-spectrogram
        ``Sx * conj(Sy)`` when ``y`` is given (complex Tensor)."""
        sx = self.stft_detrend(x, detr, p0, p1, k_offset=k_offset,
                               padding=padding, axis=axis)
        px = sx._planar
        xr, xi = (px.re, px.im) if px is not None \
            else (jnp.real(sx.jax), jnp.imag(sx.jax))
        if y is None or y is x:
            return Tensor._from_jax(xr * xr + xi * xi)
        sy = self.stft_detrend(y, detr, p0, p1, k_offset=k_offset,
                               padding=padding, axis=axis)
        py = sy._planar
        yr, yi = (py.re, py.im) if py is not None \
            else (jnp.real(sy.jax), jnp.imag(sy.jax))
        rr, ri = _cmul(xr, xi, yr, -yi)
        return Tensor._from_planar(Planar(rr, ri, tuple(rr.shape)))

    # -- inverse ---------------------------------------------------------
    def istft(self, S, k0: int = 0, k1: Optional[int] = None, *,
              f_axis: int = -2, t_axis: int = -1) -> Tensor:
        """Inverse STFT of ``S`` (complex Tensor or array-like) over
        sample range [k0, k1); the first time slice is assumed to sit at
        ``p_min``. Real Tensor out for one-sided modes, complex else."""
        if not isinstance(S, Tensor):
            S = from_numpy(np.asarray(S, np.complex64))
        if f_axis == t_axis:
            raise ValueError(f'{f_axis=} may not be equal to {t_axis=}!')
        nd = S.n_dim
        shape = S.shape
        f_ax = f_axis + nd if f_axis < 0 else f_axis
        t_ax = t_axis + nd if t_axis < 0 else t_axis
        if shape[f_ax] != self.f_pts:
            raise ValueError(f'S.shape[f_axis]={shape[f_ax]} must be '
                             f'equal to f_pts={self.f_pts} ({shape=})!')
        n_min = self.m_num - self.m_num_mid
        if not shape[t_ax] >= (q_num_min := self.p_num(n_min)):
            raise ValueError(f'S.shape[t_axis]={shape[t_ax]} needs to '
                             f'have at least {q_num_min} slices '
                             f'({shape=})!')
        pp = S._planar
        if pp is not None:
            sr, si = pp.re, pp.im
        else:
            sj = S.jax
            sr, si = jnp.real(sj), jnp.imag(sj)
        if t_ax != nd - 1 or f_ax != nd - 2:
            sr = jnp.moveaxis(sr, (f_ax, t_ax), (-2, -1))
            si = jnp.moveaxis(si, (f_ax, t_ax), (-2, -1))
        lead = tuple(sr.shape[:-2])
        sr = sr.reshape((-1,) + sr.shape[-2:]).astype(jnp.float32)
        si = si.reshape(sr.shape).astype(jnp.float32)

        q_max = sr.shape[-1] + self.p_min
        k_max = (q_max - 1) * self.hop + self.m_num - self.m_num_mid
        k1 = k_max if k1 is None else k1
        if not self.k_min <= k0 < k1 <= k_max:
            raise ValueError(f'({self.k_min=}) <= ({k0=}) < ({k1=}) <= '
                             f'({k_max=}) is false!')
        if not (num_pts := k1 - k0) >= n_min:
            raise ValueError(f'({k1=}) - ({k0=}) = {num_pts} has to be '
                             f'at least half the window length {n_min}!')
        q0 = (k0 // self.hop + self.p_min if k0 >= 0
              else k0 // self.hop)
        q1 = min(self.p_max(k1), q_max)
        q_num = q1 - q0
        sr = sr[:, :, q0 - self.p_min: q1 - self.p_min]
        si = si[:, :, q0 - self.p_min: q1 - self.p_min]
        base = q0 * self.hop - self.m_num_mid - k0
        lpad = max(0, -base)
        off = base + lpad
        buf_n = off + (q_num - 1) * self.hop + self.m_num
        out_n = k1 - k0
        dwr, dwi = self._win_planes(self.dual_win)
        pow2 = self._is_pow2()
        onesided = self.onesided_fft
        if pow2:
            spec, tables = self._plan(onesided)
            with tracing.trace_op('ShortTimeFFT.istft', 'op;pipeline',
                                  tracing.tensor_args(S=S)) as tr:
                yr, yi = _istft_program(
                    sr, si, dwr, dwi, tables, self.mfft, self.m_num,
                    self.hop, q_num, spec, self.fft_mode, self._p_s(),
                    np.float32(self._x2_fac()), off, buf_n, lpad, out_n)
                if tr:
                    tr.result = yr
        else:
            yr, yi = self._czt_istft(sr, si, dwr, dwi, q_num, off, buf_n,
                                     lpad, out_n)
        if yi is None and not onesided:
            yi = jnp.zeros_like(yr)
        if lead:
            yr = yr.reshape(lead + (out_n,))
            yi = yi.reshape(lead + (out_n,)) if yi is not None else None
        else:
            yr = yr[0]
            yi = yi[0] if yi is not None else None
        out = Tensor._from_jax(yr) if yi is None else \
            Tensor._from_planar(Planar(yr, yi, tuple(yr.shape)))
        if out.n_dim > 1:
            nd_out = out.n_dim
            src = nd_out - 1
            dst = f_ax if f_ax < nd_out else t_ax
            if src != dst:
                perm = list(range(nd_out))
                perm.insert(dst, perm.pop(src))
                from ..tensor import transpose
                out = transpose(out, tuple(perm))
        return out

    def _czt_istft(self, sr, si, dwr, dwi, q_num, off, buf_n, lpad,
                   out_n):
        """Non-pow2 mfft inverse: IDFT_m(X) = conj(DFT_m(conj(X))) / m
        via the cached CZT plan, then the dual-window overlap-add."""
        b = sr.shape[0]
        mfft, m_num, hop = self.mfft, self.m_num, self.hop
        zr = jnp.swapaxes(sr, 1, 2).reshape(b * q_num, -1)
        zi = jnp.swapaxes(si, 1, 2).reshape(b * q_num, -1)
        mode = self.fft_mode
        if mode in ('onesided', 'onesided2X'):
            if mode == 'onesided2X':
                hi = None if mfft % 2 else -1
                vec = np.ones(self.f_pts, np.float32)
                vec[1:hi] = 1.0 / self._x2_fac()
                zr, zi = zr * vec, zi * vec
            # hermitian extension to the full mfft-bin spectrum (the
            # last bin mirrors only when mfft is odd)
            mirror = slice(self.f_pts - 2, 0, -1) if mfft % 2 == 0 \
                else slice(self.f_pts - 1, 0, -1)
            zr = jnp.concatenate([zr, zr[:, mirror]], axis=-1)
            zi = jnp.concatenate([zi, -zi[:, mirror]], axis=-1)
        elif mode == 'centered':
            zr = jnp.roll(zr, -(mfft // 2), axis=-1)
            zi = jnp.roll(zi, -(mfft // 2), axis=-1)
        spec_t = Tensor._from_planar(
            Planar(zr, -zi, tuple(zr.shape)))  # conj
        w = self._czt_plan()(spec_t)
        wp = w._planar
        wr, wi = (wp.re, wp.im) if wp is not None \
            else (jnp.real(w.jax), jnp.imag(w.jax))
        fr = wr * np.float32(1.0 / mfft)
        fi = -wi * np.float32(1.0 / mfft)  # conj back
        p_s = self._p_s()

        def crop(p):
            if p_s:
                p = jnp.roll(p, p_s, axis=-1)
            return p[:, :m_num].reshape(b, q_num, m_num)

        onesided = self.onesided_fft
        fr = crop(fr)
        fi = None if onesided else crop(fi)
        fr, fi = _cmul(fr, fi, dwr[None, None, :],
                       None if dwi is None else dwi[None, None, :])

        def ola(p):
            y = jnp.zeros((b, buf_n), p.dtype)
            if m_num % hop == 0:
                flat = q_num * hop
                for c in range(m_num // hop):
                    part = p[:, :, c * hop: (c + 1) * hop].reshape(b, -1)
                    s = off + c * hop
                    y = y.at[:, s: s + flat].add(part)
            else:
                pos = (off + jnp.arange(q_num)[:, None] * hop
                       + jnp.arange(m_num)[None, :]).reshape(-1)
                y = y.at[:, pos].add(p.reshape(b, -1))
            return y[:, lpad: lpad + out_n]

        return ola(fr), (None if fi is None else ola(fi))
