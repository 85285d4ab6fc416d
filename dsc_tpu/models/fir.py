"""Window-method FIR filter design (``firwin``) and Savitzky-Golay
smoothing (``savgol_coeffs`` / ``savgol_filter``).

scipy.signal.firwin semantics, computed with the PUBLIC dsc op surface
(``arange``/``sinc``/``cos``/``sum`` and the device window generators) —
the reference ships ``sinc`` and Bessel-I0 precisely because they are the
FIR-design primitives (dsc_ops.h:92-145, dsc.cpp:1624-1721); this module
is the pipeline the reference leaves as a user exercise. The taps come
back as a dsc Tensor ready to feed :class:`~dsc_tpu.models.OverlapSave` /
:class:`~dsc_tpu.models.FilterFFT`.

Design-time code: a handful of eager public-op dispatches on vectors of
``numtaps`` elements, not a hot path.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from ..dtype import Dtype
from ..tensor import Tensor, arange, cos, from_numpy, ones, sinc
from ..tensor import sum as dsc_sum
from ..windows import blackman, design_window, hamming, hanning, kaiser


def _design_window(window, numtaps: int, dtype: Dtype) -> Tensor:
    """Window spec -> dsc Tensor of length numtaps, generated on device
    for the common named windows and via ``windows.design_window``
    (scipy.signal.get_window names, SYMMETRIC variant — the firwin
    convention) for the rest. Accepts names, (name, *params) tuples,
    None/'rect', a Tensor, or any array-like."""
    if isinstance(window, Tensor):
        win = window
    elif window is None or window in ('rect', 'boxcar'):
        win = ones((numtaps,), dtype=dtype)
    elif isinstance(window, str):
        maker = {
            'hamming': hamming, 'hann': hanning, 'hanning': hanning,
            'blackman': blackman,
        }.get(window)
        if maker is not None:
            win = maker(numtaps, dtype=dtype)
        else:
            win = from_numpy(
                design_window(window, numtaps,
                              fftbins=False).astype(np.float32))
    elif isinstance(window, tuple) and len(window) == 2 and window[0] == 'kaiser':
        win = kaiser(numtaps, window[1], dtype=dtype)
    elif isinstance(window, tuple) and window and isinstance(window[0], str):
        win = from_numpy(
            design_window(window, numtaps, fftbins=False).astype(np.float32))
    else:
        win = from_numpy(np.asarray(window, dtype=np.float32))
    if win.shape != (numtaps,):
        raise RuntimeError(
            f'firwin: window has shape {win.shape}, expected ({numtaps},)'
        )
    return win


def firwin(
    numtaps: int,
    cutoff: Union[float, Sequence[float]],
    window='hamming',
    pass_zero: bool = True,
    scale: bool = True,
    fs: float = 2.0,
    dtype: Dtype = Dtype.F32,
) -> Tensor:
    """Design a linear-phase FIR filter by the window method
    (scipy.signal.firwin semantics). ``cutoff``: one or more band edges
    in the same units as ``fs`` (strictly inside (0, fs/2), increasing).
    ``pass_zero=True`` keeps DC (lowpass / bandstop); ``False`` rejects
    it (highpass / bandpass). Returns the (numtaps,) taps as a Tensor."""
    if numtaps < 1:
        raise RuntimeError(f'firwin: numtaps ({numtaps}) must be >= 1')
    cut = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) / (fs / 2.0)
    if cut.size == 0:
        raise RuntimeError('firwin: at least one cutoff frequency required')
    if np.any(cut <= 0) or np.any(cut >= 1):
        raise RuntimeError(
            'firwin: cutoff must lie strictly inside (0, fs/2)'
        )
    if cut.size > 1 and np.any(np.diff(cut) <= 0):
        raise RuntimeError('firwin: cutoff frequencies must be increasing')
    pass_nyquist = bool(cut.size & 1) ^ bool(pass_zero)
    if pass_nyquist and numtaps % 2 == 0:
        raise RuntimeError(
            'firwin: a filter passing Nyquist (e.g. highpass) must have '
            'an odd number of taps'
        )
    edges = np.hstack(
        ([0.0] if pass_zero else [], cut, [1.0] if pass_nyquist else [])
    )
    bands = edges.reshape(-1, 2)

    # h[k] = sum_bands right*sinc(right*(k-m)) - left*sinc(left*(k-m)),
    # all through the public op surface so the whole design is a dsc
    # program (sinc is the reference's own FIR primitive).
    m = (numtaps - 1) / 2.0
    k = arange(numtaps, dtype=dtype)
    shifted = k - m
    h = None
    for left, right in bands:
        term = sinc(shifted * float(right)) * float(right)
        if left > 0.0:
            term = term - sinc(shifted * float(left)) * float(left)
        h = term if h is None else h + term
    h = h * _design_window(window, numtaps, dtype)
    if scale:
        # normalize unit response at the center of the first passband
        left, right = bands[0]
        sf = 0.0 if left == 0.0 else (1.0 if right == 1.0 else (left + right) / 2.0)
        resp = h * cos(shifted * float(np.pi * sf)) if sf else h
        h = h / dsc_sum(resp, axis=-1, keepdims=True)
    return h


def firwin2(numtaps: int, freq, gain, nfreqs: Optional[int] = None,
            window='hamming', fs: float = 2.0,
            dtype: Dtype = Dtype.F32) -> Tensor:
    """FIR design from an arbitrary frequency response
    (scipy.signal.firwin2 semantics): linearly interpolate ``gain`` over
    ``freq`` onto a fine grid, attach the linear-phase term, inverse-
    transform, truncate to ``numtaps`` and window. The inverse transform
    rides the public irfft. ``freq`` spans [0, fs/2] and must start at 0
    and end at fs/2."""
    from ..fourier import irfft
    from ..fourier.plan import next_pow2

    if numtaps < 3:
        raise RuntimeError(f'firwin2: numtaps ({numtaps}) must be >= 3')
    f = np.asarray(freq, np.float64) / (fs / 2.0)
    g = np.asarray(gain, np.float64)
    if f.shape != g.shape or f.ndim != 1 or f.size < 2:
        raise RuntimeError('firwin2: freq and gain must be equal-length 1-D')
    if f[0] != 0.0 or f[-1] != 1.0:
        raise RuntimeError(
            'firwin2: freq must start at 0 and end at fs/2'
        )
    if np.any(np.diff(f) < 0):
        raise RuntimeError('firwin2: freq must be nondecreasing')
    if numtaps % 2 == 0 and g[-1] != 0.0:
        raise RuntimeError(
            'firwin2: even numtaps needs zero gain at Nyquist'
        )
    if nfreqs is None:
        nfreqs = 1 + next_pow2(numtaps)
    if numtaps >= nfreqs:
        raise RuntimeError(
            f'firwin2: nfreqs ({nfreqs}) must exceed numtaps ({numtaps})'
        )
    # interpolate the magnitude onto the grid and attach linear phase
    x = np.linspace(0.0, 1.0, nfreqs)
    fx = np.interp(x, f, g)
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * np.pi * x)
    fx2 = fx * shift
    spec = from_numpy(fx2.astype(np.complex64))
    full = irfft(spec)  # default out length = 2*(nfreqs-1), np semantics
    taps = full[:numtaps]
    return taps * _design_window(window, numtaps, dtype)


def kaiser_beta(a: float) -> float:
    """Kaiser beta for ``a`` dB of stopband attenuation
    (scipy.signal.kaiser_beta, the classic Kaiser empirical fit)."""
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) of a ``numtaps``-tap Kaiser FIR with transition
    width ``width`` (fraction of Nyquist; scipy.signal.kaiser_atten)."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def kaiserord(ripple: float, width: float) -> tuple:
    """(numtaps, beta) for a Kaiser FIR meeting ``ripple`` dB and
    transition ``width`` (scipy.signal.kaiserord semantics; numtaps may
    come back even — bump it for filter types needing odd taps)."""
    a = abs(ripple)
    if a < 8:
        raise RuntimeError(
            'kaiserord: ripple attenuation too small for the Kaiser '
            'formula (need >= 8 dB)'
        )
    beta = kaiser_beta(a)
    numtaps = (a - 7.95) / (2.285 * np.pi * width) + 1
    return int(np.ceil(numtaps)), beta


def savgol_coeffs(window_length: int, polyorder: int, deriv: int = 0,
                  delta: float = 1.0) -> np.ndarray:
    """Savitzky-Golay FIR coefficients (scipy.signal.savgol_coeffs
    semantics, convolution orientation): the least-squares polynomial
    smoother of degree ``polyorder`` over ``window_length`` samples,
    optionally returning the ``deriv``-th derivative estimate. Host f64
    (design time)."""
    if window_length < 1 or window_length % 2 == 0:
        raise RuntimeError(
            f'savgol: window_length ({window_length}) must be odd and >= 1'
        )
    if not 0 <= polyorder < window_length:
        raise RuntimeError(
            f'savgol: polyorder ({polyorder}) must be in [0, window_length)'
        )
    if deriv > polyorder:
        return np.zeros(window_length, np.float64)
    import math

    halflen = window_length // 2
    x = np.arange(-halflen, window_length - halflen, dtype=np.float64)[::-1]
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = x ** order
    y = np.zeros(polyorder + 1, np.float64)
    y[deriv] = math.factorial(deriv) / (delta ** deriv)
    return np.linalg.lstsq(A, y, rcond=None)[0]


def _polyfit_edge_matrix(window_length: int, polyorder: int, halflen: int,
                         deriv: int, delta: float, tail: bool) -> np.ndarray:
    """(halflen, window_length) matrix E with E @ x_window = the deriv-th
    derivative of the least-squares polynomial fit, evaluated at the
    first (or last) ``halflen`` sample positions — scipy savgol_filter's
    mode='interp' edge treatment as one precomputed matmul."""
    t = np.arange(window_length, dtype=np.float64)
    V = t[:, None] ** np.arange(polyorder + 1)[None, :]
    pinv = np.linalg.pinv(V)  # (polyorder+1, window_length)
    pos = t[-halflen:] if tail else t[:halflen]
    # derivative of sum_k c_k t^k: sum_k c_k k!/(k-d)! t^(k-d) / delta^d
    ks = np.arange(polyorder + 1)
    dcoef = np.where(
        ks >= deriv,
        np.array([np.prod(np.arange(k - deriv + 1, k + 1, dtype=np.float64))
                  for k in ks]),
        0.0,
    ) / (delta ** deriv)
    Pd = np.zeros((len(pos), polyorder + 1))
    for j, k in enumerate(ks):
        if k >= deriv:
            Pd[:, j] = dcoef[j] * pos ** (k - deriv)
    return Pd @ pinv


def savgol_filter(x: Tensor, window_length: int, polyorder: int,
                  deriv: int = 0, delta: float = 1.0,
                  mode: str = 'interp') -> Tensor:
    """Savitzky-Golay smoothing/differentiation
    (scipy.signal.savgol_filter semantics, ``mode='interp'``): the
    interior is the savgol FIR applied by FFT convolution, the first and
    last half-windows are polynomial fits to the edge windows — both
    expressed as matmuls/convolutions in ONE fused program chain."""
    import jax.numpy as jnp

    from .filter_fft import fft_convolve

    if mode != 'interp':
        raise RuntimeError(
            f'savgol_filter: only mode=\'interp\' (the scipy default) is '
            f'implemented, got {mode!r}'
        )
    if x.n_dim > 2:
        raise RuntimeError(
            f'savgol_filter: expected a 1-D or 2-D signal, got {x.n_dim}-D'
        )
    n = x.shape[-1]
    if window_length > n:
        raise RuntimeError(
            f'savgol_filter: window_length ({window_length}) exceeds the '
            f'signal length ({n})'
        )
    coeffs = savgol_coeffs(window_length, polyorder, deriv, delta)
    halflen = window_length // 2
    batched = x.n_dim == 2
    xj = x.jax if batched else x.jax[None, :]
    mid = fft_convolve(
        Tensor._from_jax(xj), from_numpy(coeffs.astype(np.float32)),
        mode='same',
    ).jax
    if halflen:
        eh = jnp.asarray(_polyfit_edge_matrix(
            window_length, polyorder, halflen, deriv, delta, tail=False
        ).astype(np.float32))
        et = jnp.asarray(_polyfit_edge_matrix(
            window_length, polyorder, halflen, deriv, delta, tail=True
        ).astype(np.float32))
        hp = 'highest'  # the GPU default for f32 matmuls may be TF32
        head = jnp.matmul(xj[:, :window_length], eh.T, precision=hp)
        tail = jnp.matmul(xj[:, -window_length:], et.T, precision=hp)
        out = jnp.concatenate(
            [head, mid[:, halflen : n - halflen], tail], axis=1
        )
    else:
        out = mid
    return Tensor._from_jax(out if batched else out[0])


def minimum_phase(h, method: str = 'homomorphic', n_fft=None,
                  half: bool = True) -> np.ndarray:
    """Minimum-phase version of a linear-phase FIR filter
    (scipy.signal.minimum_phase semantics). ``method='homomorphic'``
    (cepstral: fold the log-magnitude cepstrum onto the causal side,
    exponentiate) returns ``(len(h)+1)//2`` taps whose magnitude
    response approximates the square root of h's when ``half`` (the
    default), or ``len(h)`` taps matching it when ``half=False``.
    ``method='hilbert'`` is the discrete Hilbert-transform construction
    for exactly linear-phase (odd-length symmetric) filters. Host f64
    design math, like the rest of the design tier."""
    h = np.atleast_1d(np.asarray(h, np.float64))
    if h.ndim != 1 or h.size < 2:
        raise RuntimeError('minimum_phase: h must be 1-D with >= 2 taps')
    if np.iscomplexobj(h):
        raise RuntimeError('minimum_phase: complex filters not supported')
    if method not in ('homomorphic', 'hilbert'):
        raise RuntimeError(f'minimum_phase: unknown method {method!r}')
    n_half = h.size // 2
    if n_fft is None:
        n_fft = 2 ** int(np.ceil(np.log2(2 * (h.size - 1) / 0.01)))
    n_fft = int(n_fft)
    if n_fft < h.size:
        raise RuntimeError(
            f'minimum_phase: n_fft ({n_fft}) must be >= len(h) ({h.size})')
    if method == 'hilbert':
        if not half:
            raise RuntimeError(
                'minimum_phase: the hilbert method is defined only for '
                'half=True')
        w = np.arange(n_fft) * (2 * np.pi / n_fft * n_half)
        hspec = np.real(np.fft.fft(h, n_fft) * np.exp(1j * w))
        dp = hspec.max() - 1.0
        ds = 0.0 - hspec.min()
        s = 4.0 / (np.sqrt(1 + dp + ds) + np.sqrt(1 - dp + ds)) ** 2
        hspec = np.sqrt((hspec + ds) * s) + 1e-10
        # modified discrete Hilbert transform: rebuild the minimum-phase
        # spectrum from the magnitude via the log-cepstrum sign filter
        sig = np.zeros(n_fft)
        mid = n_fft // 2
        sig[1:mid] = 1.0
        sig[mid + 1:] = -1.0
        recon = np.fft.ifft(
            hspec * np.exp(np.fft.fft(
                sig * np.fft.ifft(np.log(hspec))))).real
        h_min = recon
    else:
        spec = np.abs(np.fft.fft(h, n_fft))
        spec += 1e-7 * spec[spec > 0].min()  # keep the log finite
        spec = np.log(spec)
        if half:
            spec *= 0.5
        cep = np.fft.ifft(spec).real
        # fold the anticausal cepstrum onto the causal side:
        # l_min[n] = delta[n] + 2u[n-1]
        win = np.zeros(n_fft)
        win[0] = 1.0
        stop = n_fft // 2
        win[1:stop] = 2.0
        if n_fft % 2:
            win[stop] = 1.0
        h_min = np.fft.ifft(np.exp(np.fft.fft(cep * win))).real
    n_out = (n_half + h.size % 2) if half else h.size
    return h_min[:n_out]


def firls(numtaps: int, bands, desired, weight=None,
          fs: float = 2.0) -> 'np.ndarray':
    """Least-squares linear-phase FIR design (scipy.signal.firls
    semantics): minimize the weighted integrated squared error of the
    type-I amplitude response A(f) = a0 + sum a_k cos(pi k f) against a
    piecewise-linear target over ``bands``. The band integrals are
    analytic (sinc antiderivatives), so the design is one (M+1)x(M+1)
    Toeplitz-plus-Hankel solve in f64 — exact vs scipy."""
    if numtaps < 1 or numtaps % 2 == 0:
        raise RuntimeError(f'firls: numtaps ({numtaps}) must be odd')
    bands_a = np.asarray(bands, np.float64).reshape(-1, 2) / (fs / 2.0)
    desired_a = np.asarray(desired, np.float64).reshape(-1, 2)
    if bands_a.shape != desired_a.shape:
        raise RuntimeError('firls: bands and desired sizes differ')
    if np.any(bands_a < 0) or np.any(bands_a > 1) or \
            np.any(np.diff(bands_a.ravel()) < 0):
        raise RuntimeError('firls: bands must be nondecreasing in '
                           '[0, fs/2]')
    if weight is None:
        weight = np.ones(len(bands_a))
    weight_a = np.asarray(weight, np.float64)
    if weight_a.size != len(bands_a):
        raise RuntimeError('firls: need one weight per band')
    m_half = (numtaps - 1) // 2
    k = np.arange(m_half + 1)
    k2 = np.arange(2 * m_half + 1)
    q = np.zeros(2 * m_half + 1)
    b = np.zeros(m_half + 1)
    for (f1, f2), (d1, d2), w in zip(bands_a, desired_a, weight_a):
        q += w * (f2 * np.sinc(k2 * f2) - f1 * np.sinc(k2 * f1))
        m = (d2 - d1) / (f2 - f1) if f2 != f1 else 0.0
        c = d1 - m * f1

        def antider(f):
            out = np.empty(m_half + 1)
            out[0] = m * f * f / 2.0 + c * f
            kk = k[1:]
            out[1:] = (m * f + c) * np.sin(np.pi * kk * f) / (np.pi * kk) \
                + m * np.cos(np.pi * kk * f) / (np.pi * kk) ** 2
            return out

        b += w * (antider(f2) - antider(f1))
    # <cos(pi i f), cos(pi j f)> = (q(|i-j|) + q(i+j)) / 2
    gram = 0.5 * (q[np.abs(k[:, None] - k[None, :])]
                  + q[k[:, None] + k[None, :]])
    a = np.linalg.solve(gram, b)
    return np.concatenate([a[m_half:0:-1] / 2.0, [a[0]], a[1:] / 2.0])


def gammatone(freq: float, ftype: str, order=None, numtaps=None,
              fs=None):
    """Gammatone auditory filter design (scipy.signal.gammatone
    semantics, the Slaney/Holdsworth formulas): ``ftype='fir'`` samples
    the order-``order`` gammatone impulse response
    t^(o-1) e^(-2 pi b t) cos(2 pi f t) over ``numtaps`` taps
    (unit gain at the center frequency); ``'iir'`` is the classic
    8th-order digital approximation (4 cascaded poles, impulse
    invariance). Returns host (b, a) arrays; run the 8th-order IIR
    through ``sosfilt(tf2sos(b, a), x)`` — a direct order-8 recurrence
    with near-unit poles is single-precision-unstable in ANY
    implementation."""
    freq = float(freq)
    if fs is None:
        fs = 2.0
    fs = float(fs)
    if not 0 < freq < fs / 2:
        raise RuntimeError(
            f'gammatone: freq must be in (0, {fs / 2}), got {freq}')
    if ftype not in ('fir', 'iir'):
        raise RuntimeError(f'gammatone: ftype must be fir or iir')
    erb = freq / 9.26449 + 24.7  # equivalent rectangular bandwidth
    if ftype == 'fir':
        order = 4 if order is None else int(order)
        if not 0 < order <= 24:
            raise RuntimeError('gammatone: order must be in (0, 24]')
        numtaps = max(int(fs * 0.015), 15) if numtaps is None \
            else int(numtaps)
        t = np.arange(numtaps, dtype=np.float64) / fs
        bw = 1.019 * erb
        b = t ** (order - 1) * np.exp(-2 * np.pi * bw * t) \
            * np.cos(2 * np.pi * freq * t)
        from math import factorial

        scale = 2 * (2 * np.pi * bw) ** order / factorial(order - 1) / fs
        return b * scale, np.asarray([1.0])
    # iir: 4 pole pairs at the center frequency, bandwidth 1.019*ERB
    t_s = 1.0 / fs
    bw = 2 * np.pi * 1.019 * erb
    fr = 2 * np.pi * freq * t_s
    bwt = bw * t_s
    # unit-gain normalization at the center frequency
    g1 = -2 * np.exp(2j * fr) * t_s
    g2 = 2 * np.exp(-bwt + 1j * fr) * t_s
    g3 = np.sqrt(3 + 2 ** 1.5) * np.sin(fr)
    g4 = np.sqrt(3 - 2 ** 1.5) * np.sin(fr)
    g5 = np.exp(2j * fr)
    g = (g1 + g2 * (np.cos(fr) - g4)) * (g1 + g2 * (np.cos(fr) + g4)) \
        * (g1 + g2 * (np.cos(fr) - g3)) * (g1 + g2 * (np.cos(fr) + g3))
    g /= (-2 / np.exp(2 * bwt) - 2 * g5 + 2 * (1 + g5)
          / np.exp(bwt)) ** 4
    g = float(np.hypot(g.real, g.imag))
    e = np.exp(-bwt)
    b = np.asarray([
        t_s ** 4,
        -4 * t_s ** 4 * np.cos(fr) * e,
        6 * t_s ** 4 * np.cos(2 * fr) * e ** 2,
        -4 * t_s ** 4 * np.cos(3 * fr) * e ** 3,
        t_s ** 4 * np.cos(4 * fr) * e ** 4,
    ]) / g
    a = np.asarray([
        1.0,
        -8 * np.cos(fr) * e,
        4 * (4 + 3 * np.cos(2 * fr)) * e ** 2,
        -8 * (6 * np.cos(fr) + np.cos(3 * fr)) * e ** 3,
        2 * (18 + 16 * np.cos(2 * fr) + np.cos(4 * fr)) * e ** 4,
        -8 * (6 * np.cos(fr) + np.cos(3 * fr)) * e ** 5,
        4 * (4 + 3 * np.cos(2 * fr)) * e ** 6,
        -8 * np.cos(fr) * e ** 7,
        e ** 8,
    ])
    return b, a


def firwin_2d(hsize, window, fc=None, fs: float = 2.0,
              circular: bool = False, pass_zero: bool = True,
              scale: bool = True) -> 'np.ndarray':
    """2-D FIR design (scipy.signal.firwin_2d semantics): the outer
    product of two 1-D window-method filters, or — ``circular=True`` —
    a circularly-symmetric filter built by radially interpolating an
    8x-oversampled 1-D design. Returns a host (h1, h2) array."""
    if len(hsize) != 2:
        raise RuntimeError('firwin_2d: hsize must have 2 elements')
    if fc is None:
        raise RuntimeError('firwin_2d: fc is required')
    if circular:
        n_r = max(hsize[0], hsize[1]) * 8
        win_r = firwin(n_r, fc, window=window, fs=fs).numpy()
        f1, f2 = np.meshgrid(np.linspace(-1, 1, hsize[0]),
                             np.linspace(-1, 1, hsize[1]))
        r = np.sqrt(f1 * f1 + f2 * f2)
        return np.interp(r, np.linspace(0, 1, n_r), win_r)
    if len(window) != 2:
        raise RuntimeError('firwin_2d: window must have 2 elements')
    row = firwin(hsize[0], fc, window=window[0], pass_zero=pass_zero,
                 scale=scale, fs=fs).numpy()
    col = firwin(hsize[1], fc, window=window[1], pass_zero=pass_zero,
                 scale=scale, fs=fs).numpy()
    return np.outer(row, col)
