"""Waveform generators: ``chirp``, ``square``, ``sawtooth``,
``gausspulse``.

scipy.signal semantics, computed ON DEVICE in one jitted program each
(like the window generators, windows.py): the time vector is a dsc
Tensor (or any array-like), the phase math runs in f64 (x64 mode is
globally on) and casts to the requested dtype at the end, so f32
waveforms carry only the final rounding step. The reference leaves
test-signal synthesis to the user (its examples reach for np.sin,
reference README.md:110-137); these make the synthesis side of a DSP
pipeline device-resident too.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import tracing
from ..dtype import DTYPE_TO_NP, Dtype
from ..tensor import Tensor


def _time_axis(t, who: str):
    if isinstance(t, Tensor):
        if t.dtype.is_complex:
            raise RuntimeError(f'{who}: t must be real')
        return t.jax.astype(jnp.float64)
    return jnp.asarray(np.asarray(t, np.float64))


def _emit(who: str, res, dtype: Dtype) -> Tensor:
    with tracing.trace_op(who, 'op;creation', {'shape': tuple(res.shape)}):
        out = res.astype(DTYPE_TO_NP[Dtype(dtype)])
    return Tensor._from_jax(out)


@partial(jax.jit, static_argnames=('method',))
def _chirp_phase(t, f0, t1, f1, phi, method):
    if method == 'linear':
        beta = (f1 - f0) / t1
        ph = 2 * jnp.pi * (f0 * t + 0.5 * beta * t * t)
    elif method == 'quadratic':
        beta = (f1 - f0) / (t1 * t1)
        ph = 2 * jnp.pi * (f0 * t + beta * t * t * t / 3.0)
    elif method == 'logarithmic':
        ph = 2 * jnp.pi * f0 * t1 * ((f1 / f0) ** (t / t1) - 1.0) / jnp.log(f1 / f0)
    else:  # hyperbolic
        sing = -f1 * t1 / (f0 - f1)
        ph = 2 * jnp.pi * (-sing * f0) * jnp.log(jnp.abs(1.0 - t / sing))
    return jnp.cos(ph + phi)


def chirp(t, f0: float, t1: float, f1: float, method: str = 'linear',
          phi: float = 0.0, dtype: Dtype = Dtype.F32) -> Tensor:
    """Frequency-swept cosine (scipy.signal.chirp semantics): sweep from
    ``f0`` at t=0 to ``f1`` at ``t1``. ``method``: 'linear' |
    'quadratic' | 'logarithmic' | 'hyperbolic'. ``t`` may be a dsc
    Tensor or array-like."""
    if method not in ('linear', 'quadratic', 'logarithmic', 'hyperbolic'):
        raise RuntimeError(f'chirp: unknown method {method!r}')
    if method in ('logarithmic', 'hyperbolic') and (f0 <= 0 or f1 <= 0):
        raise RuntimeError(f'chirp: {method} sweeps need f0, f1 > 0')
    if f0 == f1 and method in ('logarithmic', 'hyperbolic'):
        method = 'linear'  # constant frequency; avoids the 0/0 forms
    tj = _time_axis(t, 'chirp')
    res = _chirp_phase(tj, np.float64(f0), np.float64(t1), np.float64(f1),
                       np.float64(np.deg2rad(phi)), method)
    return _emit('chirp', res, dtype)


@jax.jit
def _square_wave(t, duty):
    frac = jnp.mod(t, 2 * jnp.pi) / (2 * jnp.pi)
    return jnp.where(frac < duty, 1.0, -1.0)


def square(t, duty: float = 0.5, dtype: Dtype = Dtype.F32) -> Tensor:
    """Square wave with period 2*pi (scipy.signal.square semantics):
    +1 for the first ``duty`` fraction of each period, -1 after."""
    if not 0 <= duty <= 1:
        raise RuntimeError(f'square: duty ({duty}) must be in [0, 1]')
    res = _square_wave(_time_axis(t, 'square'), np.float64(duty))
    return _emit('square', res, dtype)


@jax.jit
def _sawtooth_wave(t, width):
    frac = jnp.mod(t, 2 * jnp.pi) / (2 * jnp.pi)
    rise = 2.0 * frac / jnp.maximum(width, np.finfo(np.float64).tiny) - 1.0
    fall = 2.0 * (1.0 - frac) / jnp.maximum(1.0 - width,
                                            np.finfo(np.float64).tiny) - 1.0
    return jnp.where(frac < width, rise, fall)


def sawtooth(t, width: float = 1.0, dtype: Dtype = Dtype.F32) -> Tensor:
    """Sawtooth wave with period 2*pi (scipy.signal.sawtooth semantics):
    rises -1 -> 1 over the first ``width`` fraction of each period,
    falls back over the rest (``width=0.5`` gives a triangle)."""
    if not 0 <= width <= 1:
        raise RuntimeError(f'sawtooth: width ({width}) must be in [0, 1]')
    res = _sawtooth_wave(_time_axis(t, 'sawtooth'), np.float64(width))
    return _emit('sawtooth', res, dtype)


@jax.jit
def _gausspulse_wave(t, fc, a):
    env = jnp.exp(-a * t * t)
    return env * jnp.cos(2 * jnp.pi * fc * t)


def gausspulse(t, fc: float = 1000.0, bw: float = 0.5, bwr: float = -6.0,
               dtype: Dtype = Dtype.F32) -> Tensor:
    """Gaussian-modulated sinusoid (scipy.signal.gausspulse semantics):
    carrier ``fc`` with fractional bandwidth ``bw`` measured at ``bwr``
    dB (the envelope's variance follows from solving the spectrum
    magnitude at the band edges, scipy's closed form)."""
    if fc <= 0 or bw <= 0 or bwr >= 0:
        raise RuntimeError('gausspulse: need fc > 0, bw > 0, bwr < 0 dB')
    ref = 10.0 ** (bwr / 20.0)
    a = -((np.pi * fc * bw) ** 2) / (4.0 * np.log(ref))
    res = _gausspulse_wave(_time_axis(t, 'gausspulse'), np.float64(fc),
                           np.float64(a))
    return _emit('gausspulse', res, dtype)


@jax.jit
def _poly_phase(t, coeffs, phi):
    # Horner evaluation of the integrated sweep polynomial
    ph = jnp.zeros_like(t)
    for c in range(coeffs.shape[0]):
        ph = ph * t + coeffs[c]
    return jnp.cos(2.0 * jnp.pi * ph * t + phi)


def sweep_poly(t, poly, phi: float = 0.0,
               dtype: Dtype = Dtype.F32) -> Tensor:
    """Frequency-swept cosine whose instantaneous frequency follows the
    polynomial ``poly`` (scipy.signal.sweep_poly semantics: ``poly`` is
    highest-power-first coefficients or np.poly1d). The phase is the
    exact polynomial integral, computed in f64 on device."""
    p = np.poly1d(np.asarray(poly, np.float64))
    ip = np.polyint(p)  # integral, zero constant term
    # phase(t) = ip(t) = t * q(t) with q = ip without the constant term
    q = np.asarray(ip.coeffs[:-1], np.float64)
    tj = _time_axis(t, 'sweep_poly')
    res = _poly_phase(tj, jnp.asarray(q),
                      np.float64(np.deg2rad(phi)))
    return _emit('sweep_poly', res, dtype)


# standard primitive-polynomial tap sets for maximal-length LFSRs
# (Fibonacci form; the classic published table for nbits 2..32)
_MLS_TAPS = {
    2: (1,), 3: (2,), 4: (3,), 5: (3,), 6: (5,), 7: (6,), 8: (7, 6, 1),
    9: (5,), 10: (7,), 11: (9,), 12: (11, 10, 4), 13: (12, 11, 8),
    14: (13, 12, 2), 15: (14,), 16: (15, 13, 4), 17: (14,), 18: (11,),
    19: (18, 17, 14), 20: (17,), 21: (19,), 22: (21,), 23: (18,),
    24: (23, 22, 17), 25: (22,), 26: (25, 24, 20), 27: (26, 25, 22),
    28: (25,), 29: (27,), 30: (29, 28, 7), 31: (28,), 32: (31, 30, 10),
}


def max_len_seq(nbits: int, state=None, length=None, taps=None):
    """Maximal-length (pseudo-random binary) sequence from an nbits-wide
    Fibonacci LFSR (scipy.signal.max_len_seq semantics). Returns
    ``(seq, final_state)`` as uint8 host arrays: period 2**nbits - 1,
    default state all ones. Host integer math — an inherently sequential
    bit recurrence, the same design-time tier as coefficient design."""
    if taps is None:
        if nbits not in _MLS_TAPS:
            raise RuntimeError(
                f'max_len_seq: nbits ({nbits}) needs explicit taps '
                f'(built-in table covers {min(_MLS_TAPS)}..{max(_MLS_TAPS)})')
        taps = np.array(_MLS_TAPS[nbits], np.intp)
    else:
        taps = np.unique(np.asarray(taps, np.intp))[::-1]
        if np.any(taps < 0) or np.any(taps > nbits) or taps.size == 0:
            raise RuntimeError('max_len_seq: taps must be in [0, nbits]')
    n_max = (1 << nbits) - 1
    if length is None:
        length = n_max
    elif length < 0:
        raise RuntimeError('max_len_seq: length must be >= 0')
    if state is None:
        state = np.ones(nbits, np.int8)
    else:
        state = (np.asarray(state) != 0).astype(np.int8)
    if state.size != nbits or not np.any(state):
        raise RuntimeError(
            'max_len_seq: state must be nbits long and not all zero')
    seq = np.empty(int(length), np.int8)
    idx = 0
    for i in range(int(length)):
        fb = state[idx]
        seq[i] = fb
        for t_ in taps:
            fb ^= state[(t_ + idx) % nbits]
        state[idx] = fb
        idx = (idx + 1) % nbits
    return seq, np.roll(state, -idx)


def vectorstrength(events, period):
    """Vector strength (phase locking) of event times to one or more
    periods (scipy.signal.vectorstrength semantics): the length and
    angle of the mean unit phasor. Returns (strength, phase)."""
    events = np.asarray(
        events.numpy() if isinstance(events, Tensor) else events,
        np.float64)
    if events.ndim != 1:
        raise RuntimeError('vectorstrength: events must be 1-D')
    periods = np.asarray(period, np.float64)
    scalar = periods.ndim == 0
    periods = np.atleast_1d(periods)
    if np.any(periods <= 0):
        raise RuntimeError('vectorstrength: periods must be positive')
    ang = 2.0 * np.pi * events[None, :] / periods[:, None]
    vec = np.exp(1j * ang).mean(axis=1)
    strength, phase = np.abs(vec), np.angle(vec)
    if scalar:
        return float(strength[0]), float(phase[0])
    return strength, phase
