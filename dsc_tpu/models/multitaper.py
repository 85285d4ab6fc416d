"""Thomson multitaper PSD and the Lomb-Scargle periodogram.

Two spectral estimators beyond the Welch family (models/psd.py):

* ``multitaper`` — Thomson's multitaper method: project the signal onto
  the first K discrete prolate spheroidal (Slepian) tapers
  (``windows.dpss``), average the K eigenspectra. The (K, n) taper
  stack rides the batched planar FFT engine as ONE rfft pass per
  signal batch, and the adaptive (Thomson) weighting iteration is a
  fixed-depth in-program loop — everything after taper design is a
  single XLA program. Variance falls like 1/K at fixed bias, which a
  single Welch window cannot do without shortening segments.

* ``lombscargle`` — the classical least-squares periodogram of
  UNEVENLY sampled data (scipy.signal.lombscargle semantics, the
  Townsend tau-shifted form). No FFT applies at irregular times; the
  (nfreq, n) phase grid is computed in one fused elementwise+reduction
  program — dense and batch-parallel, evaluated in f64 (phase
  w*t needs it; this matches scipy, which computes in f64).

The reference has no multitaper/Lomb-Scargle analog; these follow the
model-layer charter (models/__init__.py): scipy.signal and the standard
literature are the executable spec, the dsc FFT engine is the compute
path.
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
from ..tensor import Tensor
from ..windows import _np_dpss


def _dpss_and_ratios(n: int, nw: float, k: int):
    """(tapers (k, n) unit-energy, concentration ratios (k,)) — the
    ratios via the autocorrelation inner product with the Dirichlet
    kernel (the standard lambda_k = sum_m r_xx[m] * 4W sinc(2W m) form,
    same construction scipy uses for return_ratios=True)."""
    tapers = _np_dpss(n, nw, k)
    w = nw / n
    m = np.arange(n, dtype=np.float64)
    r = 4.0 * w * np.sinc(2.0 * w * m)
    r[0] = 2.0 * w
    # autocorrelation of each taper, lags 0..n-1
    pad = 1 << int(np.ceil(np.log2(2 * n - 1)))
    spec = np.abs(np.fft.rfft(tapers, pad, axis=-1)) ** 2
    rxx = np.fft.irfft(spec, pad, axis=-1)[:, :n]
    ratios = rxx @ r
    return tapers, np.clip(ratios, 0.0, 1.0)


@partial(
    jax.jit,
    static_argnames=('n', 'spec', 'weighting', 'n_iter'),
)
def _multitaper_program(x, tapers, ratios, fs, n, spec, tables, weighting,
                        n_iter):
    """(b, n) real -> (b, n//2+1) one-sided PSD. One XLA program: the
    (b*k, n) tapered copies go through the batched planar rfft engine in
    a single pass."""
    b, k = x.shape[0], tapers.shape[0]
    xt = (x[:, None, :] * tapers[None, :, :]).reshape(b * k, n)
    z = fft_core.rfft_batched(xt, spec, tables, n)
    sk = (jnp.real(z) ** 2 + jnp.imag(z) ** 2).reshape(b, k, -1)

    if weighting == 'unity':
        pxx = jnp.mean(sk, axis=1)
    elif weighting == 'eigen':
        wk = ratios / jnp.sum(ratios)
        pxx = jnp.einsum('k,bkf->bf', wk, sk, precision='highest')
    else:  # adaptive (Thomson): d_k = S / (lam_k S + (1-lam_k) sig2)
        sig2 = jnp.mean(x * x, axis=-1, keepdims=True)[:, :, None]  # (b,1,1)
        lam = ratios[None, :, None]  # (1,k,1)
        s = jnp.mean(sk[:, :2, :], axis=1, keepdims=True)  # seed: first 2
        for _ in range(n_iter):
            d = s / (lam * s + (1.0 - lam) * sig2 + 1e-30)
            w2 = d * d * lam
            s = jnp.sum(w2 * sk, axis=1, keepdims=True) / \
                jnp.sum(w2, axis=1, keepdims=True)
        pxx = s[:, 0, :]

    # tapers are unit-energy (sum w^2 = 1), so the density scale is 1/fs
    # (the scipy welch convention 1/(fs*sum(w^2)) specialized)
    pxx = pxx / fs
    return pxx.at[:, 1:-1].mul(2.0)


def multitaper(
    x: Tensor,
    fs: float = 1.0,
    nw: float = 4.0,
    k: Optional[int] = None,
    weighting: str = 'adaptive',
    n_iter: int = 5,
) -> tuple:
    """Thomson multitaper PSD estimate over the WHOLE signal. x: (n,) or
    (batch, n) real with n a power of two (the dsc FFT rule);
    ``nw`` the time-bandwidth product; ``k`` tapers (default
    ``2*nw - 1`` rounded down, the standard choice keeping
    concentrations near 1); ``weighting`` in {'unity', 'eigen',
    'adaptive'} (adaptive = Thomson's iterative data-dependent weights,
    ``n_iter`` fixed in-program iterations). Returns ``(f, Pxx)``
    one-sided in V**2/Hz (density scale; the tapers are unit-energy so
    this is the welch 1/(fs*sum(w^2)) convention specialized)."""
    if x.n_dim > 2:
        raise RuntimeError(
            f'multitaper: expected a 1-D or 2-D signal, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError('multitaper expects a real signal')
    n = x.shape[-1]
    if n < 8 or n & (n - 1):
        raise RuntimeError(
            f'multitaper: signal length ({n}) is not a power of two >= 8 '
            '(the dsc FFT family is power-of-two)')
    if weighting not in ('unity', 'eigen', 'adaptive'):
        raise RuntimeError(f'multitaper: unknown weighting {weighting!r}')
    if k is None:
        k = max(int(2 * nw) - 1, 1)
    if not 1 <= k <= n:
        raise RuntimeError(f'multitaper: k ({k}) must be in [1, {n}]')
    tapers, ratios = _dpss_and_ratios(n, float(nw), k)
    batched = x.n_dim == 2
    spec, tables = fft_plan.get_plan(n, 'real', np.complex64)
    xj = x.jax if batched else x.jax[None, :]
    with tracing.trace_op(
        'multitaper', 'op;pipeline', tracing.tensor_args(x=x)
    ) as tr:
        pxx = _multitaper_program(
            xj.astype(jnp.float32),
            jnp.asarray(tapers.astype(np.float32)),
            jnp.asarray(ratios.astype(np.float32)),
            jnp.float32(fs), n, spec, tables, weighting, int(n_iter),
        )
        if tr:
            tr.result = pxx
    from .. import fourier as _fourier

    f = _fourier.rfftfreq(n, d=1.0 / fs)
    return f, Tensor._from_jax(pxx if batched else pxx[0])


# --------------------------------------------------------------- lombscargle

_FREQ_TILE = 512  # frequencies per scan step: bounds the (tile, n) grid


@partial(jax.jit, static_argnames=('normalize', 'precenter'))
def _lombscargle_program(t, y, freqs, normalize, precenter):
    """Classical tau-shifted Lomb-Scargle periodogram, f64 phase math.
    Scans over frequency tiles so the (nfreq, n) phase grid never
    materializes whole — each (tile, n) block is one fused
    trig+reduction pass."""
    if precenter:
        y = y - jnp.mean(y)

    def tile(carry, wblk):
        wt = wblk[:, None] * t[None, :]  # (tile, n)
        s2, c2 = jnp.sin(2.0 * wt), jnp.cos(2.0 * wt)
        # w*tau as ONE phase angle (arctan2/2), subtracted directly —
        # dividing by w and re-multiplying loses the angle at large w*t
        wtau = jnp.arctan2(jnp.sum(s2, axis=1), jnp.sum(c2, axis=1)) / 2.0
        ph = wt - wtau[:, None]
        # guard w=0: scipy raises there; keep the math finite anyway
        cph, sph = jnp.cos(ph), jnp.sin(ph)
        yc = jnp.sum(y[None, :] * cph, axis=1)
        ys = jnp.sum(y[None, :] * sph, axis=1)
        cc = jnp.sum(cph * cph, axis=1)
        ss = jnp.sum(sph * sph, axis=1)
        p = 0.5 * (yc * yc / cc + ys * ys / (ss + 1e-300))
        return carry, p

    nf = freqs.shape[0]
    pad = (-nf) % _FREQ_TILE
    fpad = jnp.pad(freqs, (0, pad)).reshape(-1, _FREQ_TILE)
    _, blocks = jax.lax.scan(tile, 0.0, fpad)
    pgram = blocks.reshape(-1)[:nf]
    if normalize:
        pgram = pgram * 2.0 / jnp.sum(y * y)
    return pgram


def lombscargle(x: Tensor, y: Tensor, freqs: Tensor,
                precenter: bool = False, normalize: bool = False) -> Tensor:
    """Lomb-Scargle periodogram of unevenly sampled data
    (scipy.signal.lombscargle semantics): sample times ``x`` (n,),
    values ``y`` (n,), ANGULAR frequencies ``freqs`` (nfreq,) — all
    real 1-D. Phase math runs in f64 on device; the result is f32."""
    for name, t in (('x', x), ('y', y), ('freqs', freqs)):
        if t.n_dim != 1:
            raise RuntimeError(f'lombscargle: {name} must be 1-D')
        if t.dtype.is_complex:
            raise RuntimeError(f'lombscargle: {name} must be real')
    if x.shape != y.shape:
        raise RuntimeError(
            f'lombscargle: x {x.shape} and y {y.shape} must match')
    with tracing.trace_op(
        'lombscargle', 'op;pipeline',
        tracing.tensor_args(x=x, y=y, freqs=freqs),
    ) as tr:
        p = _lombscargle_program(
            x.jax.astype(jnp.float64), y.jax.astype(jnp.float64),
            freqs.jax.astype(jnp.float64),
            bool(normalize), bool(precenter),
        ).astype(jnp.float32)
        if tr:
            tr.result = p
    return Tensor._from_jax(p)
