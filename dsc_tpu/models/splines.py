"""B-spline signal processing: ``symiirorder1`` / ``symiirorder2``
mirror-symmetric IIR smoothers, ``cspline1d`` / ``qspline1d``
coefficient transforms (+ ``_eval``), ``gauss_spline``.

scipy.signal semantics. The forward/backward recursions are the hot
path and run ON DEVICE as log-depth affine ``lax.associative_scan``s
(first-order scalar maps, second-order 2x2 companion maps — the same
parallelization as the IIR engine). The mirror-symmetric initial
conditions are truncated power-series dot products (scipy's exact
construction, evaluated in-program in f64). Basis evaluation
(``cspline1d_eval``) interpolates at arbitrary points host-side — a
data-dependent gather product, like the peak family.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import tracing
from ..tensor import Tensor


def _as_rows(x: Tensor, who: str):
    if x.n_dim > 2:
        raise RuntimeError(f'{who}: expected 1-D or 2-D input, got {x.n_dim}-D')
    if x.dtype.is_complex:
        raise RuntimeError(f'{who} expects a real signal')
    batched = x.n_dim == 2
    xj = x.jax.astype(jnp.float64)
    return (xj if batched else xj[None, :]), batched


def _scan1(v, z1):
    """y[k] = v[k] + z1*y[k-1] with y[0] = v[0], log-depth. v: (b, n)."""
    n = v.shape[1]
    ms = jnp.full((n,), z1, v.dtype).at[0].set(0.0)

    def combine(a, b):
        return (a[0] * b[0], a[1] * b[0] + b[1])

    _, y = jax.lax.associative_scan(
        combine, (jnp.broadcast_to(ms[None, :], v.shape), v), axis=1)
    return y


def _scan2(v, a2, a3, y0, y1):
    """y[k] = v[k] + a2*y[k-1] + a3*y[k-2] with y[0], y[1] given.
    Companion-matrix affine scan over (b, n-2) steps; returns (b, n)."""
    b, n = v.shape
    m = jnp.asarray([[a2, a3], [1.0, 0.0]], v.dtype)
    steps = n - 2
    ms = jnp.broadcast_to(m[None, :, :], (steps, 2, 2))
    vs = jnp.stack([v[:, 2:], jnp.zeros((b, steps), v.dtype)], axis=2)
    # fold the initial state into the first step
    s0 = jnp.stack([y1, y0], axis=1)  # (b, 2)
    # HIGHEST precision: a reduced-precision default f32 matmul (TF32 on
    # GPUs) compounds over the scan's log2(n) composition levels (iir.py)
    hp = jax.lax.Precision.HIGHEST
    vs = vs.at[:, 0, :].add(jnp.matmul(s0, m.T, precision=hp))

    mm, ys = jax.lax.associative_scan(
        lambda p, q: (jnp.einsum('snm,smk->snk', q[0], p[0], precision=hp),
                      jnp.einsum('snm,sbm->sbn', q[0], p[1],
                                 precision=hp) + q[1]),
        (ms, jnp.swapaxes(vs, 0, 1)))
    del mm
    y_tail = jnp.swapaxes(ys, 0, 1)[:, :, 0]  # (b, steps): y[2..n-1]
    return jnp.concatenate([y0[:, None], y1[:, None], y_tail], axis=1)


def _sym_precision(precision: float) -> float:
    # scipy's C default for double precision inputs (splinemodule
    # lineage): terms below 1e-11 stop the boundary series
    if precision <= 0.0 or precision > 1.0:
        return 1e-11
    return float(precision)


def _series_len(base: float, precision: float, n: int, who: str,
                strict: bool = True) -> int:
    if precision <= 0.0:  # 0 = no truncation (full-signal sums)
        return n
    if base <= 0.0:
        return 1
    k = int(np.ceil(np.log(precision) / np.log(base))) + 1
    if k > n:
        # scipy's symiirorder1 C raises when the series cannot reach
        # its precision within the signal (strict); symiirorder2's IC
        # kernels stop at their first small TERM (a looser,
        # data-dependent rule), so there we truncate at n instead
        if strict:
            raise RuntimeError(
                f'{who}: boundary-condition series did not converge '
                f'within the signal length (|pole|={base:.4f}, n={n})')
        return n
    return max(k, 1)


@partial(jax.jit, static_argnames=('l',))
def _symiir1_program(x, c0, z1, l):
    # mirror WITH the edge sample repeated (x[-1-k] = x[k], scipy's
    # symiirorder1_ic): y0 = x0 + z1 * sum z1^k x[k]
    k = jnp.arange(l, dtype=x.dtype)
    y0 = x[:, 0] + z1 * jnp.sum(z1 ** k * x[:, :l], axis=1)
    v = x.at[:, 0].set(y0)
    y1 = _scan1(v, z1)
    out_last = -c0 / (z1 - 1.0) * y1[:, -1]
    vr = (c0 * y1[:, ::-1]).at[:, 0].set(out_last)
    return _scan1(vr, z1)[:, ::-1]


def symiirorder1(signal: Tensor, c0: float, z1: float,
                 precision: float = -1.0) -> Tensor:
    """Mirror-symmetric smoothing IIR, first-order cascade
    H(z) = c0/((1 - z1 z^-1)(1 - z1 z)) (scipy.signal.symiirorder1
    semantics). signal: (n,) or batched (b, n); the two recursions run
    as log-depth scans on device."""
    if abs(z1) >= 1.0:
        raise RuntimeError('symiirorder1: |z1| must be < 1')
    xj, batched = _as_rows(signal, 'symiirorder1')
    prec = _sym_precision(precision)
    l = _series_len(abs(z1), prec, xj.shape[1], 'symiirorder1')
    with tracing.trace_op(
        'symiirorder1', 'op;pipeline', tracing.tensor_args(x=signal)
    ) as tr:
        out = _symiir1_program(xj, jnp.float64(c0), jnp.float64(z1), l)
        if tr:
            tr.result = out
    out = out.astype(jnp.float32)
    return Tensor._from_jax(out if batched else out[0])


def _hc_vec(k, cs, rho, omega):
    k = np.asarray(k, np.float64)
    if omega == 0.0:
        h = cs * rho ** k * (k + 1.0)
    else:
        h = cs / np.sin(omega) * rho ** k * np.sin(omega * (k + 1.0))
    return np.where(k > -1, h, 0.0)


def _hs_vec(k, cs, rho, omega):
    ak = np.abs(np.asarray(k, np.float64))
    c0 = (cs * cs * (1 + rho * rho) / (1 - rho * rho)
          / (1 - 2 * rho * rho * np.cos(2 * omega) + rho ** 4))
    gamma = (1 - rho * rho) / (1 + rho * rho) / np.tan(omega)
    return c0 * rho ** ak * (np.cos(omega * ak) + gamma * np.sin(omega * ak))


def _mm(a, b):
    # f32 matmuls may run in TF32 on GPUs unless HIGHEST is asked for
    return jnp.matmul(a, b, precision='highest')


@partial(jax.jit, static_argnames=('swap01',))
def _symiir2_core(x, cs, a2, a3, hc0, hc1, hfwd0, hfwd1, hbwd_last,
                  hbwd_last2, swap01=True):
    # forward ICs (mirror-symmetric steady state):
    #   y0 = hc(0) x0 + sum hc(k+1) x[k]
    #   y1 = hc(0) x1 + hc(1) x0 + ... (symiirorder2's C convention), or
    #   y1 = hc(0) x0 + hc(1) x1 + ... (the smoothing-spline convention)
    y0 = hc0 * x[:, 0] + _mm(x, hfwd0)
    if swap01:
        y1 = hc0 * x[:, 1] + hc1 * x[:, 0] + _mm(x, hfwd1)
    else:
        y1 = hc0 * x[:, 0] + hc1 * x[:, 1] + _mm(x, hfwd1)
    yf = _scan2(cs * x, a2, a3, y0, y1)
    # backward ICs from the SYMMETRIC response to the input
    xr = x[:, ::-1]
    o_last = _mm(xr, hbwd_last)
    o_last2 = _mm(xr, hbwd_last2)
    yr = _scan2(cs * yf[:, ::-1], a2, a3, o_last, o_last2)
    return yr[:, ::-1]


def _symiir2_host_tables(r, omega, n, precision, who):
    cs = 1.0 - 2.0 * r * np.cos(omega) + r * r
    l = _series_len(abs(r), precision, n, who, strict=False)
    k = np.arange(n, dtype=np.float64)
    zero = np.zeros(n)
    hfwd0 = np.where(k < l, _hc_vec(k + 1, cs, r, omega), zero)
    hfwd1 = np.where(k < l, _hc_vec(k + 2, cs, r, omega), zero)
    hb0 = np.where(k < l, _hs_vec(k, cs, r, omega)
                   + _hs_vec(k + 1, cs, r, omega), zero)
    hb1 = np.where(k < l, _hs_vec(k - 1, cs, r, omega)
                   + _hs_vec(k + 2, cs, r, omega), zero)
    return cs, hfwd0, hfwd1, hb0, hb1


def symiirorder2(signal: Tensor, r: float, omega: float,
                 precision: float = -1.0) -> Tensor:
    """Mirror-symmetric smoothing IIR, second-order cascade
    H(z) = cs^2 / ((1 - a2 z^-1 - a3 z^-2)(1 - a2 z - a3 z^2)) with
    a2 = 2 r cos(omega), a3 = -r^2 (scipy.signal.symiirorder2
    semantics); device log-depth companion scans."""
    if abs(r) >= 1.0:
        raise RuntimeError('symiirorder2: r must be < 1')
    xj, batched = _as_rows(signal, 'symiirorder2')
    n = xj.shape[1]
    if n < 4:
        raise RuntimeError('symiirorder2: signal too short')
    prec = _sym_precision(precision)
    cs, hf0, hf1, hb0, hb1 = _symiir2_host_tables(
        float(r), float(omega), n, prec, 'symiirorder2')
    a2, a3 = 2.0 * r * np.cos(omega), -(r * r)
    hc0 = float(_hc_vec(0, cs, r, omega))
    hc1 = float(_hc_vec(1, cs, r, omega))
    with tracing.trace_op(
        'symiirorder2', 'op;pipeline', tracing.tensor_args(x=signal)
    ) as tr:
        out = _symiir2_core(
            xj, jnp.float64(cs), jnp.float64(a2), jnp.float64(a3),
            jnp.float64(hc0), jnp.float64(hc1),
            jnp.asarray(hf0), jnp.asarray(hf1),
            jnp.asarray(hb0), jnp.asarray(hb1))
        if tr:
            tr.result = out
    out = out.astype(jnp.float32)
    return Tensor._from_jax(out if batched else out[0])


# ------------------------------------------------------- spline transforms

@partial(jax.jit, static_argnames=('scale',))
def _spline_coeff_program(x, zi, scale):
    n = x.shape[1]
    powers = zi ** jnp.arange(n, dtype=x.dtype)
    y0 = x[:, 0] + zi * jnp.sum(powers * x, axis=1)
    yplus = _scan1(x.at[:, 0].set(y0), zi)
    out_last = zi / (zi - 1.0) * yplus[:, -1]
    # output[k] = zi*(output[k+1] - yplus[k]) = -zi*yplus[k] + zi*out[k+1]
    vr = (-zi * yplus[:, ::-1]).at[:, 0].set(out_last)
    return _scan1(vr, zi)[:, ::-1] * scale


def _coeff_smooth_params(lam: float):
    xi = 1.0 - 96.0 * lam + 24.0 * lam * np.sqrt(3.0 + 144.0 * lam)
    omeg = np.arctan2(np.sqrt(144.0 * lam - 1.0), np.sqrt(xi))
    rho = (24.0 * lam - 1.0 - np.sqrt(xi)) / (24.0 * lam)
    rho = rho * np.sqrt(
        (48.0 * lam + 24.0 * lam * np.sqrt(3.0 + 144.0 * lam)) / xi)
    return float(rho), float(omeg)


def cspline1d(signal: Tensor, lamb: float = 0.0) -> Tensor:
    """Cubic B-spline coefficients with mirror-symmetric boundaries
    (scipy.signal.cspline1d semantics): exact interpolation for
    ``lamb=0``, smoothing spline for ``lamb > 1/144``. Device scans."""
    xj, batched = _as_rows(signal, 'cspline1d')
    if lamb == 0.0:
        zi = -2.0 + np.sqrt(3.0)
        with tracing.trace_op(
            'cspline1d', 'op;pipeline', tracing.tensor_args(x=signal)
        ) as tr:
            out = _spline_coeff_program(xj, jnp.float64(zi), 6.0)
            if tr:
                tr.result = out
        out = out.astype(jnp.float32)
        return Tensor._from_jax(out if batched else out[0])
    if 144.0 * lamb <= 1.0:
        raise RuntimeError(
            f'cspline1d: smoothing needs lamb > 1/144, got {lamb}')
    rho, omeg = _coeff_smooth_params(float(lamb))
    n = xj.shape[1]
    # the smoothing-spline ICs sum over the FULL signal (scipy
    # _cubic_smooth_coeff) and use the unswapped y1 convention
    cs, hf0, hf1, hb0, hb1 = _symiir2_host_tables(
        rho, omeg, n, 0.0, 'cspline1d')
    a2, a3 = 2.0 * rho * np.cos(omeg), -(rho * rho)
    hc0 = float(_hc_vec(0, cs, rho, omeg))
    hc1 = float(_hc_vec(1, cs, rho, omeg))
    with tracing.trace_op(
        'cspline1d', 'op;pipeline', tracing.tensor_args(x=signal)
    ) as tr:
        out = _symiir2_core(
            xj, jnp.float64(cs), jnp.float64(a2), jnp.float64(a3),
            jnp.float64(hc0), jnp.float64(hc1),
            jnp.asarray(hf0), jnp.asarray(hf1),
            jnp.asarray(hb0), jnp.asarray(hb1), swap01=False)
        if tr:
            tr.result = out
    out = out.astype(jnp.float32)
    return Tensor._from_jax(out if batched else out[0])


def qspline1d(signal: Tensor, lamb: float = 0.0) -> Tensor:
    """Quadratic B-spline coefficients (scipy.signal.qspline1d; only
    ``lamb = 0`` is defined, like scipy)."""
    if lamb != 0.0:
        raise RuntimeError('qspline1d: only lamb == 0 is supported')
    xj, batched = _as_rows(signal, 'qspline1d')
    zi = -3.0 + 2.0 * np.sqrt(2.0)
    with tracing.trace_op(
        'qspline1d', 'op;pipeline', tracing.tensor_args(x=signal)
    ) as tr:
        out = _spline_coeff_program(xj, jnp.float64(zi), 8.0)
        if tr:
            tr.result = out
    out = out.astype(jnp.float32)
    return Tensor._from_jax(out if batched else out[0])


# ------------------------------------------------------------ evaluation

def _bspline_cubic(x):
    ax = np.abs(np.asarray(x, np.float64))
    return np.where(ax < 1.0, 2.0 / 3.0 - ax * ax + ax ** 3 / 2.0,
                    np.where(ax < 2.0, (2.0 - ax) ** 3 / 6.0, 0.0))


def _bspline_quad(x):
    ax = np.abs(np.asarray(x, np.float64))
    return np.where(ax < 0.5, 0.75 - ax * ax,
                    np.where(ax < 1.5, (ax - 1.5) ** 2 / 2.0, 0.0))


def _spline_eval(cj, newx, x0, dx, basis, support, who):
    cj = np.asarray(cj.numpy() if isinstance(cj, Tensor) else cj,
                    np.float64)
    if cj.ndim != 1 or cj.size == 0:
        raise RuntimeError(f'{who}: coefficients must be non-empty 1-D')
    t = (np.asarray(newx, np.float64) - x0) / float(dx)
    n = cj.size
    # mirror-symmetric domain folding
    t = np.abs(t)
    period = 2.0 * (n - 1)
    if n > 1:
        t = np.mod(t, period)
        t = np.where(t > n - 1, period - t, t)
    else:
        t = np.zeros_like(t)
    res = np.zeros_like(t)
    jlower = np.floor(t - support / 2.0).astype(int) + 1
    for i in range(support):
        thisj = jlower + i
        indj = np.clip(thisj, 0, n - 1)
        res += cj[indj] * basis(t - thisj)
    return res


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0):
    """Evaluate a cubic-spline signal model at new points
    (scipy.signal.cspline1d_eval semantics, mirror-symmetric
    extension). Host evaluation (data-dependent gathers)."""
    return _spline_eval(cj, newx, x0, dx, _bspline_cubic, 4,
                        'cspline1d_eval')


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0):
    """Evaluate a quadratic-spline signal model at new points
    (scipy.signal.qspline1d_eval semantics)."""
    return _spline_eval(cj, newx, x0, dx, _bspline_quad, 3,
                        'qspline1d_eval')


def gauss_spline(x, n: int):
    """Gaussian approximation of an order-n B-spline
    (scipy.signal.gauss_spline)."""
    x = np.asarray(x.numpy() if isinstance(x, Tensor) else x, np.float64)
    sig2 = (n + 1) / 12.0
    return np.exp(-x * x / (2.0 * sig2)) / np.sqrt(2.0 * np.pi * sig2)


# ------------------------------------------------------------ 2-D splines

def _along_axes(func, x: Tensor, *args, **kw) -> Tensor:
    """Apply a batched-rows 1-D transform along axis -1 then axis 0 of a
    2-D Tensor (scipy's symiirorder_nd composition)."""
    from ..tensor import transpose

    out = func(x, *args, **kw)
    out = func(transpose(out), *args, **kw)
    return transpose(out)


def cspline2d(signal: Tensor, lamb: float = 0.0,
              precision: float = -1.0) -> Tensor:
    """2-D cubic B-spline coefficients (scipy.signal.cspline2d
    semantics): the separable symiirorder1 transform for
    ``lamb <= 1/144`` (c0 = -6r, z1 = r = sqrt(3)-2), the separable
    symiirorder2 smoother above. Both run as device scans along rows,
    then columns. For the smoothing case the boundary values differ
    from scipy's at ~1e-6 absolute: its C stops each boundary series at
    the FIRST term under its precision default, dropping the
    oscillating tail; this implementation sums the decayed series."""
    if signal.n_dim != 2:
        raise RuntimeError(f'cspline2d: expected a 2-D image, got '
                           f'{signal.n_dim}-D')
    if lamb <= 1.0 / 144.0:
        r = -2.0 + np.sqrt(3.0)
        return _along_axes(symiirorder1, signal, -r * 6.0, r,
                           precision=precision)
    r, omega = _coeff_smooth_params(float(lamb))
    return _along_axes(symiirorder2, signal, r, omega,
                       precision=precision)


def qspline2d(signal: Tensor, lamb: float = 0.0,
              precision: float = -1.0) -> Tensor:
    """2-D quadratic B-spline coefficients (scipy.signal.qspline2d;
    ``lamb`` must be 0, like scipy)."""
    if signal.n_dim != 2:
        raise RuntimeError(f'qspline2d: expected a 2-D image, got '
                           f'{signal.n_dim}-D')
    if lamb > 0:
        raise RuntimeError('qspline2d: lamb must be <= 0')
    r = -3.0 + 2.0 * np.sqrt(2.0)
    return _along_axes(symiirorder1, signal, -r * 8.0, r,
                       precision=precision)


@partial(jax.jit, static_argnames=('kr', 'kc'))
def _sepfir2d_program(x, hrow, hcol, kr, kc):
    m, n = x.shape
    pr, pc = kr // 2, kc // 2
    # convolution along the last axis (columns move): kernel flipped
    xp = jnp.pad(x, ((0, 0), (pc, pc)), mode='symmetric')
    out = sum(hcol[kc - 1 - j] * xp[:, j:j + n] for j in range(kc))
    xp = jnp.pad(out, ((pr, pr), (0, 0)), mode='symmetric')
    return sum(hrow[kr - 1 - i] * xp[i:i + m, :] for i in range(kr))


def sepfir2d(input: Tensor, hrow, hcol) -> Tensor:  # noqa: A002
    """Separable 2-D FIR with mirror-symmetric (edge-repeating) boundary
    extension (scipy.signal.sepfir2d semantics): convolve the rows with
    ``hrow`` and the columns with ``hcol``, both odd-length. One device
    program of shifted-slice adds."""
    if input.n_dim != 2:
        raise RuntimeError(f'sepfir2d: expected a 2-D image, got '
                           f'{input.n_dim}-D')
    hr = np.atleast_1d(np.asarray(hrow, np.float64))
    hc = np.atleast_1d(np.asarray(hcol, np.float64))
    if hr.ndim != 1 or hc.ndim != 1 or hr.size % 2 == 0 \
            or hc.size % 2 == 0:
        raise RuntimeError('sepfir2d: hrow and hcol must be odd-length 1-D')
    with tracing.trace_op(
        'sepfir2d', 'op;pipeline', tracing.tensor_args(x=input)
    ) as tr:
        out = _sepfir2d_program(
            input.jax.astype(jnp.float64), jnp.asarray(hr),
            jnp.asarray(hc), hr.size, hc.size).astype(jnp.float32)
        if tr:
            tr.result = out
    return Tensor._from_jax(out)


def spline_filter(Iin: Tensor, lmbda: float = 5.0) -> Tensor:
    """Smoothing-spline filtering of a 2-D image
    (scipy.signal.spline_filter semantics): cubic-spline coefficients at
    fall-off ``lmbda``, then the separable [1, 4, 1]/6 synthesis."""
    ck = cspline2d(Iin, lmbda)
    h = np.asarray([1.0, 4.0, 1.0]) / 6.0
    return sepfir2d(ck, h, h)
