"""Jitted XLA compute kernels for the dsc_tpu op set.

Rebuild of the reference scalar functors + iterator loops
(dsc/include/dsc_ops.h, dsc/include/dsc_iter.h, dsc/src/dsc.cpp op layer).

Under XLA the iterator library disappears: broadcasting, strided traversal and
elementwise fusion are XLA's job. Each public op is a module-level
``jax.jit``-compiled function so the compile cache is keyed purely by
(shape, dtype) — steady state runs with zero retraces and zero host
allocations, matching the reference's "no runtime allocations" contract.

Semantics preserved exactly (SURVEY Appendix B):
- max/min/clip on complex compare the REAL part only (dsc_ops.h:318-338,
  dsc.h:346-349)
- abs/angle of complex produce the real component dtype (dsc.cpp:1444-1541)
- conj/real are NOPs on real input (handled by the caller as views)
- imag of a real tensor is zeros (dsc.cpp:1596-1622)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# binary ops (reference dsc.cpp:1186-1310)
# ---------------------------------------------------------------------------


def _binary(fn):
    @partial(jax.jit, static_argnames=('out_dtype',))
    def op(a, b, out_dtype):
        return fn(a.astype(out_dtype), b.astype(out_dtype))

    return op


add = _binary(jnp.add)
sub = _binary(jnp.subtract)
mul = _binary(jnp.multiply)
div = _binary(jnp.true_divide)


def _cpow_planes(ar, ai, br, bi):
    """pow on real planes: a^b = exp(b * log a) (reference pow_op,
    dsc_ops.h:305-316), with the same explicit real formulas as the
    complex unary ops (see _unary).

    Zero bases are special-cased to NumPy's values (0^0 = 1, 0^b = 0):
    the log formula hits 0*(-inf) = nan there — the reference's own
    std::exp(b*std::log(a)) does too, but NumPy is the declared oracle
    and zero-padded FFT tails make exact zeros common (found by
    tests/test_fuzz.py)."""
    lr = 0.5 * jnp.log(ar * ar + ai * ai)
    li = jnp.arctan2(ai, ar)
    er = br * lr - bi * li
    ei = br * li + bi * lr
    m = jnp.exp(er)
    yr, yi = m * jnp.cos(ei), m * jnp.sin(ei)
    zero_a = (ar == 0) & (ai == 0)
    zero_b = (br == 0) & (bi == 0)
    yr = jnp.where(zero_a, jnp.where(zero_b, 1.0, 0.0), yr)
    yi = jnp.where(zero_a, 0.0, yi)
    return yr, yi


def _cpow(a, b):
    yr, yi = _cpow_planes(jnp.real(a), jnp.imag(a),
                          jnp.real(b), jnp.imag(b))
    return jax.lax.complex(yr, yi).astype(a.dtype)


def _pow_plain():
    # complex pow takes the real-formula route (_cpow)
    @partial(jax.jit, static_argnames=('out_dtype',))
    def op(a, b, out_dtype):
        a = a.astype(out_dtype)
        b = b.astype(out_dtype)
        if jnp.iscomplexobj(a):
            return _cpow(a, b)
        return jnp.power(a, b)

    return op


pow_ = _pow_plain()

BINARY = {'add': add, 'sub': sub, 'mul': mul, 'div': div, 'pow': pow_}

# ---------------------------------------------------------------------------
# unary ops (reference dsc.cpp:1312-1769)
# ---------------------------------------------------------------------------


def _unary(fn, complex_fn=None):
    """``complex_fn`` (when given) handles complex inputs via explicit
    real-arithmetic formulas, the reference's own complex specializations
    (dsc_ops.h), whose branch cuts test_ops pins against NumPy."""
    @jax.jit
    def op(x):
        if complex_fn is not None and jnp.iscomplexobj(x):
            return complex_fn(x)
        return fn(x)

    return op


def _parts(x):
    return jnp.real(x), jnp.imag(x)


def _clog(x):
    """log z = 0.5*log(re^2+im^2) + i*atan2(im, re) (reference logn_op
    complex specialization, dsc_ops.h:147-165).

    re*re+im*im deliberately matches the reference's naive formula; it
    over/underflows for |z| outside ~[1e-23, 1.8e19] f32 where NumPy's
    hypot-based path stays finite — accepted reference-parity behavior
    (tests only exercise O(1) magnitudes, test_ops.py:32-35)."""
    re, im = _parts(x)
    return jax.lax.complex(
        0.5 * jnp.log(re * re + im * im), jnp.arctan2(im, re)
    )


def _clog_scaled(scale):
    def f(x):
        y = _clog(x)
        return jax.lax.complex(
            jnp.real(y) * scale, jnp.imag(y) * scale
        ).astype(x.dtype)
    return f


def _cexp(x):
    re, im = _parts(x)
    m = jnp.exp(re)
    return jax.lax.complex(m * jnp.cos(im), m * jnp.sin(im))


def _csqrt(x):
    """Principal square root via the stable half-angle formulas; branch
    cut matches NumPy (negative reals with +0 imag map to +i*sqrt(-re),
    and with -0 imag to -i*sqrt(-re) — signbit, not im<0, so negative
    zero picks the lower branch like np.sqrt does). The re*re+im*im
    magnitude matches the reference's naive formula (see _clog)."""
    re, im = _parts(x)
    r = jnp.sqrt(re * re + im * im)
    u_pos = jnp.sqrt((r + re) * 0.5)
    v_neg = jnp.sqrt(jnp.maximum((r - re) * 0.5, 0.0))
    tiny = jnp.finfo(re.dtype).tiny
    s = jnp.where(jnp.signbit(im), -1.0, 1.0).astype(re.dtype)
    u = jnp.where(re >= 0, u_pos,
                  jnp.abs(im) / jnp.maximum(2.0 * v_neg, tiny))
    v = jnp.where(re >= 0, im / jnp.maximum(2.0 * u_pos, tiny), s * v_neg)
    zero = r == 0
    u = jnp.where(zero, 0.0, u)
    v = jnp.where(zero, 0.0, v)
    return jax.lax.complex(u, v).astype(x.dtype)


def _csin(x):
    re, im = _parts(x)
    return jax.lax.complex(jnp.sin(re) * jnp.cosh(im),
                           jnp.cos(re) * jnp.sinh(im))


def _ccos(x):
    re, im = _parts(x)
    return jax.lax.complex(jnp.cos(re) * jnp.cosh(im),
                           -jnp.sin(re) * jnp.sinh(im))


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _csinc(x):
    """np.sinc(z) = sin(pi z)/(pi z), sinc(0) = 1."""
    re, im = _parts(x)
    pr, pi_ = np.pi * re, np.pi * im
    sr = jnp.sin(pr) * jnp.cosh(pi_)
    si = jnp.cos(pr) * jnp.sinh(pi_)
    qr, qi = _cdiv(sr, si, pr, pi_)
    zero = (re == 0) & (im == 0)
    return jax.lax.complex(jnp.where(zero, 1.0, qr),
                           jnp.where(zero, 0.0, qi)).astype(x.dtype)


_LN2 = float(np.log(2.0))
_LN10 = float(np.log(10.0))

cos = _unary(jnp.cos, _ccos)
sin = _unary(jnp.sin, _csin)
sinc = _unary(jnp.sinc, _csinc)
logn = _unary(jnp.log, _clog)
log2 = _unary(jnp.log2, _clog_scaled(1.0 / _LN2))
log10 = _unary(jnp.log10, _clog_scaled(1.0 / _LN10))
exp = _unary(jnp.exp, _cexp)
sqrt = _unary(jnp.sqrt, _csqrt)
conj = _unary(jnp.conj)
imag_c = _unary(jnp.imag)
real_c = _unary(jnp.real)


@jax.jit
def absolute(x):
    # complex -> real dtype happens naturally through jnp.abs
    return jnp.abs(x)


@jax.jit
def angle(x):
    return jnp.angle(x)


@jax.jit
def i0(x):
    # Reference uses the Numerical Recipes polynomial (dsc.cpp:1624-1721);
    # jax.scipy's i0 matches np.i0 to well within the 1e-5 test tolerance.
    from jax.scipy.special import i0 as _i0

    return _i0(x)


@partial(jax.jit, static_argnames=())
def clip(x, lo, hi):
    """min(max(x, lo), hi); complex compared by real part with the bound
    replacing the WHOLE value (reference dsc.cpp:1723-1769, dsc_ops.h:318-338).
    ``lo``/``hi`` are scalars already cast to x.dtype by the caller."""
    if jnp.iscomplexobj(x):
        lo_c = jnp.asarray(lo, x.dtype)
        hi_c = jnp.asarray(hi, x.dtype)
        y = jnp.where(jnp.real(x) < jnp.real(lo_c), lo_c, x)
        y = jnp.where(jnp.real(y) > jnp.real(hi_c), hi_c, y)
        return y
    return jnp.clip(x, lo, hi)


# ---------------------------------------------------------------------------
# reductions (reference dsc.cpp:1771-1953)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=('axis', 'keepdims'))
def reduce_sum(x, axis, keepdims):
    return jnp.sum(x, axis=axis, keepdims=keepdims)


@partial(jax.jit, static_argnames=('axis', 'keepdims'))
def reduce_mean(x, axis, keepdims):
    # Reference computes sum * (1/n) (dsc.cpp:1825-1855)
    n = x.shape[axis]
    return jnp.sum(x, axis=axis, keepdims=keepdims) * (1.0 / n)


def _complex_extreme(x, axis, keepdims, is_max):
    """NumPy-compatible lexicographic (real, then imag) complex extremum.

    The reference compares the real part only (dsc_ops.h:318-338) which is
    indistinguishable for continuous data; lexicographic additionally matches
    np.max/np.min bit-for-bit on ties.
    """
    re = jnp.real(x)
    im = jnp.imag(x)
    if is_max:
        mr = jnp.max(re, axis=axis, keepdims=True)
        mi = jnp.max(jnp.where(re == mr, im, -jnp.inf), axis=axis, keepdims=True)
    else:
        mr = jnp.min(re, axis=axis, keepdims=True)
        mi = jnp.min(jnp.where(re == mr, im, jnp.inf), axis=axis, keepdims=True)
    out = jax.lax.complex(mr.astype(re.dtype), mi.astype(im.dtype)).astype(x.dtype)
    if not keepdims:
        out = jnp.squeeze(out, axis=axis)
    return out


@partial(jax.jit, static_argnames=('axis', 'keepdims'))
def reduce_max(x, axis, keepdims):
    if jnp.iscomplexobj(x):
        return _complex_extreme(x, axis, keepdims, is_max=True)
    return jnp.max(x, axis=axis, keepdims=keepdims)


@partial(jax.jit, static_argnames=('axis', 'keepdims'))
def reduce_min(x, axis, keepdims):
    if jnp.iscomplexobj(x):
        return _complex_extreme(x, axis, keepdims, is_max=False)
    return jnp.min(x, axis=axis, keepdims=keepdims)


# ---------------------------------------------------------------------------
# creation / layout helpers
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=('n', 'dtype'))
def arange(n, dtype):
    return jnp.arange(n, dtype=np.dtype(dtype).type(0).real.dtype).astype(dtype)


@partial(jax.jit, static_argnames=('shape', 'dtype'))
def randn(key, shape, dtype):
    dt = np.dtype(dtype)
    if dt.kind == 'c':
        real_dt = np.float32 if dt == np.complex64 else np.float64
        k1, k2 = jax.random.split(key)
        re = jax.random.normal(k1, shape, dtype=real_dt)
        im = jax.random.normal(k2, shape, dtype=real_dt)
        return jax.lax.complex(re, im)
    return jax.random.normal(key, shape, dtype=dt)


@partial(jax.jit, static_argnames=('shape', 'dtype'))
def full(shape, fill_value, dtype):
    return jnp.full(shape, fill_value, dtype=dtype)


@partial(jax.jit, static_argnames=('axes',))
def transpose(x, axes):
    return jnp.transpose(x, axes)


@partial(jax.jit, static_argnames=('axis',))
def concat(arrays, axis):
    if axis is None:
        return jnp.concatenate([a.reshape(-1) for a in arrays])
    return jnp.concatenate(arrays, axis=axis)


@partial(jax.jit, static_argnames=('dtype',))
def cast(x, dtype):
    return x.astype(dtype)
