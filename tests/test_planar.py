"""Planar complex storage (planar.py) and the public FFT paths around it.

The public dsc.fft/rfft family returns dense complex tensors; the model
tier (here: the exact-length transforms, dsc_tpu.transforms) returns its
spectra as planar float planes. These tests pin the values, dtypes and
shapes of both at 2^18 points, and that elementwise ops keep planar
operands planar."""

import numpy as np
import pytest

import dsc_tpu as dsc
from dsc_tpu import transforms as tf

from conftest import all_close

N = 2**18


@pytest.fixture(scope='module')
def sig():
    rng = np.random.default_rng(7)
    return rng.standard_normal(N).astype(np.float32)


def _rfft(x_np):
    return dsc.rfft(dsc.from_numpy(x_np))


def _planar_rfft(x_np):
    """A planar spectrum from the model tier."""
    spec = tf.rfft(dsc.from_numpy(x_np))
    assert spec._planar is not None
    return spec


def test_rfft_returns_planar_hermitian(sig):
    ref = np.fft.rfft(sig)
    for spec in (_rfft(sig), _planar_rfft(sig)):
        assert spec.dtype == dsc.Dtype.C32
        assert spec.shape == (N // 2 + 1,)
        err = np.abs(spec.numpy() - ref).max() / np.abs(ref).max()
        assert err < 3e-5
    assert _rfft(sig)._planar is None  # the public engine is dense


def test_planar_roundtrip_no_reconstruct(sig):
    for spec in (_rfft(sig), _planar_rfft(sig)):
        back = dsc.irfft(spec)
        assert back.dtype == dsc.Dtype.F32
        assert back.shape == (N,)
        assert np.abs(back.numpy() - sig).max() < 1e-4


def test_planar_pow_drops_hermitian(sig):
    # pow on spectra runs the exp(b*log a) formula on dense and planar
    # storage alike; planar operands stay planar
    ref = np.fft.rfft(sig).astype(np.complex64) ** 2.0
    denom = np.abs(ref).max()
    for spec in (_rfft(sig), _planar_rfft(sig)):
        sq = dsc.power(spec, 2.0)
        assert (sq._planar is None) == (spec._planar is None)
        assert np.abs(sq.numpy() - ref).max() / denom < 1e-4
    # batched spectra
    xb = np.stack([sig, sig[::-1].copy()])
    refb = np.fft.rfft(xb, axis=-1).astype(np.complex64) ** 2.0
    sqb = dsc.power(_planar_rfft(xb), 2.0)
    assert sqb._planar is not None
    assert np.abs(sqb.numpy() - refb).max() / np.abs(refb).max() < 1e-4


def test_planar_binary_ops_stay_planar(sig):
    rng = np.random.default_rng(8)
    ker = rng.standard_normal(N).astype(np.float32)
    sa, sb = _planar_rfft(sig), _planar_rfft(ker)
    prod = sa * sb
    assert prod._planar is not None
    ref = np.fft.rfft(sig) * np.fft.rfft(ker)
    assert np.abs(prod.numpy() - ref).max() / np.abs(ref).max() < 1e-4
    # the filterFFT chain: multiply then invert
    ref_conv = np.fft.irfft(ref)
    conv_scale = max(np.abs(ref_conv).max(), 1.0)
    for p in (prod, _rfft(sig) * _rfft(ker)):
        conv = dsc.irfft(p)
        assert np.abs(conv.numpy() - ref_conv).max() / conv_scale < 1e-4
    # op-level oracle: compare against NumPy applied to the SAME operand
    # values (comparing against np.fft quotients would measure FFT error
    # amplification near small denominators, not the op)
    na, nb = sa.numpy(), sb.numpy()
    for op, npop in [
        (lambda a, b: a + b, np.add),
        (lambda a, b: a - b, np.subtract),
        (lambda a, b: a / b, np.true_divide),
    ]:
        got = op(sa, sb)
        assert got._planar is not None
        assert all_close(got.numpy(), npop(na, nb))
    # planar x dense mixes densify with the same values
    mixed = sa * _rfft(ker)
    assert mixed._planar is None
    assert np.abs(mixed.numpy() - ref).max() / np.abs(ref).max() < 1e-4


def test_planar_scalar_ops(sig):
    spec = _planar_rfft(sig)
    ref = np.fft.rfft(sig)
    scale = np.abs(ref).max()
    half = spec * 0.5
    assert half._planar is not None
    assert np.abs(half.numpy() - ref * 0.5).max() / scale < 1e-4
    # reversed orientation
    rsub = 1.0 - spec
    assert rsub._planar is not None
    assert np.abs(rsub.numpy() - (1.0 - ref)).max() / scale < 1e-4
    # complex scalars stay on the planes too
    rot = spec * 1j
    assert rot._planar is not None
    assert np.abs(rot.numpy() - ref * 1j).max() / scale < 1e-4
    back = dsc.irfft(rot)
    assert np.abs(back.numpy() - np.fft.irfft(ref * 1j)).max() < 1e-3


def test_planar_unary_ops(sig):
    ref = np.fft.rfft(sig)
    scale = np.abs(ref).max()
    for spec in (_rfft(sig), _planar_rfft(sig)):
        c = dsc.conj(spec)
        assert (c._planar is None) == (spec._planar is None)
        assert np.abs(c.numpy() - np.conj(ref)).max() / scale < 3e-5
        for fn, want in [
            (dsc.real, ref.real),
            (dsc.imag, ref.imag),
            (dsc.absolute, np.abs(ref)),
            (dsc.angle, np.angle(ref)),
        ]:
            got = fn(spec)
            assert got.dtype == dsc.Dtype.F32
            assert got.shape == (N // 2 + 1,)
            if fn is dsc.angle:
                # angle is ill-conditioned near |z|=0; compare via the phasor
                assert all_close(
                    np.exp(1j * got.numpy().astype(np.complex64)),
                    np.exp(1j * want.astype(np.complex64)), eps=1e-2)
            else:
                assert np.abs(got.numpy() - want).max() / scale < 1e-4


def test_planar_materialization_fallbacks(sig):
    spec = _planar_rfft(sig)
    ref = np.fft.rfft(sig)
    # indexing materializes dense complex
    assert abs(complex(spec[0]) - ref[0]) / np.abs(ref).max() < 1e-4
    window = spec[10:20]
    assert all_close(window.numpy(), ref[10:20].astype(np.complex64),
                     eps=1e-2)
    # reductions materialize too
    s = dsc.sum(spec)
    assert abs(complex(s[0]) - ref.sum()) / np.abs(ref.sum()) < 1e-3
    # setitem densifies the buffer; values stay consistent
    spec[0] = 0
    assert spec._planar is None
    got = spec.numpy()
    assert got[0] == 0
    assert all_close(got[1:], ref[1:].astype(np.complex64), eps=1e-2)


def test_batched_planar_paths(sig):
    b = 2
    xs = np.stack([sig, sig[::-1].copy()])
    ref = np.fft.rfft(xs, axis=-1)
    for spec in (dsc.rfft(dsc.from_numpy(xs)), _planar_rfft(xs)):
        assert spec.shape == (b, N // 2 + 1)
        assert np.abs(spec.numpy() - ref).max() / np.abs(ref).max() < 3e-5
        back = dsc.irfft(spec)
        assert back.shape == (b, N)
        assert np.abs(back.numpy() - xs).max() < 1e-4
    # batched complex fft
    xc = (xs[0] + 1j * xs[1]).astype(np.complex64)
    xcb = np.stack([xc, 2 * xc])
    y = dsc.fft(dsc.from_numpy(xcb))
    assert y.dtype == dsc.Dtype.C32 and y.shape == (b, N)
    refc = np.fft.fft(xcb, axis=-1)
    assert np.abs(y.numpy() - refc).max() / np.abs(refc).max() < 3e-5


def test_planar_fft_ifft_chain(sig):
    x = (sig + 1j * sig[::-1]).astype(np.complex64)
    ref = np.fft.fft(x)
    y = dsc.fft(dsc.from_numpy(x))
    assert np.abs(y.numpy() - ref).max() / np.abs(ref).max() < 3e-5
    back = dsc.ifft(y)
    assert back.dtype == dsc.Dtype.C32
    assert np.abs(back.numpy() - x).max() < 1e-3
    # planar input (model-tier spectrum) through the public engine
    yp = tf.fft(dsc.from_numpy(x))
    assert yp._planar is not None
    backp = dsc.ifft(yp)
    assert np.abs(backp.numpy() - x).max() < 1e-3
    # real input through fft
    yr = dsc.fft(dsc.from_numpy(sig))
    refr = np.fft.fft(sig)
    assert np.abs(yr.numpy() - refr).max() / np.abs(refr).max() < 3e-5
