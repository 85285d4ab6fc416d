"""The public FFT family at sizes users run (2^18 - 2^20 points): values,
dtypes and shapes against NumPy, including the large-n paths of the engine
(four-step splits, full-size real transforms, the Hermitian reconstruction
of irfft) and transforms over a non-last axis."""

import numpy as np
import pytest

import dsc_tpu as dsc
from dsc_tpu.fourier import plan as fft_plan

SIZES = [2**18, 2**19, 2**20]


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('n', SIZES)
def test_fft_ifft_complex64(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    y = dsc.fft(dsc.from_numpy(x))
    assert y.dtype == dsc.Dtype.C32 and y.shape == (n,)
    assert _rel(y.numpy(), np.fft.fft(x.astype(np.complex128))) < 3e-5
    back = dsc.ifft(y)
    assert _rel(back.numpy(), x) < 3e-5


@pytest.mark.parametrize('n', SIZES)
def test_rfft_irfft_float32(n):
    assert n > fft_plan.RFFT_PACK_MAX  # the full-size real engine
    x = np.random.default_rng(n + 1).standard_normal(n).astype(np.float32)
    spec = dsc.rfft(dsc.from_numpy(x))
    assert spec.dtype == dsc.Dtype.C32 and spec.shape == (n // 2 + 1,)
    assert _rel(spec.numpy(), np.fft.rfft(x.astype(np.float64))) < 3e-5
    back = dsc.irfft(spec)
    assert back.dtype == dsc.Dtype.F32 and back.shape == (n,)
    assert _rel(back.numpy(), x) < 3e-5


def test_irfft_reconstructs_from_exact_half_spectrum():
    # a spectrum made on the host (not by dsc.rfft) through irfft's
    # Hermitian reconstruction; imaginary DC/Nyquist parts are ignored
    n = 2**18
    x = np.random.default_rng(5).standard_normal(n)
    half = np.fft.rfft(x).astype(np.complex64)
    got = dsc.irfft(dsc.from_numpy(half)).numpy()
    assert _rel(got, x) < 3e-5


@pytest.mark.parametrize('shape,axis', [((2**17, 4), 0), ((4, 2**17), 1),
                                        ((3, 2**17, 2), 1)])
def test_batched_large_over_any_axis(shape, axis):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    spec = dsc.rfft(dsc.from_numpy(x), axis=axis)
    ref = np.fft.rfft(x.astype(np.float64), axis=axis)
    assert spec.shape == ref.shape
    assert _rel(spec.numpy(), ref) < 3e-5
    back = dsc.irfft(spec, axis=axis)
    assert _rel(back.numpy(), x) < 3e-5
    z = (x + 1j * x[::-1]).astype(np.complex64)
    y = dsc.fft(dsc.from_numpy(z), axis=axis)
    assert _rel(y.numpy(), np.fft.fft(z.astype(np.complex128), axis=axis)) < 3e-5


def test_pad_crop_to_pow2_at_large_n():
    # sizes round up to the next power of two (reference dsc.cpp:2023-2028)
    n = 2**18 + 3
    x = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    spec = dsc.rfft(dsc.from_numpy(x))
    assert spec.shape == (2**19 // 2 + 1,)
    ref = np.fft.rfft(x.astype(np.float64), n=2**19)
    assert _rel(spec.numpy(), ref) < 3e-5
    crop = dsc.fft(dsc.from_numpy(x.astype(np.complex64)), n=2**18)
    assert _rel(crop.numpy(), np.fft.fft(x[:2**18].astype(np.complex128))) < 3e-5


def test_complex128_large():
    n = 2**19
    rng = np.random.default_rng(11)
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = dsc.fft(dsc.from_numpy(z))
    assert y.dtype == dsc.Dtype.C64
    assert _rel(y.numpy(), np.fft.fft(z)) < 1e-12
    assert _rel(dsc.ifft(y).numpy(), z) < 1e-12
