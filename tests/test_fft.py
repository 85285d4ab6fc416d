"""FFT engine vs np.fft (reference test_ops.py:458-523) plus plan-cache and
large-N four-step coverage (BASELINE.md configs)."""

import random

import numpy as np

import dsc_tpu as dsc
from dsc_tpu.fourier import plan as fft_plan

from conftest import DSC_DTYPES, DTYPES, all_close, random_nd


def test_fft():
    ops = {
        'fft': ((np.fft.fft, np.fft.ifft), (dsc.fft, dsc.ifft)),
        'rfft': ((np.fft.rfft, np.fft.irfft), (dsc.rfft, dsc.irfft)),
    }
    n_ = random.randint(3, 8)
    n = 2**n_

    for axis in range(4):
        shape = [4] * 4
        shape[axis] = n
        for n_change in range(-1, 2):
            for op_name, ((np_fft, np_ifft), (dsc_fft, dsc_ifft)) in ops.items():
                # n_change = -1 -> crop, 0 -> copy, +1 -> pad
                fft_n = 2 ** (n_ + n_change)
                x = random_nd(shape)
                x_dsc = dsc.from_numpy(x)

                x_np_fft = np_fft(x, n=fft_n, axis=axis)
                x_dsc_fft = dsc_fft(x_dsc, n=fft_n, axis=axis)
                assert all_close(x_dsc_fft.numpy(), x_np_fft), (op_name, axis, fft_n)

                x_np_ifft = np_ifft(x_np_fft, axis=axis)
                x_dsc_ifft = dsc_ifft(x_dsc_fft, axis=axis)
                assert all_close(x_dsc_ifft.numpy(), x_np_ifft), (op_name, axis)


def test_fft_dtypes():
    for dtype in DTYPES:
        x = random_nd([4, 64], dtype=dtype)
        x_dsc = dsc.from_numpy(x)
        assert all_close(dsc.fft(x_dsc).numpy(), np.fft.fft(x))
        assert all_close(dsc.ifft(x_dsc).numpy(), np.fft.ifft(x))
        if np.dtype(dtype).kind == 'f':
            got = dsc.rfft(x_dsc)
            ref = np.fft.rfft(x)
            assert all_close(got.numpy(), ref)
            # output dtype rule F32->C32 / F64->C64 (dsc.cpp:2207-2224)
            expected = dsc.Dtype.C32 if dtype == np.float32 else dsc.Dtype.C64
            assert got.dtype == expected
            back = dsc.irfft(got)
            assert all_close(back.numpy(), np.fft.irfft(ref))
            assert back.dtype == DSC_DTYPES[dtype]


def test_fft_non_pow2_rounds_up():
    # sizes silently round up to pow2 with zero-padding (dsc.cpp:2023-2028)
    x = random_nd([48], np.float32)
    x_dsc = dsc.from_numpy(x)
    got = dsc.fft(x_dsc)
    ref = np.fft.fft(x, n=64)
    assert got.shape == (64,)
    assert all_close(got.numpy(), ref)

    got_r = dsc.rfft(x_dsc)
    ref_r = np.fft.rfft(x, n=64)
    assert got_r.shape == (33,)
    assert all_close(got_r.numpy(), ref_r)


def test_fft_large_four_step():
    # Exercises the Bailey four-step factorization (> BASE_MAX)
    n = 4 * fft_plan.BASE_MAX
    x = random_nd([n], np.float32)
    x_dsc = dsc.from_numpy(x)
    ref = np.fft.rfft(x)
    got = dsc.rfft(x_dsc).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() / scale < 1e-5
    back = dsc.irfft(dsc.rfft(x_dsc)).numpy()
    assert np.abs(back - x).max() < 1e-4

    c = random_nd([2, n], np.complex64)
    c_dsc = dsc.from_numpy(c)
    ref_c = np.fft.fft(c, axis=-1)
    got_c = dsc.fft(c_dsc).numpy()
    assert np.abs(got_c - ref_c).max() / max(np.abs(ref_c).max(), 1.0) < 1e-5


def test_plan_cache_lru_stress():
    # >16 distinct plans must keep working via LRU eviction
    # (reference dsc.cpp:182-267; BASELINE.md config 3)
    fft_plan.clear_plans()
    sizes = [2**k for k in range(3, 12)]  # 9 sizes x complex/real = 18 plans
    for n in sizes:
        x = dsc.from_numpy(random_nd([n], np.float32))
        assert all_close(dsc.fft(x, n=n).numpy(), np.fft.fft(x.numpy(), n=n))
        assert all_close(dsc.rfft(x, n=n).numpy(), np.fft.rfft(x.numpy(), n=n))
    assert fft_plan.num_plans() <= fft_plan.MAX_FFT_PLANS
    # evicted plans rebuild transparently
    x = dsc.from_numpy(random_nd([8], np.float32))
    assert all_close(dsc.fft(x).numpy(), np.fft.fft(x.numpy()))


def test_plan_fft_warms_cache():
    fft_plan.clear_plans()
    dsc.plan_fft(1024, dsc.Dtype.F32)
    assert fft_plan.num_plans() == 1
    dsc.plan_fft(1000, dsc.Dtype.F32)  # rounds up to 1024 -> cache hit
    assert fft_plan.num_plans() == 1


def test_fftfreq():
    for _ in range(5):
        n = random.randint(1, 10_000)
        for dtype in DTYPES:
            if np.dtype(dtype).kind == 'c':
                continue
            assert all_close(
                dsc.rfftfreq(n, dtype=DSC_DTYPES[dtype]).numpy(),
                np.fft.rfftfreq(n).astype(dtype),
            )
            d = random.random()
            assert all_close(
                dsc.rfftfreq(n, d, dtype=DSC_DTYPES[dtype]).numpy(),
                np.fft.rfftfreq(n, d).astype(dtype),
            )
            assert all_close(
                dsc.fftfreq(n, dtype=DSC_DTYPES[dtype]).numpy(),
                np.fft.fftfreq(n).astype(dtype),
            )
            d = random.random()
            assert all_close(
                dsc.fftfreq(n, d, dtype=DSC_DTYPES[dtype]).numpy(),
                np.fft.fftfreq(n, d).astype(dtype),
            )


def test_filter_fft_pipeline():
    # The README filterFFT example (reference README.md:110-137): FFT-based
    # convolution via rfft x rfft -> irfft -> slice. This is the framework's
    # "one model end-to-end" slice (SURVEY §7.2 M3).
    n = 2**12
    taps = 63
    sig = random_nd([n], np.float32)
    filt = random_nd([taps], np.float32)

    out_len = n + taps - 1
    fft_n = 1 << (out_len - 1).bit_length()

    sig_d = dsc.from_numpy(sig)
    filt_d = dsc.from_numpy(filt)
    spec = dsc.rfft(sig_d, n=fft_n) * dsc.rfft(filt_d, n=fft_n)
    conv = dsc.irfft(spec)[:out_len]

    ref = np.convolve(sig, filt)
    assert np.abs(conv.numpy() - ref).max() < 1e-3 * max(np.abs(ref).max(), 1.0)


def test_fft2_family():
    """2-D transforms vs np.fft (composition of the 1-D engine)."""
    x = random_nd([3, 16, 32])
    xd = dsc.from_numpy(x)

    assert all_close(dsc.fft2(xd).numpy(), np.fft.fft2(x))
    assert all_close(dsc.ifft2(xd).numpy(), np.fft.ifft2(x))
    assert all_close(dsc.rfft2(xd).numpy(), np.fft.rfft2(x))

    z = np.fft.rfft2(x)
    zd = dsc.rfft2(xd)
    assert all_close(dsc.irfft2(zd).numpy(), np.fft.irfft2(z))
    # round trip recovers the input
    assert all_close(dsc.irfft2(zd).numpy(), x)

    # explicit sizes (pad) and non-default axes
    assert all_close(
        dsc.fft2(xd, s=(32, 64)).numpy(), np.fft.fft2(x, s=(32, 64))
    )
    # non-default axes (axis 0 has size 3 -> dsc pads to the next pow2, 4)
    assert all_close(
        dsc.fft2(xd, axes=(0, 2)).numpy(),
        np.fft.fft2(x, s=(4, 32), axes=(0, 2)),
    )
    # the dsc pow2 rule: a non-pow2 size request rounds up
    assert all_close(
        dsc.rfft2(xd, s=(20, 48)).numpy(), np.fft.rfft2(x, s=(32, 64))
    )


def test_windows():
    """Window generators vs their np oracles (kaiser rides dsc.i0)."""
    for n in (1, 2, 64, 255):
        assert all_close(dsc.hanning(n).numpy(), np.hanning(n).astype(np.float32))
        assert all_close(dsc.hamming(n).numpy(), np.hamming(n).astype(np.float32))
        assert all_close(dsc.blackman(n).numpy(), np.blackman(n).astype(np.float32))
        for beta in (0.0, 5.0, 14.0):
            assert all_close(
                dsc.kaiser(n, beta).numpy(),
                np.kaiser(n, beta).astype(np.float32),
            ), (n, beta)
    assert dsc.hanning(0).shape == (0,)
    assert all_close(
        dsc.blackman(64, dtype=dsc.Dtype.F64).numpy(), np.blackman(64)
    )


def test_bartlett_tukey_windows():
    import scipy.signal.windows as spw

    for n in (1, 2, 64, 255):
        assert all_close(dsc.bartlett(n).numpy(),
                         np.bartlett(n).astype(np.float32))
        for alpha in (0.0, 0.25, 0.5, 1.0):
            assert all_close(
                dsc.tukey(n, alpha).numpy(),
                spw.tukey(n, alpha, sym=True).astype(np.float32),
            ), (n, alpha)
    import pytest

    with pytest.raises(RuntimeError):
        dsc.tukey(64, 1.5)


def test_custom_window_in_stft():
    """STFT/ISTFT accept a dsc Tensor window (e.g. kaiser) and still
    reconstruct exactly where the window coverage is nonzero."""
    from dsc_tpu.models import ISTFT, STFT

    frame, hop, n = 256, 64, 4096
    win = dsc.kaiser(frame, 9.0)
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    xd = dsc.from_numpy(x)
    z = STFT(frame=frame, hop=hop, window=win, mode='complex')(xd)
    y = ISTFT(frame=frame, hop=hop, window=win)(z)
    got = y.numpy()[: n - frame]  # skip the uncovered tail
    assert all_close(got[frame:], x[frame : n - frame], eps=1e-4)
