"""Multi-device sharding tests on the 8-way virtual CPU mesh
(SURVEY §4 implication: xla_force_host_platform_device_count simulation)."""

import jax
import numpy as np
import pytest

from dsc_tpu.parallel import (
    distributed_fft,
    distributed_fft_stream,
    distributed_irfft_stream,
    distributed_rfft_stream,
    make_mesh,
    shard_batch,
    sharded_batched_fft,
    sharded_batched_rfft,
)

from conftest import all_close


@pytest.fixture
def needs_devices():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')


@pytest.mark.usefixtures('needs_devices')
def test_sharded_batched_fft():
    mesh = make_mesh((8, 1))
    x = (np.random.randn(16, 256) + 1j * np.random.randn(16, 256)).astype(
        np.complex64
    )
    xd = shard_batch(jax.numpy.asarray(x), mesh)
    got = np.asarray(sharded_batched_fft(xd, mesh))
    assert all_close(got, np.fft.fft(x, axis=-1))
    got_inv = np.asarray(sharded_batched_fft(xd, mesh, inverse=True))
    assert all_close(got_inv, np.fft.ifft(x, axis=-1))


@pytest.mark.usefixtures('needs_devices')
def test_distributed_fft_all_to_all():
    # one FFT factorized over the 'model' axis with an all_to_all exchange
    mesh = make_mesh((1, 8), axis_names=('data', 'model'))
    n = 4096  # n1=64, n2=64, both divisible by 8
    x = (np.random.randn(2, n) + 1j * np.random.randn(2, n)).astype(np.complex64)
    got = np.asarray(distributed_fft(jax.numpy.asarray(x), mesh))
    ref = np.fft.fft(x, axis=-1)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() / scale < 1e-5

    got_inv = np.asarray(
        distributed_fft(jax.numpy.asarray(ref.astype(np.complex64)), mesh,
                        inverse=True)
    )
    assert all_close(got_inv, x, eps=1e-4)


@pytest.mark.usefixtures('needs_devices')
def test_distributed_fft_stream_2_20():
    # one large vector with the four-step sharded: local column FFTs ->
    # all_to_all -> local row FFTs (realistic size, 2^20)
    mesh = make_mesh((2, 4), axis_names=('data', 'model'))
    n = 2**20  # factors 1024 x 1024, 256-column local blocks over d=4
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    got = np.asarray(distributed_fft_stream(jax.numpy.asarray(x), mesh))
    ref = np.fft.fft(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4

    back = np.asarray(
        distributed_fft_stream(
            jax.numpy.asarray(ref.astype(np.complex64)), mesh, inverse=True
        )
    )
    assert np.abs(back - x).max() < 1e-4


@pytest.mark.usefixtures('needs_devices')
def test_sharded_batched_streaming_rfft():
    # DP rfft where each device runs the large-n engine on its rows
    mesh = make_mesh((8, 1))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 2**18)).astype(np.float32)
    got = np.asarray(sharded_batched_rfft(jax.numpy.asarray(x), mesh))
    ref = np.fft.rfft(x, axis=-1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


@pytest.mark.usefixtures('needs_devices')
def test_distributed_rfft_stream_2_20():
    # the flagship REAL transform sharded over the mesh: half-size
    # even/odd packing on the sharded four-step + Hermitian untangle
    mesh = make_mesh((4, 2), axis_names=('data', 'model'))
    n = 2**20  # half-size factors 512 x 1024, divisible by d=2
    rng = np.random.default_rng(9)
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(distributed_rfft_stream(jax.numpy.asarray(x), mesh))
    ref = np.fft.rfft(x)
    assert got.shape == (n // 2 + 1,)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4

    back = np.asarray(distributed_irfft_stream(
        jax.numpy.asarray(ref.astype(np.complex64)), mesh))
    assert back.shape == (n,)
    assert np.abs(back - x).max() < 1e-4


@pytest.mark.usefixtures('needs_devices')
@pytest.mark.slow
def test_distributed_rfft_stream_model4():
    # 4-way transform sharding: both half-size factors divisible by 4
    mesh = make_mesh((2, 4), axis_names=('data', 'model'))
    n = 2**21
    rng = np.random.default_rng(10)
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(distributed_rfft_stream(jax.numpy.asarray(x), mesh))
    ref = np.fft.rfft(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    back = np.asarray(distributed_irfft_stream(
        jax.numpy.asarray(got.astype(np.complex64)), mesh, axis='model'))
    assert np.abs(back - x).max() < 1e-4


@pytest.mark.usefixtures('needs_devices')
def test_distributed_fft_2d_mesh():
    # dp x tp at once: batch on 'data', transform on 'model'
    mesh = make_mesh((2, 4), axis_names=('data', 'model'))
    n = 1024  # n1=32, n2=32, divisible by 4
    x = (np.random.randn(4, n) + 1j * np.random.randn(4, n)).astype(np.complex64)
    got = np.asarray(distributed_fft(jax.numpy.asarray(x), mesh))
    ref = np.fft.fft(x, axis=-1)
    assert np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0) < 1e-5
