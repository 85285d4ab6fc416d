"""The transform-sharded FFTs (parallel/sharded_fft.py) on 4 of the virtual
CPU devices: each device runs the plain single-device engine inside
shard_map and the four-step transpose is one all_to_all. Results must match
NumPy and stay sharded over all 4 devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsc_tpu.parallel import sharded_fft
from dsc_tpu.parallel import (
    distributed_fft,
    distributed_fft_stream,
    distributed_irfft_stream,
    distributed_rfft_stream,
    make_mesh,
)


@pytest.fixture
def mesh4():
    devs = jax.devices()[:4]
    if len(devs) < 4:
        pytest.skip('needs 4 (virtual) devices')
    return make_mesh((1, 4), devices=devs)


def _rel(got, ref):
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _spans4(arr):
    return len(arr.sharding.device_set) == 4


@pytest.mark.parametrize('dtype,tol', [(np.complex64, 1e-5),
                                       (np.complex128, 1e-12)])
def test_distributed_fft_stream_4dev(mesh4, dtype, tol):
    n = 2**16
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(dtype)
    got = distributed_fft_stream(jnp.asarray(x), mesh4)
    assert got.shape == (n,) and got.dtype == dtype
    assert _spans4(got)
    ref = np.fft.fft(x.astype(np.complex128))
    assert _rel(got, ref) < tol
    back = distributed_fft_stream(got, mesh4, inverse=True)
    assert _spans4(back)
    assert _rel(back, x) < tol


def test_distributed_rfft_irfft_stream_4dev(mesh4):
    n = 2**17  # half-size 2^16 = 256 x 256, both divisible by 4
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    spec = distributed_rfft_stream(jnp.asarray(x), mesh4)
    assert spec.shape == (n // 2 + 1,) and spec.dtype == np.complex64
    assert len(spec.sharding.device_set) == 4
    assert _rel(spec, np.fft.rfft(x.astype(np.float64))) < 1e-5
    back = distributed_irfft_stream(spec, mesh4)
    assert back.shape == (n,) and back.dtype == np.float32
    assert _spans4(back)
    assert _rel(back, x) < 1e-5


def test_distributed_fft_rows_4dev(mesh4):
    b, n = 3, 2**12
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((b, n))
         + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    got = distributed_fft(jnp.asarray(x), mesh4)
    assert _spans4(got)
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=-1)) < 1e-5
    back = distributed_fft(got, mesh4, inverse=True)
    assert _rel(back, x) < 1e-5
    # repeat calls reuse the cached program and tables: no rebuild
    hits = sharded_fft._dist_program.cache_info().hits
    distributed_fft(jnp.asarray(x), mesh4)
    assert sharded_fft._dist_program.cache_info().hits == hits + 1


def test_distributed_stream_input_checks(mesh4):
    with pytest.raises(RuntimeError, match='single'):
        distributed_fft_stream(jnp.zeros((2, 64), jnp.complex64), mesh4)
    with pytest.raises(RuntimeError, match='single'):
        distributed_rfft_stream(jnp.zeros((2, 64), jnp.float32), mesh4)
    with pytest.raises(RuntimeError, match='even'):
        distributed_rfft_stream(jnp.zeros(1023, jnp.float32), mesh4)
    with pytest.raises(RuntimeError, match='divisible'):
        distributed_fft_stream(jnp.zeros(8, jnp.complex64), mesh4)
