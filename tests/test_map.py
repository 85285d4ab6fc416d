"""dsc.map (fuse.py): an elementwise Tensor pipeline compiled into one fused
program. Odd and remainder-sized operands, 1-element and broadcast-row
operands, several outputs, non-f32 dtypes and composition under
dsc.compile all give the eager chain's values."""

import numpy as np
import pytest

import dsc_tpu as dsc

from conftest import all_close


def _rand(ne):
    return np.random.default_rng(ne).standard_normal(ne).astype(np.float32)


@pytest.mark.parametrize('ne', [64 * 128 * 2, 64 * 128 * 3,
                                64 * 128 * 2 + 1024, 64 * 128 * 5 + 2048,
                                1024, 1, 12345])
def test_dsc_map_chain_shapes(ne):
    a, b = _rand(ne), _rand(ne + 1)[1:]
    ad, bd = dsc.from_numpy(a), dsc.from_numpy(b)
    fused = dsc.map(lambda x, y: dsc.clip(x * y + 0.5, -1.0, 1.0))
    got = fused(ad, bd)
    want = np.clip(a * b + 0.5, -1.0, 1.0)
    assert got.shape == (ne,) and got.dtype == dsc.Dtype.F32
    assert all_close(got.numpy(), want)
    assert fused.n_programs == 1
    # second call reuses the cached program
    assert all_close(fused(ad, bd).numpy(), want)
    assert fused.n_programs == 1


def test_dsc_map_scalar_and_brow_operands():
    rows, m = 48, 1024
    x = _rand(rows * m).reshape(rows, m)
    row = _rand(m)
    s = np.float32(0.25)
    fused = dsc.map(lambda t, r, k: t * r + k)
    got = fused(dsc.from_numpy(x), dsc.from_numpy(row),
                dsc.from_numpy(np.array([s])))
    assert all_close(got.numpy(), x * row + s)
    # Python scalars baked into the body, both orientations
    rev = dsc.map(lambda t: 2.5 - t * 2.0, dsc.from_numpy(x))
    assert all_close(rev.numpy(), 2.5 - x * 2.0)


def test_dsc_map_multi_output():
    ne = 64 * 128 * 2 + 7
    a, b = _rand(ne), _rand(ne + 1)[1:]
    fused = dsc.map(lambda x, y: (x + y, x * y))
    g1, g2 = fused(dsc.from_numpy(a), dsc.from_numpy(b))
    assert all_close(g1.numpy(), a + b)
    assert all_close(g2.numpy(), a * b)


def test_dsc_map_other_dtypes_and_reductions():
    a = np.random.default_rng(1).standard_normal(4096)  # f64
    got = dsc.map(lambda x: x * 2.0 + 1.0, dsc.from_numpy(a))
    assert got.dtype == dsc.Dtype.F64
    assert all_close(got.numpy(), a * 2.0 + 1.0)
    z = (a + 1j * a[::-1]).astype(np.complex64)
    gz = dsc.map(lambda x: x * x, dsc.from_numpy(z))
    assert all_close(gz.numpy(), z * z)
    af = _rand(64 * 128 * 2)
    red = dsc.map(lambda x: dsc.sum(x, axis=-1, keepdims=True))
    assert all_close(red(dsc.from_numpy(af)).numpy(),
                     af.sum(keepdims=True), eps=1e-4)


def test_dsc_map_immediate_form_and_ndarray_args():
    a = _rand(64 * 128 * 2)
    got = dsc.map(lambda x: dsc.sqrt(dsc.absolute(x)), dsc.from_numpy(a))
    assert all_close(got.numpy(), np.sqrt(np.abs(a)))
    got = dsc.map(lambda x: dsc.exp(x * 0.25), a)
    assert all_close(got.numpy(), np.exp(a * 0.25))
    with pytest.raises(RuntimeError, match='Tensor'):
        dsc.map(lambda x: x, 1.0)


def test_dsc_map_under_compile():
    ne = 64 * 128 * 2
    a, b = _rand(ne), _rand(ne + 1)[1:]
    fused = dsc.map(lambda x, y: dsc.clip(x * y + 0.5, -1.0, 1.0))

    @dsc.compile
    def pipe(x, y):
        return fused(x, y) * 2.0

    got = pipe(dsc.from_numpy(a), dsc.from_numpy(b)).numpy()
    assert all_close(got, np.clip(a * b + 0.5, -1.0, 1.0) * 2.0)
