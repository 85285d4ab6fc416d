"""Op-level correctness vs NumPy — the executable specification
(reference python/tests/test_ops.py; same oracle strategy, SURVEY §4)."""

import random
from itertools import permutations

import numpy as np
import pytest

import dsc_tpu as dsc

from conftest import DSC_DTYPES, DTYPES, all_close, random_nd


class TestOps:
    def test_binary(self):
        ops = {
            'add': (np.add, dsc.add, '+'),
            'sub': (np.subtract, dsc.sub, '-'),
            'mul': (np.multiply, dsc.mul, '*'),
            'div': (np.true_divide, dsc.true_div, '/'),
            'power': (np.power, dsc.power, '**'),
        }
        for op_name, (np_op, dsc_op, symbol) in ops.items():
            for dtype in DTYPES:
                shape = [random.randint(2, 10) for _ in range(4)]

                x = random_nd(shape, dtype=dtype)
                x_dsc = dsc.from_numpy(x)

                # Same shape
                y = random_nd(shape, dtype=dtype)
                y_dsc = dsc.from_numpy(y)

                assert all_close(dsc_op(x_dsc, y_dsc).numpy(), np_op(x, y))
                r_np = eval(f'y {symbol} x')
                r_dsc = eval(f'y_dsc {symbol} x_dsc')
                assert all_close(r_dsc.numpy(), r_np)

                # Broadcasting (collapse one random dim)
                shape_b = list(shape)
                shape_b[random.randint(0, 3)] = 1
                y_b = random_nd(shape_b, dtype=dtype)
                y_dsc_b = dsc.from_numpy(y_b)
                assert all_close(dsc_op(x_dsc, y_dsc_b).numpy(), np_op(x, y_b))
                r_np_b = eval(f'y_b {symbol} x')
                r_dsc_b = eval(f'y_dsc_b {symbol} x_dsc')
                assert all_close(r_dsc_b.numpy(), r_np_b)

                # Scalar (incl. reflected operators)
                if np.dtype(dtype).kind == 'c':
                    y_s = complex(random.random(), random.random())
                else:
                    y_s = random.random()
                assert all_close(dsc_op(x_dsc, y_s).numpy(), np_op(x, y_s))
                r_np_s = eval(f'y_s {symbol} x')
                r_dsc_s = eval(f'y_s {symbol} x_dsc')
                assert all_close(r_dsc_s.numpy(), r_np_s)

    def test_binary_out(self):
        for dtype in DTYPES:
            x = random_nd([4, 6], dtype=dtype)
            y = random_nd([4, 6], dtype=dtype)
            x_dsc, y_dsc = dsc.from_numpy(x), dsc.from_numpy(y)
            out = dsc.zeros((4, 6), dtype=DSC_DTYPES[dtype])
            res = dsc.add(x_dsc, y_dsc, out=out)
            assert all_close(out.numpy(), x + y)
            assert all_close(res.numpy(), x + y)

    def test_out_across_op_classes(self):
        # out= on binary, unary and reductions, every dtype (the reference
        # benchmarks lean on out= for all three classes,
        # bench_simple.py:76-193); writes propagate through views
        for dtype in DTYPES:
            dt = DSC_DTYPES[dtype]
            x = random_nd([4, 6], dtype=dtype)
            y = random_nd([4, 6], dtype=dtype)
            x_dsc, y_dsc = dsc.from_numpy(x), dsc.from_numpy(y)

            out = dsc.zeros((4, 6), dtype=dt)
            view = out.reshape(24)  # out= must write through shared buffers
            for dfn, nfn in [
                (dsc.sub, np.subtract),
                (dsc.mul, np.multiply),
                (dsc.true_div, np.true_divide),
                (dsc.power, np.power),
            ]:
                dfn(x_dsc, y_dsc, out=out)
                want = nfn(x, y)
                assert all_close(out.numpy(), want)
                assert all_close(view.numpy(), want.reshape(-1))

            dsc.exp(x_dsc, out=out)
            assert all_close(out.numpy(), np.exp(x))
            dsc.cos(x_dsc, out=out)
            assert all_close(out.numpy(), np.cos(x))

            rout = dsc.zeros((4, 1), dtype=dt)
            dsc.sum(x_dsc, out=rout, axis=-1, keepdims=True)
            assert all_close(rout.numpy(), x.sum(axis=-1, keepdims=True))
            dsc.mean(x_dsc, out=rout, axis=-1, keepdims=True)
            assert all_close(rout.numpy(), x.mean(axis=-1, keepdims=True))

    def test_out_complex_on_default_device(self):
        # complex out= exercises the _finish write-through path on the
        # default device
        x = random_nd([8, 128], dtype=np.complex64)
        y = random_nd([8, 128], dtype=np.complex64)
        x_dsc, y_dsc = dsc.from_numpy(x), dsc.from_numpy(y)
        out = dsc.zeros((8, 128), dtype=dsc.Dtype.C32)
        dsc.mul(x_dsc, y_dsc, out=out)
        assert all_close(out.numpy(), x * y)

    def test_promotion_table(self):
        # The reference's exact table (dsc_dtype.h:73-78), incl. the
        # F64 x C32 -> C32 quirk.
        cases = {
            (np.float32, np.float64): dsc.Dtype.F64,
            (np.float64, np.complex64): dsc.Dtype.C32,
            (np.float32, np.complex64): dsc.Dtype.C32,
            (np.float64, np.complex128): dsc.Dtype.C64,
            (np.complex64, np.complex128): dsc.Dtype.C64,
        }
        for (da, db), expected in cases.items():
            a = dsc.from_numpy(random_nd([4], da))
            b = dsc.from_numpy(random_nd([4], db))
            assert (a + b).dtype == expected
            assert (b + a).dtype == expected
        # Python scalar rules (reference tensor.py:438-448)
        f32 = dsc.from_numpy(random_nd([4], np.float32))
        assert (f32 + 1.5).dtype == dsc.Dtype.F32
        assert (f32 + (1 + 2j)).dtype == dsc.Dtype.C32

    def test_unary(self):
        ops = {
            'sin': (np.sin, dsc.sin),
            'sinc': (np.sinc, dsc.sinc),
            'cos': (np.cos, dsc.cos),
            'logn': (np.log, dsc.logn),
            'log2': (np.log2, dsc.log2),
            'log10': (np.log10, dsc.log10),
            'exp': (np.exp, dsc.exp),
            'sqrt': (np.sqrt, dsc.sqrt),
            'absolute': (np.absolute, dsc.absolute),
            'angle': (np.angle, dsc.angle),
            'conj': (np.conj, dsc.conj),
            'real': (np.real, dsc.real),
            'imag': (np.imag, dsc.imag),
            'i0': (np.i0, dsc.i0),
        }
        for op_name, (np_op, dsc_op) in ops.items():
            for dtype in DTYPES:
                if op_name == 'i0' and np.dtype(dtype).kind == 'c':
                    continue
                x = random_nd([random.randint(1, 10) for _ in range(4)], dtype=dtype)
                if op_name == 'i0':
                    x = np.abs(x)
                x_dsc = dsc.from_numpy(x)
                assert all_close(dsc_op(x_dsc).numpy(), np_op(x)), (
                    op_name,
                    dtype.__name__,
                )

    def test_complex_unary_branch_cuts(self):
        # the complex transcendentals run as explicit real formulas — pin
        # the NumPy branch-cut behavior they must reproduce: negative reals,
        # pure imaginaries, zero, and the sinc removable singularity
        pts = np.array(
            [-1 + 0j, -4 - 0j, 2j, -3j, 0j, 1 + 0j, -2 + 3j, 5 - 1e-3j],
            dtype=np.complex64,
        )
        xd = dsc.from_numpy(pts)
        for np_op, dsc_op in (
            (np.sqrt, dsc.sqrt), (np.log, dsc.logn), (np.exp, dsc.exp),
            (np.sin, dsc.sin), (np.cos, dsc.cos), (np.sinc, dsc.sinc),
        ):
            got = dsc_op(xd).numpy()
            want = np_op(pts)
            assert all_close(got, want), (np_op.__name__, got, want)

    def test_complex_pow_formulas(self):
        # complex pow runs as exp(b * log a) on real planes (reference
        # pow_op, dsc_ops.h:305-316)
        pts = np.array(
            [-1 + 0j, 2j, -3j, 1 + 0j, -2 + 3j, 0.5 - 1.5j],
            dtype=np.complex64,
        )
        exps = np.array(
            [2 + 0j, 0.5 + 0j, -1 + 0j, 2.5 - 1j, 3 + 0j, 1j],
            dtype=np.complex64,
        )
        a, b = dsc.from_numpy(pts), dsc.from_numpy(exps)
        assert all_close(dsc.power(a, b).numpy(), pts**exps)
        assert all_close(dsc.power(a, 2.0).numpy(), pts**2.0)
        assert all_close(dsc.power(a, 1.5 + 0.5j).numpy(), pts ** (1.5 + 0.5j))
        # mixed real base / complex exponent promotes to C32 then runs
        # the same plane formula
        rb = dsc.from_numpy(np.array([0.5, 2.0, 3.0], dtype=np.float32))
        assert all_close(
            dsc.power(rb, 1j).numpy(),
            np.array([0.5, 2.0, 3.0]) ** 1j,
        )

    def test_complex_pow_zero_base(self):
        # the exp(b*log a) formula hits 0*(-inf)=nan at a=0; NumPy (the
        # oracle) defines 0^0 = 1 and 0^b = 0 for re(b) > 0 — pinned by a
        # zero-base guard in _cpow_planes (found by tests/test_fuzz.py:
        # zero-padded fft tails make exact zeros common)
        z = np.array([0j, 0j, 1 + 1j], dtype=np.complex64)
        e = np.array([2 + 0j, 0j, 2 + 0j], dtype=np.complex64)
        got = dsc.power(dsc.from_numpy(z), dsc.from_numpy(e)).numpy()
        assert all_close(got, z**e)  # [0, 1, 2j]
        got2 = dsc.power(dsc.from_numpy(z), 2.0).numpy()
        assert all_close(got2, z**np.complex64(2.0))
        assert np.isfinite(got).all() and np.isfinite(got2).all()

    def test_csqrt_negative_zero_branch(self):
        # signbit (not im < 0) picks the branch: complex(-4, -0.0) maps to
        # -2j exactly as np.sqrt does
        z = np.array([complex(-4.0, -0.0), complex(-4.0, 0.0)], np.complex64)
        got = dsc.sqrt(dsc.from_numpy(z)).numpy()
        want = np.sqrt(z)
        assert all_close(got, want)
        assert np.all(np.sign(got.imag) == np.sign(want.imag))

    def test_conj_real_views(self):
        # conj/real are NOP views on real tensors (dsc.cpp:1543-1594)
        x = dsc.from_numpy(random_nd([4, 4], np.float32))
        c = dsc.conj(x)
        r = dsc.real(x)
        x[0, 0] = 42.0
        assert c.numpy()[0, 0] == 42.0
        assert r.numpy()[0, 0] == 42.0

    def test_clip(self):
        for dtype in DTYPES:
            x = (np.arange(10) - 5).astype(dtype)
            x_dsc = dsc.from_numpy(x)
            assert all_close(dsc.clip(x_dsc, -2, 2).numpy(), np.clip(x, -2, 2))
            assert all_close(dsc.clip(x_dsc, -3).numpy(), np.clip(x, -3, None))
            assert all_close(dsc.clip(x_dsc, None, 2).numpy(), np.clip(x, None, 2))

    def test_unary_axis(self):
        ops = {
            'sum': (np.sum, dsc.sum),
            'mean': (np.mean, dsc.mean),
            'max': (np.max, dsc.max),
            'min': (np.min, dsc.min),
        }
        for op_name, (np_op, dsc_op) in ops.items():
            for dtype in DTYPES:
                for axis in range(-4, 4):
                    x = random_nd(
                        [random.randint(1, 10) for _ in range(4)], dtype=dtype
                    )
                    x_dsc = dsc.from_numpy(x)

                    res_np = np_op(x, axis=axis, keepdims=True)
                    res_dsc = dsc_op(x_dsc, axis=axis, keepdims=True)
                    assert all_close(res_dsc.numpy(), res_np), (op_name, dtype, axis)

                    res_np = np_op(x, axis=axis, keepdims=False)
                    res_dsc = dsc_op(x_dsc, axis=axis, keepdims=False)
                    assert all_close(res_dsc.numpy(), res_np), (op_name, dtype, axis)

    def test_reduce_defaults(self):
        # axis=-1, keepdims=True are the dsc defaults (dsc.h:358-380)
        x = random_nd([3, 4], np.float32)
        x_dsc = dsc.from_numpy(x)
        assert all_close(dsc.sum(x_dsc).numpy(), x.sum(axis=-1, keepdims=True))


class TestInit:
    def test_arange(self):
        for _ in range(5):
            n = random.randint(1, 10_000)
            for dtype in DTYPES:
                res_np = np.arange(n, dtype=dtype)
                res_dsc = dsc.arange(n, dtype=DSC_DTYPES[dtype])
                assert all_close(res_dsc.numpy(), res_np)

    def test_random(self):
        for _ in range(5):
            shape = tuple(random.randint(1, 10) for _ in range(4))
            for dtype in DTYPES:
                if np.dtype(dtype).kind == 'c':
                    continue
                res_np = np.random.randn(*shape).astype(dtype)
                res_dsc = dsc.randn(*shape, dtype=DSC_DTYPES[dtype])
                res_dsc_np = res_dsc.numpy()
                assert res_dsc_np.dtype == res_np.dtype
                assert res_dsc_np.shape == res_np.shape

    def test_randn_not_constant(self):
        # The reference's randn returns identical values every call
        # (fresh default-seeded mt19937, dsc.cpp:501-513) — deliberately
        # NOT copied (SURVEY Appendix B): draws must differ.
        a = dsc.randn(64).numpy()
        b = dsc.randn(64).numpy()
        assert not np.allclose(a, b)


def test_creation():
    for n_dim in range(4):
        for dtype in DTYPES:
            shape = tuple(random.randint(1, 20) for _ in range(n_dim + 1))
            fill = random.random()
            if np.dtype(dtype).kind == 'c':
                fill = complex(random.random(), random.random())
            assert all_close(
                dsc.full(shape, fill_value=fill, dtype=DSC_DTYPES[dtype]).numpy(),
                np.full(shape, fill_value=fill, dtype=dtype),
            )

            like = np.ones([random.randint(1, 10) for _ in range(n_dim + 1)])
            assert all_close(
                dsc.full_like(like, fill_value=fill, dtype=DSC_DTYPES[dtype]).numpy(),
                np.full_like(like, fill_value=fill, dtype=dtype),
            )
            assert all_close(
                dsc.ones(shape, dtype=DSC_DTYPES[dtype]).numpy(),
                np.ones(shape, dtype=dtype),
            )
            assert all_close(
                dsc.ones_like(like, dtype=DSC_DTYPES[dtype]).numpy(),
                np.ones_like(like, dtype=dtype),
            )
            assert all_close(
                dsc.zeros(shape, dtype=DSC_DTYPES[dtype]).numpy(),
                np.zeros(shape, dtype=dtype),
            )
            assert all_close(
                dsc.zeros_like(like, dtype=DSC_DTYPES[dtype]).numpy(),
                np.zeros_like(like, dtype=dtype),
            )
            assert dsc.empty(shape, dtype=DSC_DTYPES[dtype]).shape == shape
            assert dsc.empty_like(like).shape == like.shape


def test_reshape():
    x = np.ones((10, 10))
    x_dsc = dsc.from_numpy(x)
    assert all_close(x.reshape(4, 5, 5), x_dsc.reshape(4, 5, 5).numpy())
    assert all_close(x.reshape([4, 5, 5]), x_dsc.reshape([4, 5, 5]).numpy())
    assert all_close(x.reshape((4, 5, 5)), x_dsc.reshape((4, 5, 5)).numpy())
    assert all_close(x.reshape(-1, 5), x_dsc.reshape(-1, 5).numpy())
    assert all_close(x.reshape([-1, 5]), x_dsc.reshape([-1, 5]).numpy())
    assert all_close(x.reshape((-1, 5)), x_dsc.reshape((-1, 5)).numpy())
    with pytest.raises(RuntimeError):
        x_dsc.reshape(3, 7)


def test_reshape_is_view():
    # reshape shares the buffer (reference dsc.cpp:599-636)
    x_dsc = dsc.zeros((4, 4))
    y = x_dsc.reshape(16)
    x_dsc[0, 1] = 5.0
    assert y.numpy()[1] == 5.0


def test_concat():
    for n_dim in range(1, 5):
        for dtype in DTYPES:
            shape = [random.randint(2, 10) for _ in range(n_dim)]
            for axis_idx in range(n_dim):
                shape_x1 = list(shape)
                shape_x1[axis_idx] = random.randint(2, 10)
                shape_x2 = list(shape)
                shape_x2[axis_idx] = random.randint(2, 10)
                x1 = random_nd(shape_x1, dtype)
                x2 = random_nd(shape_x2, dtype)
                x1_dsc = dsc.from_numpy(x1)
                x2_dsc = dsc.from_numpy(x2)

                assert all_close(
                    dsc.concat((x1_dsc, x2_dsc), axis_idx).numpy(),
                    np.concatenate((x1, x2), axis_idx),
                )
                # axis=None flattens (reference dsc.cpp:665-746)
                assert all_close(
                    dsc.concat((x1_dsc, x2_dsc), None).numpy(),
                    np.concatenate((x1, x2), None),
                )


def test_transpose():
    for n_dim in range(1, 5):
        for dtype in DTYPES:
            shape = [random.randint(2, 10) for _ in range(n_dim)]
            x = random_nd(shape, dtype)
            x_dsc = dsc.from_numpy(x)
            assert all_close(dsc.transpose(x_dsc).numpy(), np.transpose(x))
            for axes in permutations(range(n_dim)):
                assert all_close(
                    dsc.transpose(x_dsc, axes).numpy(), np.transpose(x, axes)
                )


def test_cast():
    x = random_nd([4, 4], np.float32)
    x_dsc = dsc.from_numpy(x)
    for dtype in DTYPES:
        assert all_close(x_dsc.cast(DSC_DTYPES[dtype]).numpy(), x.astype(dtype))
    # same-dtype cast returns a view (reference dsc.cpp:587-590)
    v = x_dsc.cast(dsc.Dtype.F32)
    x_dsc[0, 0] = 3.25
    assert v.numpy()[0, 0] == 3.25


def test_tensor_protocol():
    x = random_nd([3, 4], np.float32)
    x_dsc = dsc.from_numpy(x)
    assert len(x_dsc) == 3
    assert x_dsc.ne == 12
    assert x_dsc.n_dim == 2
    assert x_dsc.shape == (3, 4)
    assert bytes(x_dsc) == x.tobytes()
    assert x_dsc.tobytes() == x.tobytes()
    assert str(x_dsc) == str(x)


def test_max_rank():
    with pytest.raises(RuntimeError):
        dsc.zeros((2, 2, 2, 2, 2))
