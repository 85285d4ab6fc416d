"""dsc.compile (fuse.py): whole-pipeline fusion over the public API.

The reference has no fusion tier (it is eager by construction); these
tests pin the documented semantics of the extension: NumPy
stays the oracle (reference README.md:173-180), programs are cached per
argument signature with bounded LRU eviction mirroring the FFT plan
cache contract (dsc/src/dsc.cpp:182-267), and compiled regions are
functional.
"""

import numpy as np
import pytest

import dsc_tpu as dsc
from dsc_tpu import fuse


def all_close(got, want, atol=1e-5, rtol=1e-5):
    return np.allclose(got, want, atol=atol, rtol=rtol, equal_nan=True)


def test_compile_elementwise_chain():
    @dsc.compile
    def fma(a, b, c):
        return dsc.add(dsc.mul(a, b), c)

    an, bn, cn = (np.random.randn(8, 256).astype(np.float32) for _ in range(3))
    got = fma(dsc.from_numpy(an), dsc.from_numpy(bn), dsc.from_numpy(cn))
    assert isinstance(got, dsc.Tensor)
    assert got.shape == (8, 256)
    assert all_close(got.numpy(), an * bn + cn)
    # same signature -> same program
    fma(dsc.from_numpy(an), dsc.from_numpy(bn), dsc.from_numpy(cn))
    assert fma.n_programs == 1
    # new shape -> second program
    small = np.random.randn(4, 128).astype(np.float32)
    fma(*(dsc.from_numpy(x) for x in (small, small, small)))
    assert fma.n_programs == 2


def test_compile_filterfft_pipeline():
    # the README filterFFT chain (reference README.md:110-137) as ONE program
    @dsc.compile
    def filt(sig, flt):
        return dsc.irfft(dsc.mul(dsc.rfft(sig), dsc.rfft(flt)))

    n = 4096
    s = np.random.randn(n).astype(np.float32)
    f = np.random.randn(n).astype(np.float32)
    got = filt(dsc.from_numpy(s), dsc.from_numpy(f)).numpy()
    want = np.fft.irfft(np.fft.rfft(s) * np.fft.rfft(f))
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-4


def test_compile_planar_output_and_tuple_return():
    @dsc.compile
    def spec(sig):
        X = dsc.rfft(sig)
        return X, dsc.absolute(X)

    s = np.random.randn(2048).astype(np.float32)
    X, mag = spec(dsc.from_numpy(s))
    want = np.fft.rfft(s)
    assert X.dtype == dsc.Dtype.C32 and X.shape == (1025,)
    assert all_close(X.numpy(), want, atol=1e-2, rtol=1e-4)
    assert all_close(mag.numpy(), np.abs(want), atol=1e-2, rtol=1e-4)


def test_compile_planar_input():
    # an eager planar spectrum Tensor crosses the compile boundary as planes
    from dsc_tpu import transforms as tf

    @dsc.compile
    def inv(X):
        return dsc.irfft(X)

    # the model tier returns planar storage (planar.py); dsc.rfft returns
    # dense complex — both must cross the compile boundary correctly
    for n, planar in ((2**18, True), (2**11, False)):
        s = np.random.randn(n).astype(np.float32)
        Xe = (tf.rfft if planar else dsc.rfft)(dsc.from_numpy(s))
        assert (Xe._planar is not None) == planar
        got = inv(Xe).numpy()
        want = np.fft.irfft(np.fft.rfft(s.astype(np.float64)))
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_compile_static_scalars_and_kwargs():
    @dsc.compile
    def scale(x, k, bias=0.0):
        return dsc.add(dsc.mul(x, k), bias)

    an = np.random.randn(16).astype(np.float32)
    a = dsc.from_numpy(an)
    assert all_close(scale(a, 2.5).numpy(), an * 2.5)
    assert all_close(scale(a, 2.5, bias=1.0).numpy(), an * 2.5 + 1.0)
    # each distinct static scalar value is its own program
    n0 = scale.n_programs
    scale(a, 3.0)
    assert scale.n_programs == n0 + 1


def test_compile_lru_bound(monkeypatch):
    monkeypatch.setenv('DSC_MAX_PROGRAMS', '2')

    @dsc.compile
    def ident(x, k):
        return dsc.mul(x, k)

    a = dsc.from_numpy(np.ones(8, np.float32))
    for k in (1.0, 2.0, 3.0, 4.0):
        ident(a, k)
    assert ident.n_programs == 2  # bounded LRU, like the FFT plan cache


def test_compile_mem_accounting_balanced():
    @dsc.compile
    def f(x):
        return dsc.mul(x, x)

    a = dsc.from_numpy(np.random.randn(64).astype(np.float32))
    f(a)  # trace+compile outside the measured window
    m0 = dsc.used_mem()
    r = f(a)
    assert dsc.used_mem() == m0 + r.ne * 4  # output bytes accounted
    del r
    import gc

    gc.collect()
    assert dsc.used_mem() == m0  # tracer-time pseudo-tensors never leak


def test_compile_is_functional():
    # writes to ARGUMENT tensors inside the program do not propagate out
    @dsc.compile
    def writes(x):
        x[0] = 99.0
        return dsc.add(x, 0.0)

    an = np.zeros(4, np.float32)
    a = dsc.from_numpy(an)
    out = writes(a)
    assert out.numpy()[0] == pytest.approx(99.0)  # visible in the result
    assert a.numpy()[0] == pytest.approx(0.0)  # caller's tensor untouched
    # out= on tensors created INSIDE the region works as usual
    @dsc.compile
    def with_out(x):
        tmp = dsc.empty(4, dtype=dsc.Dtype.F32)
        dsc.mul(x, 2.0, out=tmp)
        return tmp

    assert all_close(with_out(dsc.from_numpy(np.ones(4, np.float32))).numpy(),
                     np.full(4, 2.0, np.float32))


def test_compile_view_argument():
    @dsc.compile
    def double(x):
        return dsc.add(x, x)

    base = dsc.from_numpy(np.arange(12, dtype=np.float32))
    v = base.reshape(3, 4)  # buffer-sharing view with a different shape
    got = double(v)
    assert got.shape == (3, 4)
    assert all_close(got.numpy(), np.arange(12, dtype=np.float32).reshape(3, 4) * 2)


def test_compile_reductions_and_slicing():
    @dsc.compile
    def stats(x):
        m = dsc.mean(x, axis=-1, keepdims=True)
        d = dsc.sub(x, m)
        return dsc.sum(dsc.mul(d, d), axis=-1)

    an = np.random.randn(8, 256).astype(np.float32)
    want = ((an - an.mean(-1, keepdims=True)) ** 2).sum(-1, keepdims=True)
    assert all_close(stats(dsc.from_numpy(an)).numpy(), want, atol=1e-3)


def test_compile_errors():
    @dsc.compile
    def bad_return(x):
        return 42

    with pytest.raises(RuntimeError, match='must return a Tensor'):
        bad_return(dsc.from_numpy(np.ones(4, np.float32)))

    @dsc.compile
    def ok(x):
        return x

    with pytest.raises(RuntimeError, match='arguments must be'):
        ok(object())

    # concrete values are unavailable mid-trace — JAX raises its
    # ConcretizationTypeError (documented in fuse.py)
    @dsc.compile
    def peeks(x):
        float(np.asarray(x.numpy()).sum())
        return x

    with pytest.raises(Exception, match='[Cc]oncret|[Tt]racer'):
        peeks(dsc.from_numpy(np.ones(4, np.float32)))


def test_compile_plan_cache_stays_concrete():
    # the first FFT of a given size planned INSIDE a trace must not leak
    # tracers into the global plan cache (plan.py ensure_compile_time_eval)
    from dsc_tpu.fourier import plan

    plan.clear_plans()

    @dsc.compile
    def first_fft(x):
        return dsc.rfft(x)

    s = np.random.randn(512).astype(np.float32)
    first_fft(dsc.from_numpy(s))
    # eager call AFTER the traced build must see concrete tables
    got = dsc.rfft(dsc.from_numpy(s)).numpy()
    assert all_close(got, np.fft.rfft(s), atol=1e-3, rtol=1e-4)


def test_compile_numpy_array_args():
    @dsc.compile
    def addn(x, y):
        return dsc.add(x, y)

    an = np.random.randn(16).astype(np.float32)
    got = addn(an, np.float32(0) + an)  # raw NumPy arrays auto-wrap
    assert all_close(got.numpy(), an + an)


def test_compile_decorator_forms():
    def f(x):
        return dsc.mul(x, 2.0)

    c1 = dsc.compile(f)
    c2 = dsc.compile()(f)  # parenthesized decorator form
    a = dsc.from_numpy(np.ones(4, np.float32))
    assert all_close(c1(a).numpy(), c2(a).numpy())
    assert isinstance(c1, fuse._Compiled)


# -- mesh-compiled SPMD programs (fuse.py mesh=; the reference has no
# distributed story, SURVEY §2.4 — this is the scaling tier) --

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402


@pytest.fixture
def needs_devices():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')


@pytest.mark.usefixtures('needs_devices')
def test_compile_mesh_filterfft_batch_sharded():
    mesh = dsc.make_mesh((8, 1))

    def pipeline(sig, flt):
        spec = dsc.mul(dsc.rfft(sig), dsc.rfft(flt))
        return dsc.irfft(spec)

    pipe = dsc.compile(pipeline, mesh=mesh,
                       in_specs=(P('data'), P()), out_specs=P('data'))
    sn = np.random.randn(16, 512).astype(np.float32)
    fn_ = np.random.randn(512).astype(np.float32)
    got = pipe(dsc.from_numpy(sn), dsc.from_numpy(fn_))
    want = np.fft.irfft(np.fft.rfft(sn, axis=-1) * np.fft.rfft(fn_), axis=-1)
    assert got.shape == (16, 512)
    assert all_close(got.numpy(), want, atol=1e-4)
    # the output actually lives sharded over the 8 'data' devices
    arr = got._buf.arr
    assert len(arr.sharding.device_set) == 8
    assert arr.addressable_shards[0].data.shape[0] == 2  # 16 / 8


@pytest.mark.usefixtures('needs_devices')
def test_compile_mesh_elementwise_and_reduction():
    mesh = dsc.make_mesh((4, 2), axis_names=('data', 'model'))

    def stats(x, y):
        d = dsc.sub(x, y)
        return dsc.sum(dsc.mul(d, d), axis=-1)

    f = dsc.compile(stats, mesh=mesh, in_specs=(P('data', 'model'),) * 2)
    xn = np.random.randn(8, 1024).astype(np.float32)
    yn = np.random.randn(8, 1024).astype(np.float32)
    got = f(dsc.from_numpy(xn), dsc.from_numpy(yn))
    want = ((xn - yn) ** 2).sum(-1, keepdims=True)
    assert all_close(got.numpy(), want, atol=1e-3)


@pytest.mark.usefixtures('needs_devices')
def test_compile_mesh_complex_planar_args():
    # plain planar complex tensors shard plane-wise with the same spec
    mesh = dsc.make_mesh((8, 1))

    def f(z, w):
        return dsc.mul(z, dsc.conj(w))

    g = dsc.compile(f, mesh=mesh, in_specs=(P('data'), P('data')))
    zn = (np.random.randn(8, 64) + 1j * np.random.randn(8, 64)).astype(
        np.complex64)
    wn = (np.random.randn(8, 64) + 1j * np.random.randn(8, 64)).astype(
        np.complex64)
    got = g(dsc.from_numpy(zn), dsc.from_numpy(wn))
    assert all_close(got.numpy(), zn * np.conj(wn))


def test_compile_mesh_validation():
    with pytest.raises(RuntimeError, match='need mesh'):
        dsc.compile(lambda x: x, in_specs=(P('data'),))

    mesh = dsc.make_mesh((len(jax.devices()), 1))
    f = dsc.compile(lambda x: x, mesh=mesh, in_specs=(P(), P()))
    with pytest.raises(RuntimeError, match='in_specs'):
        f(dsc.from_numpy(np.ones(4, np.float32)))


def test_compile_mesh_shards_batched_model_pipeline():
    # a batched STFT -> mask -> ISTFT pipeline shards over the data axis
    # with no model changes: GSPMD partitions the whole program
    from dsc_tpu.models import ISTFT, STFT

    b, n, frame, hop = 8, 2048, 128, 32
    xs = np.random.randn(b, n).astype(np.float32)
    stft = STFT(frame=frame, hop=hop, mode='complex')
    istft = ISTFT(frame=frame, hop=hop)

    def pipe(v):
        Z = stft(v)
        mag = dsc.absolute(Z)
        floor = dsc.mean(mag, axis=2, keepdims=True)
        gate = dsc.clip(dsc.sub(dsc.true_div(mag, floor), 2.0), 0.0, 1.0)
        return istft(dsc.mul(Z, gate), length=n)

    mesh = dsc.make_mesh((len(jax.devices()), 1))
    f = dsc.compile(pipe, mesh=mesh, in_specs=(P('data'),))
    got = f(dsc.from_numpy(xs))
    assert got.shape == (b, n)
    want = pipe(dsc.from_numpy(xs))
    assert np.abs(got.numpy() - want.numpy()).max() < 1e-4


def test_compile_mesh_planar_arg_sharded():
    # a planar complex argument shards plane-wise with its logical
    # PartitionSpec (both planes have the logical shape)
    import jax.numpy as jnp

    from dsc_tpu.planar import Planar
    from dsc_tpu.tensor import Tensor

    mesh = dsc.make_mesh((len(jax.devices()), 1))
    re = jnp.asarray(np.random.randn(8, 65).astype(np.float32))
    h = Tensor._from_planar(Planar(re, -re, (8, 65)))
    f = dsc.compile(lambda z: z, mesh=mesh, in_specs=(P('data'),))
    got = f(h)
    assert got._planar is not None
    assert len(got._planar.re.sharding.device_set) == len(jax.devices())
    assert all_close(got.numpy(), np.asarray(re) * (1 - 1j))


@pytest.mark.usefixtures('needs_devices')
def test_compile_mesh_chained_sharded_resident():
    # the sharded output of one compiled call feeds the
    # next call directly — no gather to replicated, no host round-trip.
    # A pre-sharded argument with no explicit in_spec keeps its placement.
    from jax.sharding import NamedSharding

    mesh = dsc.make_mesh((8, 1))

    def step(x, g):
        return dsc.mul(dsc.add(x, x), g)

    f = dsc.compile(step, mesh=mesh, in_specs=(P('data'), P()),
                    out_specs=P('data'))
    xn = np.random.randn(16, 256).astype(np.float32)
    gn = np.random.randn(1).astype(np.float32)
    gt = dsc.from_numpy(gn)
    y = f(dsc.from_numpy(xn), gt)  # compiles; sticky-places gt replicated
    arr1 = y._buf.arr
    assert isinstance(arr1.sharding, NamedSharding)
    assert arr1.sharding.mesh == mesh
    assert isinstance(gt._buf.arr.sharding, NamedSharding)  # sticky

    # steady state: sharded y feeds back in, gt is already resident —
    # transfer_guard proves the chained calls move NOTHING host<->device
    with jax.transfer_guard('disallow'):
        for _ in range(3):
            y = f(y, gt)
    arr = y._buf.arr
    assert isinstance(arr.sharding, NamedSharding)
    assert len(arr.sharding.device_set) == 8
    want = xn
    for _ in range(4):
        want = (want + want) * gn[0]
    assert all_close(y.numpy(), want, atol=1e-4)

    # a pre-sharded arg with NO explicit spec keeps its placement (no
    # gather to replicated): second wrapper, no in_specs
    f2 = dsc.compile(lambda x: dsc.add(x, 1.0), mesh=mesh)
    z = f2(y)  # compiles for the sharded-input layout
    zarr = z._buf.arr
    assert isinstance(zarr.sharding, NamedSharding)
    assert not zarr.sharding.is_fully_replicated
    with jax.transfer_guard('disallow'):
        z = f2(z)
    assert all_close(z.numpy(), want + 2.0, atol=1e-4)
