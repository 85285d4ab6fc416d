"""Randomized op-sequence fuzzing vs the NumPy oracle.

The reference suite enumerates ops one at a time (test_ops.py); this
extends the same oracle strategy (NumPy is the executable specification,
reference README.md:173-180) to random CHAINS of public-API calls, so
interactions the enumerated tests never compose — views feeding
reductions feeding FFTs, dtype promotion across chained binaries, planar
complex intermediates flowing through slicing — are exercised too.
Seeded per case: every failure reproduces.
"""

import numpy as np
import pytest

import dsc_tpu as dsc

from conftest import all_close

# (name, dsc fn, numpy fn, arity, complex_ok)
_BINARY = [
    ('add', dsc.add, np.add),
    ('sub', dsc.sub, np.subtract),
    ('mul', dsc.mul, np.multiply),
    ('div', dsc.true_div, np.true_divide),
]
_UNARY = [
    ('cos', dsc.cos, np.cos),
    ('sin', dsc.sin, np.sin),
    ('exp', dsc.exp, np.exp),
    ('sqrt', dsc.sqrt, np.sqrt),
    ('conj', dsc.conj, np.conj),
    ('absolute', dsc.absolute, np.absolute),
]
_REDUCE = [
    ('sum', dsc.sum, np.sum),
    ('mean', dsc.mean, np.mean),
    ('max', dsc.max, np.max),
    ('min', dsc.min, np.min),
]


def _rand_operand(rng, shape, complex_: bool):
    # keep magnitudes O(1) so transcendental chains stay inside the
    # reference-parity accuracy envelope (ops/kernels.py notes)
    x = rng.uniform(-1.5, 1.5, shape)
    if complex_:
        x = (x + 1j * rng.uniform(-1.5, 1.5, shape)).astype(np.complex64)
    else:
        x = x.astype(np.float32)
    return x


def _chain_case(seed: int):
    """One random chain: creation -> 3-6 ops -> compare against NumPy."""
    rng = np.random.default_rng(seed)
    rank = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(2, 7)) for _ in range(rank))
    complex_ = bool(rng.integers(0, 2))
    xn = _rand_operand(rng, shape, complex_)
    xt = dsc.from_numpy(xn)

    n_ops = int(rng.integers(3, 7))
    ops_log = []
    for _ in range(n_ops):
        kind = rng.choice(['binary', 'unary', 'reduce', 'slice', 'fft',
                           'layout', 'pow', 'clip'])
        ops_log.append(str(kind))
        if kind == 'binary':
            name, dfn, nfn = _BINARY[int(rng.integers(0, len(_BINARY)))]
            if rng.integers(0, 2):  # tensor RHS, same shape
                yn = _rand_operand(rng, xn.shape,
                                   bool(np.iscomplexobj(xn)))
                if name == 'div':
                    yn = yn + np.where(np.abs(yn) < 0.25, 0.5, 0.0).astype(
                        yn.dtype)
                xt, xn = dfn(xt, dsc.from_numpy(yn)), nfn(xn, yn)
            else:  # scalar RHS
                s = float(rng.uniform(0.5, 2.0))
                xt, xn = dfn(xt, s), nfn(xn, np.asarray(
                    s, dtype=np.float32 if not np.iscomplexobj(xn)
                    else np.complex64))
        elif kind == 'unary':
            name, dfn, nfn = _UNARY[int(rng.integers(0, len(_UNARY)))]
            if name == 'sqrt':
                # sqrt needs values away from the branch cut: rfft DC /
                # Nyquist bins carry signed-zero imaginary parts where
                # BOTH principal-branch signs are oracle-valid, so fuzz
                # chains feed it |x| (the dedicated branch-cut tests live
                # in test_ops.py)
                xt, xn = dsc.absolute(xt), np.absolute(xn)
            xt, xn = dfn(xt), nfn(xn)
        elif kind == 'reduce' and xn.ndim >= 1 and xn.size > 1:
            name, dfn, nfn = _REDUCE[int(rng.integers(0, len(_REDUCE)))]
            ax = int(rng.integers(-xn.ndim, xn.ndim))
            xt = dfn(xt, axis=ax, keepdims=True)
            xn = nfn(xn, axis=ax, keepdims=True)
        elif kind == 'slice' and xn.ndim >= 1 and xn.shape[0] > 1:
            step = int(rng.choice([1, 2, -1]))
            if xn[::step].size > 1:  # 1-element results unwrap to scalars
                xt, xn = xt[::step], xn[::step]
        elif kind == 'fft' and xn.shape[-1] >= 2:
            if np.iscomplexobj(xn):
                xt, xn = dsc.ifft(dsc.fft(xt)), xn.astype(np.complex64)
                nfft = 1 << (int(xn.shape[-1] - 1).bit_length())
                xn = np.fft.ifft(np.fft.fft(xn, n=nfft, axis=-1),
                                 axis=-1).astype(np.complex64)
            else:
                xt = dsc.rfft(xt)
                nfft = 1 << (int(xn.shape[-1] - 1).bit_length())
                xn = np.fft.rfft(xn, n=nfft, axis=-1).astype(np.complex64)
        elif kind == 'layout':
            which = rng.choice(['transpose', 'reshape', 'concat'])
            if which == 'transpose' and xn.ndim >= 2:
                axes = tuple(rng.permutation(xn.ndim).tolist())
                xt, xn = dsc.transpose(xt, axes), np.transpose(xn, axes)
            elif which == 'reshape':
                xt, xn = dsc.reshape(xt, -1), xn.reshape(-1)
            elif xn.ndim <= 3:  # concat with self (rank cap is 4)
                ax = int(rng.integers(0, xn.ndim))
                xt = dsc.concat([xt, xt], axis=ax)
                xn = np.concatenate([xn, xn], axis=ax)
        elif kind == 'pow':
            if np.iscomplexobj(xn):
                # integer exponent: z^2 is entire (no branch cut to
                # disagree over at the rfft bins' signed-zero imag parts)
                xt = dsc.power(xt, 2.0)
                xn = (xn ** np.complex64(2.0)).astype(np.complex64)
            else:  # keep real bases positive, exponents fractional
                e = float(rng.uniform(0.5, 1.5))
                xt = dsc.power(dsc.add(dsc.absolute(xt), 0.5), e)
                xn = (np.absolute(xn) + np.float32(0.5)) ** np.float32(e)
        elif kind == 'clip' and not np.iscomplexobj(xn):
            lo, hi = sorted(rng.uniform(-1.0, 1.0, 2).tolist())
            xt = dsc.clip(xt, lo, hi)
            xn = np.clip(xn, np.float32(lo), np.float32(hi))
        if isinstance(xn, np.generic):
            xn = np.asarray(xn)
    got = np.asarray(xt.numpy()) if isinstance(xt, dsc.Tensor) else xt
    assert got.shape == xn.shape, (seed, ops_log, got.shape, xn.shape)
    assert all_close(got, xn.astype(got.dtype), eps=1e-3), (
        f'seed {seed} ops {ops_log}: max |diff| = '
        f'{np.abs(got - xn.astype(got.dtype)).max()}'
    )


@pytest.mark.parametrize('seed', range(60))
def test_fuzz_chain(seed):
    _chain_case(seed)


# ---------------------------------------------------------------------------
# STFT/ISTFT config fuzz: random (frame, hop, window, batch, length)
# configurations against the NumPy STFT oracle and the WLS round-trip
# guarantee (interior samples reconstruct exactly wherever window
# coverage is nonzero).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('seed', range(10))
def test_fuzz_stft_istft_configs(seed):
    from dsc_tpu.models import ISTFT, STFT

    rng = np.random.default_rng(20_000 + seed)
    frame = int(rng.choice([64, 128, 256, 320]))
    hop = int(rng.choice([frame // 4, frame // 3, frame // 2, frame]))
    window = str(rng.choice(['hann', 'hamming', 'blackman', 'rect']))
    batch = int(rng.integers(1, 4))
    n = frame * int(rng.integers(4, 9)) + int(rng.integers(0, hop))
    shape = (n,) if batch == 1 and rng.integers(0, 2) else (batch, n)
    x = rng.standard_normal(shape).astype(np.float32)

    stft = STFT(frame=frame, hop=hop, window=window, mode='complex')
    z = stft(dsc.from_numpy(x))
    n_frames = 1 + (n - frame) // hop
    fft_n = 1 << (frame - 1).bit_length()

    # oracle: windowed frame rfft (NumPy)
    from dsc_tpu.models.stft import _make_window

    win = _make_window(window, frame)
    x2 = x.reshape(-1, n)
    ref = np.stack([
        np.stack([
            np.fft.rfft(row[i * hop : i * hop + frame] * win, n=fft_n)
            for i in range(n_frames)
        ])
        for row in x2
    ]).reshape(z.shape)
    zn = z.numpy()
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(zn - ref).max() / scale < 1e-4, (seed, frame, hop, window)

    # round-trip: WLS reconstruction is exact where the summed squared
    # window is substantial; where coverage ~0 (e.g. hann endpoints with
    # hop == frame) the sample is unrecoverable BY DESIGN, and tiny
    # coverage amplifies f32 rounding by 1/sum(w^2) — mask to
    # sum(w^2) > 0.1 inside a one-frame margin
    y = ISTFT(frame=frame, hop=hop, window=window)(z).numpy().reshape(-1)
    span = (n_frames - 1) * hop + frame
    wsq = np.zeros(span)
    for i in range(n_frames):
        wsq[i * hop : i * hop + frame] += win.astype(np.float64) ** 2
    m = np.zeros(span, bool)
    m[frame : span - frame] = True
    m &= wsq > 0.1
    if m.any():
        want = x2[:, :span].reshape(-1)
        mm = np.tile(m, x2.shape[0])
        assert np.abs(y[mm] - want[mm]).max() < 1e-4, (
            seed, frame, hop, window)


@pytest.mark.parametrize('seed', range(8))
def test_fuzz_overlap_save_configs(seed):
    from dsc_tpu.models import OverlapSave

    rng = np.random.default_rng(30_000 + seed)
    k = int(rng.integers(2, 200))
    fft_n = int(rng.choice([256, 512, 1024, 2048]))
    if fft_n < 1 << (2 * k - 1).bit_length():
        fft_n = 1 << (2 * k - 1).bit_length()
    batch = int(rng.integers(1, 4))
    n = int(rng.integers(k, 6000))
    shape = (n,) if batch == 1 and rng.integers(0, 2) else (batch, n)
    x = rng.standard_normal(shape).astype(np.float32)
    taps = rng.standard_normal(k).astype(np.float32)
    got = OverlapSave(taps, fft_n=fft_n)(dsc.from_numpy(x)).numpy()
    x2 = x.reshape(-1, n)
    ref = np.stack([np.convolve(row, taps) for row in x2]).reshape(
        got.shape
    )
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(got - ref).max() / scale < 1e-4, (seed, k, fft_n, n)


# ---------------------------------------------------------------------------
# dsc.compile equivalence fuzz: the SAME random op program applied eagerly
# and as one traced/fused XLA program (fuse.py) must agree. This pins the
# documented dsc.compile semantics ("compiled pipelines keep the planar/
# hermitian fast paths end-to-end") against the eager dispatch path, which
# uses different engines (Pallas-eligible eager kernels vs pure-XLA trace).
# ---------------------------------------------------------------------------


def _apply_program(instrs, t):
    """Replay an instruction list on a Tensor. Used identically for the
    eager reference run and inside the dsc.compile trace, so both paths
    execute the exact same public-API call sequence."""
    for ins in instrs:
        kind = ins[0]
        if kind == 'binary':
            _, fn, rhs = ins
            t = fn(t, rhs)
        elif kind == 'unary':
            t = ins[1](t)
        elif kind == 'reduce':
            _, fn, ax = ins
            t = fn(t, axis=ax, keepdims=True)
        elif kind == 'slice':
            t = t[:: ins[1]]
        elif kind == 'rfft':
            t = dsc.rfft(t)
        elif kind == 'fftpair':
            t = dsc.ifft(dsc.fft(t))
        elif kind == 'transpose':
            t = dsc.transpose(t, ins[1])
        elif kind == 'flatten':
            t = dsc.reshape(t, -1)
        elif kind == 'concat':
            t = dsc.concat([t, t], axis=ins[1])
        elif kind == 'clip':
            t = dsc.clip(t, ins[1], ins[2])
        elif kind == 'pow':
            t = dsc.power(dsc.add(dsc.absolute(t), 0.5), ins[1])
    return t


def _sample_program(seed):
    """Sample a random trace-safe instruction list by applying candidate
    ops eagerly as they are drawn (the eager intermediate provides the
    shape/dtype validity checks)."""
    rng = np.random.default_rng(10_000 + seed)
    rank = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(2, 7)) for _ in range(rank))
    complex_ = bool(rng.integers(0, 2))
    xn = _rand_operand(rng, shape, complex_)
    t = dsc.from_numpy(xn)
    instrs = []
    for _ in range(int(rng.integers(3, 7))):
        kind = rng.choice(['binary', 'unary', 'reduce', 'slice', 'fft',
                           'layout', 'clip', 'pow'])
        cplx = t.dtype in (dsc.Dtype.C32, dsc.Dtype.C64)
        if kind == 'binary':
            name, dfn, _ = _BINARY[int(rng.integers(0, len(_BINARY)))]
            if rng.integers(0, 2):
                yn = _rand_operand(rng, t.shape, cplx)
                if name == 'div':
                    yn = yn + np.where(np.abs(yn) < 0.25, 0.5, 0.0).astype(
                        yn.dtype)
                # closure Tensor: bakes in as a program constant
                ins = ('binary', dfn, dsc.from_numpy(yn))
            else:
                ins = ('binary', dfn, float(rng.uniform(0.5, 2.0)))
        elif kind == 'unary':
            name, dfn, _ = _UNARY[int(rng.integers(0, len(_UNARY)))]
            if name == 'sqrt':  # keep off the branch cut (see fuzz above)
                dfn = dsc.absolute
            ins = ('unary', dfn)
        elif kind == 'reduce' and t.ne > 1:
            _, dfn, _ = _REDUCE[int(rng.integers(0, len(_REDUCE)))]
            ins = ('reduce', dfn, int(rng.integers(-t.n_dim, t.n_dim)))
        elif kind == 'slice' and t.n_dim >= 1 and t.shape[0] > 2:
            # keep >1 elements: 1-element results unwrap eagerly but
            # raise under trace (documented dsc.compile semantics)
            ins = ('slice', int(rng.choice([2, -1])))
        elif kind == 'fft' and t.shape[-1] >= 2:
            ins = ('fftpair',) if cplx else ('rfft',)
        elif kind == 'layout':
            which = rng.choice(['transpose', 'flatten', 'concat'])
            if which == 'transpose' and t.n_dim >= 2:
                ins = ('transpose', tuple(rng.permutation(t.n_dim).tolist()))
            elif which == 'flatten':
                ins = ('flatten',)
            elif t.n_dim <= 3:
                ins = ('concat', int(rng.integers(0, t.n_dim)))
            else:
                continue
        elif kind == 'clip' and not cplx:
            lo, hi = sorted(rng.uniform(-1.0, 1.0, 2).tolist())
            ins = ('clip', lo, hi)
        elif kind == 'pow' and not cplx:
            ins = ('pow', float(rng.uniform(0.5, 1.5)))
        else:
            continue
        t = _apply_program([ins], t)
        if isinstance(t, (int, float, complex)):  # unwrapped: drop the op
            raise AssertionError('sampler produced a scalar unwrap')
        instrs.append(ins)
    return xn, instrs, t


@pytest.mark.parametrize('seed', range(16))
def test_fuzz_compile_equivalence(seed):
    xn, instrs, want = _sample_program(seed)
    fn = dsc.compile(lambda v: _apply_program(instrs, v))
    got = fn(dsc.from_numpy(xn))
    assert got.shape == want.shape, (seed, instrs)
    assert got.dtype == want.dtype, (seed, instrs)
    assert all_close(got.numpy(), want.numpy(), eps=1e-4), (
        f'seed {seed}: compiled vs eager max |diff| = '
        f'{np.abs(got.numpy() - want.numpy()).max()} over {instrs}'
    )


# -- dsc.map equivalence fuzz ---------------------------------------------

_MAP_UNARY = [
    ('cos', dsc.cos, np.cos),
    ('sin', dsc.sin, np.sin),
    ('exp', lambda t: dsc.exp(t * 0.25), lambda x: np.exp(x * 0.25)),
    ('sqrt', lambda t: dsc.sqrt(dsc.absolute(t)),
     lambda x: np.sqrt(np.abs(x))),
    ('sinc', dsc.sinc, np.sinc),
    ('clip', lambda t: dsc.clip(t, -0.5, 0.75),
     lambda x: np.clip(x, -0.5, 0.75)),
    ('log', lambda t: dsc.logn(dsc.absolute(t) + 1.0),
     lambda x: np.log(np.abs(x) + 1.0)),
]


@pytest.mark.parametrize('seed', range(8))
def test_fuzz_dsc_map_equivalence(seed):
    """Random elementwise bodies through dsc.map (one fused program) must
    match the same chain applied eagerly through the public ops AND the
    NumPy oracle."""
    rng = np.random.default_rng(4200 + seed)
    ne = int(rng.choice([64 * 128 * 2, 64 * 128 * 3 + 1024]))
    a = rng.uniform(-1.5, 1.5, ne).astype(np.float32)
    b = rng.uniform(-1.5, 1.5, ne).astype(np.float32)
    sc = float(rng.uniform(-1.0, 1.0))
    steps = [
        _MAP_UNARY[int(rng.integers(0, len(_MAP_UNARY)))]
        for _ in range(int(rng.integers(1, 4)))
    ]

    def body(x, y):
        t = x * y + sc
        for _, dfn, _nfn in steps:
            t = dfn(t)
        return t

    def np_body(x, y):
        t = x * y + np.float32(sc)
        for _, _dfn, nfn in steps:
            t = nfn(t)
        return t

    fused = dsc.map(body)
    ad, bd = dsc.from_numpy(a), dsc.from_numpy(b)
    got = fused(ad, bd)
    assert fused.n_programs == 1
    eager = body(ad, bd)
    names = [s[0] for s in steps]
    assert all_close(got.numpy(), eager.numpy(), eps=1e-5), names
    assert all_close(got.numpy(), np_body(a, b), eps=1e-4), names
