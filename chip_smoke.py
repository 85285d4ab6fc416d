"""Smoke test of dsc_tpu's public API on a GPU.

    python chip_smoke.py           one GPU: phases 1-6 at real sizes
    python chip_smoke.py --multi   four GPUs: the multi-device paths only

Every phase goes through the public API and compares with NumPy/SciPy
computed in float64 on the host. Each check prints its maximum error beside
its bound and the precision it asked for; each timing prints the median and
spread of 5 warm calls, each ending in ``block_until_ready``, labelled with
the card's name and power limit. The last line of standard output is one
JSON object, ``{"ok": ..., "device": {"platform", "kind", "count"}}``. The
script exits non-zero unless JAX's default device is a GPU and every phase
passed. It runs as one process: a second JAX process on the same card would
fail for want of the memory the first one reserves.

The phases take their sizes as arguments, so tests can run them small on
the CPU (tests/test_chip_smoke.py); ``main()`` runs the real sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import scipy.signal as sps

import jax
import jax.numpy as jnp

import dsc_tpu as dsc
from dsc_tpu import models
from dsc_tpu.fourier import plan as fft_plan

# STFT profile of phase 4; the name is listed in .gitignore
TRACE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'stft_traces.json')
F32 = 'float32 (complex64)'
F64 = 'float64 (complex128)'


def card_info() -> list:
    """One 'name, power.limit' line per card, as nvidia-smi prints them."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError('nvidia-smi printed no card')
    return out


def card_label(cards: list) -> str:
    """One-line label for timing lines: the card, times the count."""
    if len(set(cards)) == 1:
        return cards[0] if len(cards) == 1 else f'{len(cards)} x {cards[0]}'
    return '; '.join(cards)


def _leaves(obj):
    """Device arrays behind a Tensor (or a tuple/list of them)."""
    if isinstance(obj, (tuple, list)):
        return [a for o in obj for a in _leaves(o)]
    if isinstance(obj, dsc.Tensor):
        pp = obj._planar
        return [pp.re, pp.im] if pp is not None else [obj._buf.arr]
    return [obj]


def ready(obj):
    """Block until every device array behind ``obj`` is computed."""
    jax.block_until_ready(_leaves(obj))
    return obj


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, dsc.Tensor) else np.asarray(t)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = _np(got), np.asarray(ref)
    if got.shape != ref.shape:
        raise RuntimeError(f'shape {got.shape} != reference {ref.shape}')
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def oracle_err(got, ref) -> float:
    """max |got - ref| / (1 + |ref|): <= 1e-5 is np.isclose with
    atol = rtol = 1e-5, the repo's oracle (tests/conftest.py)."""
    got, ref = _np(got), np.asarray(ref)
    if got.shape != ref.shape:
        raise RuntimeError(f'shape {got.shape} != reference {ref.shape}')
    return float((np.abs(got - ref) / (1.0 + np.abs(ref))).max())


class Smoke:
    """Prints checks and timings; remembers what failed."""

    def __init__(self, label: str, reps: int = 5):
        self.label = label
        self.reps = reps
        self.failed = []

    def check(self, what, err, bound, precision, why=''):
        ok = bool(np.isfinite(err) and err <= bound)
        note = f' — {why}' if why else ''
        print(f'  check {what}: max err {err:.3e}, bound {bound:.0e}, '
              f'{precision}{note}: {"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            self.failed.append(what)
        return ok

    def _once(self, fn) -> float:
        t0 = time.perf_counter()
        ready(fn())
        return time.perf_counter() - t0

    def _report(self, what, ts, nbytes=None):
        med = float(np.median(ts))
        rate = f', {nbytes / med / 1e9:.1f} GB/s' if nbytes else ''
        print(f'  time {what}: median {med * 1e3:.3f} ms, spread '
              f'{(max(ts) - min(ts)) * 1e3:.3f} ms over {len(ts)} warm '
              f'calls{rate} [{self.label}]', flush=True)
        return med

    def time(self, what, fn, nbytes=None) -> float:
        """One warm-up call (compiles), then ``reps`` timed calls."""
        ready(fn())
        return self._report(what, [self._once(fn) for _ in range(self.reps)],
                            nbytes)

    def time_pairs(self, fns, nbytes=None):
        """Time several functions in turns (a, b, a, b, ...) after one
        warm-up call each, so drift hits them alike."""
        for fn in fns.values():
            ready(fn())
        ts = {k: [] for k in fns}
        for _ in range(self.reps):
            for k, fn in fns.items():
                ts[k].append(self._once(fn))
        nb = nbytes or {}
        return {k: self._report(k, ts[k], nb.get(k)) for k in fns}


def _phase(smoke, name, fn, *args, **kwargs):
    print(f'phase {name}', flush=True)
    t0 = time.perf_counter()
    try:
        fn(smoke, *args, **kwargs)
    except Exception:
        traceback.print_exc()
        smoke.failed.append(name)
    print(f'phase {name} done in {time.perf_counter() - t0:.1f} s '
          '(compilation included)', flush=True)


# ---------------------------------------------------------------------------
# phases on one device
# ---------------------------------------------------------------------------


def phase_fft_convolve(smoke, n=2**24, taps=4097, seed=0):
    """The flagship: FFT convolution of an f32 signal with a Blackman
    filter, through the FFT API, models.fft_convolve and FilterFFT."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    h = np.blackman(taps).astype(np.float32)
    ref = sps.fftconvolve(x.astype(np.float64), h.astype(np.float64))
    out_len = n + taps - 1
    fft_n = fft_plan.next_pow2(out_len)
    xs, hs = dsc.from_numpy(x), dsc.from_numpy(h)

    def conv():
        spec = dsc.rfft(xs, n=fft_n) * dsc.rfft(hs, n=fft_n)
        return dsc.irfft(spec)[:out_len]

    filt = models.FilterFFT(h, block_size=n)
    for what, fn in (
        (f'rfft*rfft->irfft n={n} taps={taps} fft_n={fft_n}', conv),
        ('models.fft_convolve', lambda: models.fft_convolve(xs, hs)),
        ('models.FilterFFT', lambda: filt(xs)),
    ):
        smoke.check(what, rel_err(fn(), ref), 1e-4, F32,
                    'relative to max |reference|')
        smoke.time(what, fn)


def phase_fft_family(smoke, n=2**24, n_c128=2**22, batch=4096,
                     sweep=(8, 24), seed=1):
    rng = np.random.default_rng(seed)
    why = 'relative to max |reference|'
    x = rng.standard_normal(n).astype(np.float32)
    xs = dsc.from_numpy(x)
    spec = dsc.rfft(xs)
    smoke.check(f'rfft n={n}',
                rel_err(spec, np.fft.rfft(x.astype(np.float64))), 1e-4, F32,
                why)
    smoke.check(f'irfft(rfft) n={n}', rel_err(dsc.irfft(spec), x), 1e-4, F32,
                why)
    smoke.time(f'rfft+irfft n={n}', lambda: dsc.irfft(dsc.rfft(xs)))

    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    zs = dsc.from_numpy(z)
    zf = dsc.fft(zs)
    smoke.check(f'fft complex64 n={n}',
                rel_err(zf, np.fft.fft(z.astype(np.complex128))), 1e-4, F32,
                why)
    smoke.check(f'ifft(fft) complex64 n={n}', rel_err(dsc.ifft(zf), z), 1e-4,
                F32, why)
    smoke.time(f'fft+ifft complex64 n={n}', lambda: dsc.ifft(dsc.fft(zs)))
    del zs, zf, spec

    w = rng.standard_normal(n_c128) + 1j * rng.standard_normal(n_c128)
    ws = dsc.from_numpy(w)
    wf = dsc.fft(ws)
    home = jax.devices()[0].platform
    where = {d.platform for d in wf._buf.arr.devices()}
    if wf.dtype != dsc.Dtype.C64 or where != {home}:
        raise RuntimeError(f'complex128 fft ran as {wf.dtype} on {where}, '
                           f'not on the default device ({home})')
    print(f'  complex128 result lives on {sorted(where)}', flush=True)
    smoke.check(f'fft complex128 n={n_c128}', rel_err(wf, np.fft.fft(w)),
                1e-10, F64, why)
    smoke.time(f'fft complex128 n={n_c128}', lambda: dsc.fft(ws))
    del ws, wf

    b = (rng.standard_normal((batch, batch))
         + 1j * rng.standard_normal((batch, batch))).astype(np.complex64)
    bs = dsc.from_numpy(b)
    for axis in (-1, 0):
        what = f'batched fft complex64 ({batch}, {batch}) axis={axis}'
        ref = np.fft.fft(b.astype(np.complex128), axis=axis)
        smoke.check(what, rel_err(dsc.fft(bs, axis=axis), ref), 1e-4, F32,
                    why)
        smoke.time(what, lambda: dsc.fft(bs, axis=axis))
    del bs

    lo, hi = sweep
    worst = 0.0
    for k in range(lo, hi + 1):
        m = 1 << k
        v = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(
            np.complex64)
        vs = dsc.from_numpy(v)
        ref = np.fft.fft(v.astype(np.complex128))
        worst = max(worst, rel_err(dsc.fft(vs), ref))
        smoke.time(f'fft complex64 n=2^{k}', lambda: dsc.fft(vs))
    smoke.check(f'fft complex64 sweep 2^{lo}..2^{hi} ({hi - lo + 1} sizes)',
                worst, 1e-4, F32, why)
    plans = fft_plan.num_plans()
    print(f'  plan cache holds {plans} plans (cap {fft_plan.MAX_FFT_PLANS})',
          flush=True)
    if plans > 16:
        raise RuntimeError(f'num_plans() = {plans} > 16')


def phase_elementwise(smoke, shape=(8192, 8192), seed=2):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ad, bd = dsc.from_numpy(a), dsc.from_numpy(b)
    nb = a.nbytes
    clip_map = dsc.map(lambda x, y: dsc.clip(x * y + 0.5, -1.0, 1.0))
    why = 'np.isclose atol = rtol = 1e-5 (the repo oracle)'
    # an f32 sum of m terms carries up to ~log2(m) * eps * sum|x| of
    # rounding (1.5e-6 at m = 8192), so sums are held to that bound
    sum_why = 'relative to sum |x| per row: f32 summation, log2(m) * eps'
    m = shape[-1]
    sum_err = float((np.abs(dsc.sum(ad, axis=-1).numpy()
                            - a64.sum(axis=-1, keepdims=True))
                     / np.abs(a64).sum(axis=-1, keepdims=True)).max())
    smoke.check(f'sum axis=-1 {shape} f32', sum_err,
                np.log2(m) * np.finfo(np.float32).eps, 'float32', sum_why)
    smoke.time(f'sum axis=-1 {shape} f32', lambda: dsc.sum(ad, axis=-1), nb)
    cases = [
        ('add', lambda: dsc.add(ad, bd), a64 + b64, 3 * nb),
        ('mul', lambda: dsc.mul(ad, bd), a64 * b64, 3 * nb),
        ('sin', lambda: dsc.sin(ad), np.sin(a64), 2 * nb),
        ('exp', lambda: dsc.exp(ad), np.exp(a64), 2 * nb),
        ('map clip(x*y+0.5, -1, 1)', lambda: clip_map(ad, bd),
         np.clip(a64 * b64 + 0.5, -1.0, 1.0), 3 * nb),
        ('max axis=0', lambda: dsc.max(ad, axis=0),
         a64.max(axis=0, keepdims=True), nb),
    ]
    for what, fn, ref, nbytes in cases:
        what = f'{what} {shape} f32'
        smoke.check(what, oracle_err(fn(), ref), 1e-5, 'float32', why)
        smoke.time(what, fn, nbytes)


def phase_models(smoke, batch=8, n_stft=2**22, n_sos=2**20, seed=3,
                 trace_file=TRACE_FILE):
    rng = np.random.default_rng(seed)
    why = 'relative to max |reference|'
    x = rng.standard_normal((batch, n_stft)).astype(np.float32)
    xs = dsc.from_numpy(x)
    kw = dict(window='hann', nperseg=2048, noverlap=2048 - 512)
    with dsc.profile(file=trace_file, serve=False):
        _, _, zxx = models.stft(xs, **kw)
        ready(zxx)
    _, _, zref = sps.stft(x.astype(np.float64), **kw)
    what = f'stft ({batch}, {n_stft}) n_fft=2048 hop=512 hann'
    smoke.check(what, rel_err(zxx, zref), 1e-4, F32,
                'f32 2048-point transforms against an f64 reference, ' + why)
    del zref, zxx
    smoke.time(what, lambda: models.stft(xs, **kw)[2])

    y = x[:, :n_sos]
    ys = dsc.from_numpy(y)
    y64 = y.astype(np.float64)
    sos = models.butter(8, 0.25)
    what = f'sosfilt butter(8, 0.25) ({batch}, {n_sos})'
    smoke.check(what, rel_err(models.sosfilt(sos, ys), sps.sosfilt(sos, y64)),
                1e-4, 'float32, matmuls at HIGHEST',
                'f32 recurrence against an f64 reference, ' + why)
    smoke.time(what, lambda: models.sosfilt(sos, ys))

    what = f'welch ({batch}, {n_sos}) nperseg=256'
    _, pxx = models.welch(ys)
    _, pref = sps.welch(y64)
    smoke.check(what, rel_err(pxx, pref), 1e-4, 'float32',
                'f32 periodogram averages against f64, ' + why)
    smoke.time(what, lambda: models.welch(ys)[1])


def phase_compile(smoke, n=2**22, taps=4097, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    h = np.blackman(taps).astype(np.float32)
    out_len = n + taps - 1
    fft_n = fft_plan.next_pow2(out_len)

    @dsc.compile
    def conv(sig, flt):
        spec = dsc.rfft(sig, n=fft_n) * dsc.rfft(flt, n=fft_n)
        return dsc.irfft(spec)[:out_len]

    xs, hs = dsc.from_numpy(x), dsc.from_numpy(h)
    ref = sps.fftconvolve(x.astype(np.float64), h.astype(np.float64))
    what = f'dsc.compile fft convolution n={n} taps={taps}'
    smoke.check(what, rel_err(conv(xs, hs), ref), 1e-4, F32,
                'relative to max |reference|')
    smoke.time(what, lambda: conv(xs, hs))
    if conv.n_programs != 1:
        raise RuntimeError(f'{conv.n_programs} programs for one signature')


def phase_findings(smoke, n=2**24, shape=(8192, 8192), seed=5):
    """Same input, same process, in turns: the repo's FFT engine against
    XLA's own FFT (jnp.fft), and fma/sin against a same-size copy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    xs = dsc.from_numpy(x)
    xj = xs._buf.arr
    xla_pair = jax.jit(lambda v: jnp.fft.irfft(jnp.fft.rfft(v), n=n))
    why = 'relative to max |x|'
    smoke.check(f'repo rfft+irfft n={n}', rel_err(dsc.irfft(dsc.rfft(xs)), x),
                1e-4, F32, why)
    smoke.check(f'jnp.fft rfft+irfft n={n}', rel_err(xla_pair(xj), x), 1e-4,
                F32, why)
    t = smoke.time_pairs({
        f'repo rfft+irfft n={n}': lambda: dsc.irfft(dsc.rfft(xs)),
        f'jnp.fft rfft+irfft n={n}': lambda: xla_pair(xj),
    })
    a, b = list(t.values())
    print(f'  finding: repo / jnp.fft time ratio {a / b:.2f}', flush=True)

    u = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    ud = [dsc.from_numpy(v) for v in u]
    fma = dsc.map(lambda p, q, r: p * q + r)
    copy = jax.jit(jnp.negative)  # one read + one write, like a copy
    nb = u[0].nbytes
    smoke.check(f'map fma {shape} f32', oracle_err(
        fma(*ud), u[0].astype(np.float64) * u[1] + u[2]), 1e-5, 'float32',
        'np.isclose atol = rtol = 1e-5')
    t = smoke.time_pairs({
        f'copy {shape} f32': lambda: copy(ud[0]._buf.arr),
        f'map fma {shape} f32': lambda: fma(*ud),
        f'sin {shape} f32': lambda: dsc.sin(ud[0]),
    }, nbytes={f'copy {shape} f32': 2 * nb, f'map fma {shape} f32': 4 * nb,
               f'sin {shape} f32': 2 * nb})
    c, f, s = list(t.values())
    # rates are bytes moved over time: copy 2, fma 4, sin 2 arrays
    print(f'  finding: fma reaches {2 * c / f * 100:.0f}% and sin '
          f'{c / s * 100:.0f}% of the copy rate (bytes/time)', flush=True)


# ---------------------------------------------------------------------------
# multi-device paths (--multi)
# ---------------------------------------------------------------------------


def _spans(smoke, what, arr, count):
    devs = arr.sharding.device_set
    print(f'  {what}: sharding {arr.sharding} over {len(devs)} devices',
          flush=True)
    if len(devs) != count:
        smoke.failed.append(f'{what} spans {len(devs)} devices, not {count}')


def phase_multi(smoke, count=4, n=2**24, batch=16, n_conv=2**20, taps=4097,
                seed=6):
    from jax.sharding import PartitionSpec as P

    from dsc_tpu.parallel import (distributed_fft, distributed_fft_stream,
                                  distributed_irfft_stream,
                                  distributed_rfft_stream)

    import __graft_entry__

    __graft_entry__.dryrun_multichip(count)
    rng = np.random.default_rng(seed)
    why = 'relative to max |reference|'
    devices = jax.devices()[:count]
    mesh = dsc.make_mesh((1, count), devices=devices)
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    zj = jnp.asarray(z)
    zref = np.fft.fft(z.astype(np.complex128))
    for what, fn, ref in (
        (f'distributed_fft (1, {n}) mesh (1, {count})',
         lambda: distributed_fft(zj[None], mesh), zref[None]),
        (f'distributed_fft_stream {n}',
         lambda: distributed_fft_stream(zj, mesh), zref),
    ):
        out = fn()
        smoke.check(what, rel_err(out, ref), 1e-4, F32, why)
        _spans(smoke, what, out, count)
        smoke.time(what, fn)

    x = rng.standard_normal(n).astype(np.float32)
    xj = jnp.asarray(x)
    what = f'distributed_rfft_stream {n}'
    spec = distributed_rfft_stream(xj, mesh)
    smoke.check(what, rel_err(spec, np.fft.rfft(x.astype(np.float64))), 1e-4,
                F32, why)
    _spans(smoke, what, spec, count)
    smoke.time(what, lambda: distributed_rfft_stream(xj, mesh))
    what = f'distributed_irfft_stream {n}'
    back = distributed_irfft_stream(spec, mesh)
    smoke.check(what, rel_err(back, x), 1e-4, F32, why)
    _spans(smoke, what, back, count)
    smoke.time(what, lambda: distributed_irfft_stream(spec, mesh))

    dmesh = dsc.make_mesh((count, 1), devices=devices)
    s = rng.standard_normal((batch, n_conv)).astype(np.float32)
    h = np.blackman(taps).astype(np.float32)
    out_len = n_conv + taps - 1
    fft_n = fft_plan.next_pow2(out_len)

    def conv(sig, flt):
        spec = dsc.rfft(sig, n=fft_n) * dsc.rfft(flt, n=fft_n)
        return dsc.irfft(spec)[:, :out_len]

    pipe = dsc.compile(conv, mesh=dmesh, in_specs=(P('data'), P()),
                       out_specs=P('data'))
    sd, hd = dsc.from_numpy(s), dsc.from_numpy(h)
    what = f'mesh-compiled fft convolution ({batch}, {n_conv}) mesh ({count}, 1)'
    out = pipe(sd, hd)
    ref = sps.fftconvolve(s.astype(np.float64),
                          h.astype(np.float64)[None], axes=-1)
    smoke.check(what, rel_err(out, ref), 1e-4, F32, why)
    _spans(smoke, what, out._buf.arr, count)
    smoke.time(what, lambda: pipe(sd, hd))


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--multi', action='store_true',
                    help='run only the multi-device paths, on four GPUs')
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    device = {'platform': dev.platform, 'kind': dev.device_kind,
              'count': len(jax.devices())}
    print(f'jax.devices(): {jax.devices()}', flush=True)
    print(f'device_kind: {dev.device_kind}', flush=True)

    def finish(ok, **extra):
        print(json.dumps({'ok': ok, 'device': device, **extra}), flush=True)
        return 0 if ok else 1

    want = 4 if args.multi else 1
    if dev.platform != 'gpu' or device['count'] < want:
        # no device to report a result for: a failure line only
        print(json.dumps({'ok': False, 'error': f'needs {want} GPU(s); '
                          f'JAX found {device["count"]} {dev.platform}'}),
              flush=True)
        return 1
    cards = card_info()
    for card in cards:
        print(f'nvidia-smi name, power.limit: {card}', flush=True)
    print('compile cache: '
          f'{jax.config.jax_compilation_cache_dir or "(none)"}', flush=True)
    dsc.init(int(48 * 2**30))
    smoke = Smoke(card_label(cards))
    if args.multi:
        _phase(smoke, 'multi-device paths', phase_multi, count=want)
    else:
        _phase(smoke, '1 fft convolution', phase_fft_convolve)
        _phase(smoke, '2 fft family', phase_fft_family)
        _phase(smoke, '3 elementwise and reductions', phase_elementwise)
        _phase(smoke, '4 model tier', phase_models)
        _phase(smoke, '5 dsc.compile', phase_compile)
        _phase(smoke, '6 findings', phase_findings)
    if smoke.failed:
        print(f'FAILED: {smoke.failed}', file=sys.stderr)
    return finish(not smoke.failed)


if __name__ == '__main__':
    sys.exit(main())
