"""Device placement, host transfers, the compile-cache rule, and what the
package must not contain: every dtype lives on JAX's default device,
complex arrays cross the host boundary directly, and no module reaches for
a Pallas kernel, interpret mode, a branch on the backend's name or a
removed engine knob."""

import pathlib
import re
import sys

import jax
import numpy as np
import pytest

import dsc_tpu as dsc
from dsc_tpu import context

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / 'dsc_tpu'


def _device_of(t):
    pp = t._planar
    arr = pp.re if pp is not None else t._buf.arr
    (dev,) = arr.devices()
    return dev


def test_c128_on_default_device():
    home = jax.devices()[0]
    rng = np.random.default_rng(0)
    z = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    t = dsc.from_numpy(z)
    assert t.dtype == dsc.Dtype.C64 and _device_of(t) == home
    for res in (
        dsc.fft(t),
        dsc.mul(t, dsc.from_numpy(z.astype(np.complex64))),
        dsc.cast(dsc.from_numpy(z.real.astype(np.float32)), dsc.Dtype.C64),
        dsc.randn(8, dtype=dsc.Dtype.C64),
        dsc.arange(8, dtype=dsc.Dtype.C64),
        dsc.full(4, 1 + 2j, dtype=dsc.Dtype.C64),
        dsc.hanning(16, dtype=dsc.Dtype.F64),
    ):
        assert _device_of(res) == home
    assert dsc.mul(t, t).dtype == dsc.Dtype.C64
    np.testing.assert_allclose(dsc.fft(t).numpy(), np.fft.fft(z), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
@pytest.mark.parametrize('shape', [(1,), (7,), (3, 5), (2, 3, 4)])
def test_complex_transfer_round_trip(dtype, shape):
    rng = np.random.default_rng(1)
    z = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(dtype)
    t = dsc.from_numpy(z)
    back = t.numpy()
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, z)
    # scalar unwrap and write-through keep exact values too
    assert complex(t.reshape(-1)[0]) == complex(z.reshape(-1)[0])
    t.reshape(-1)[0] = 3 - 4j
    assert t.numpy().reshape(-1)[0] == 3 - 4j


@pytest.mark.parametrize('environ,platforms,want', [
    ({'JAX_COMPILATION_CACHE_DIR': '/x/cache'}, '', None),
    ({'JAX_COMPILATION_CACHE_DIR': '/x/cache'}, 'cpu', None),
    ({}, 'cpu', None),
    ({}, 'cpu,cuda', None),
    ({}, '', context.REPO_CACHE_DIR),
    ({}, 'cuda', context.REPO_CACHE_DIR),
    ({}, 'cuda,cpu', context.REPO_CACHE_DIR),
])
def test_compile_cache_dir_rule(environ, platforms, want):
    assert context.compile_cache_dir(environ, platforms) == want


def test_repo_cache_dir_is_fixed():
    assert context.REPO_CACHE_DIR == str(ROOT / '.jax_cache')
    gitignore = (ROOT / '.gitignore').read_text().split()
    assert '.jax_cache/' in gitignore


def _sources():
    files = sorted(PKG.rglob('*.py'))
    files += [ROOT / 'bench.py', ROOT / '__graft_entry__.py',
              ROOT / 'chip_smoke.py']
    files += sorted((ROOT / 'benchmarks').rglob('*.py'))
    return files


def test_no_pallas_interpret_or_backend_branch():
    bad = re.compile(r"jax\.experimental\.pallas|interpret\s*=|"
                     r"default_backend\(\)\s*[!=]=")
    hits = [f'{f.relative_to(ROOT)}:{i}: {line.strip()}'
            for f in _sources()
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if bad.search(line)]
    assert hits == []


def test_no_pallas_module_loaded():
    import dsc_tpu.models  # noqa: F401
    import dsc_tpu.parallel  # noqa: F401
    import dsc_tpu.transforms  # noqa: F401

    loaded = [m for m in sys.modules
              if m.startswith('jax.experimental.pallas')]
    assert loaded == []


@pytest.mark.parametrize('knob', [
    'DSC_FFT_PALLAS', 'DSC_FFT_STREAM', 'DSC_FFT_PACKED', 'DSC_FFT_DEINT',
    'DSC_FFT_DFT_MODE', 'DSC_MAP_STREAM', 'DSC_MAP_CHUNK_ROWS',
    'DSC_MAP_DEPTH', 'DSC_MAP_BROW_IMPL', 'DSC_JAX_CACHE',
])
def test_removed_knob_absent(knob):
    docs = [ROOT / 'README.md', ROOT / 'docs' / 'API.md',
            ROOT / 'docs' / 'PARITY.md',
            ROOT / '.claude' / 'skills' / 'verify' / 'SKILL.md']
    hits = [str(f.relative_to(ROOT)) for f in _sources() + docs
            if f.exists() and knob in f.read_text()]
    assert hits == []


@pytest.mark.gpu
def test_gpu_computes_complex128():
    # runs only where JAX's default device is a GPU (conftest fixture)
    assert jax.devices()[0].platform == 'gpu'
    n = 2**20
    rng = np.random.default_rng(2)
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = dsc.fft(dsc.from_numpy(z))
    assert _device_of(y).platform == 'gpu'
    ref = np.fft.fft(z)
    assert np.abs(y.numpy() - ref).max() / np.abs(ref).max() < 1e-10
