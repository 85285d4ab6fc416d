"""Test harness configuration.

Mirrors the reference suite's fixtures (test_ops.py:16-35): one dsc.init per
session, dsc.clear() after each test, and the all_close oracle helper
(atol=rtol=1e-5, equal_nan).

The suite runs on the CPU backend (``JAX_PLATFORMS=cpu``) with 8 virtual
host devices, so sharding tests exercise a real multi-device mesh on any
machine. Tests marked ``gpu`` need a GPU and skip without one; they run on a
GPU host with ``python -m pytest -m gpu tests/``.
"""

import os

import numpy as np
import pytest

# Only shapes the CPU platform's device count; other platforms ignore it.
os.environ['XLA_FLAGS'] = (
    os.environ.get('XLA_FLAGS', '') + ' --xla_force_host_platform_device_count=8'
)

import dsc_tpu as dsc  # noqa: E402

# Modules auto-marked `slow` (skipped by CI's -m "not slow" fast job,
# .github/workflows/tests.yml): the randomized fuzz sweep and the large
# mesh suites.
SLOW_MODULES = {'test_fuzz', 'test_sharding', 'test_compile'}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU —
    decided here, at run time, never while modules are imported."""
    if request.node.get_closest_marker('gpu') is not None:
        import jax

        if jax.devices()[0].platform != 'gpu':
            pytest.skip('needs a GPU (run with: python -m pytest -m gpu tests/)')


@pytest.fixture(scope='session', autouse=True)
def session_fixture():
    dsc.init(int(2**32), int(2**30))
    yield


@pytest.fixture(autouse=True)
def teardown_fixture():
    yield
    dsc.clear()


def all_close(actual, target, eps=1e-5):
    diffs = ~np.isclose(actual, target, atol=eps, rtol=eps, equal_nan=True)
    return np.asarray(actual)[diffs].size == 0


def random_nd(shape, dtype=np.float64):
    x = np.random.randn(*tuple(shape))
    if np.dtype(dtype).kind == 'c':
        x = x + 1j * np.random.randn(*tuple(shape))
    return x.astype(dtype)


DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
DSC_DTYPES = {
    np.float32: dsc.Dtype.F32,
    np.float64: dsc.Dtype.F64,
    np.complex64: dsc.Dtype.C32,
    np.complex128: dsc.Dtype.C64,
}


@pytest.fixture
def oracle():
    return all_close
