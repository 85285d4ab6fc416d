"""pip install -e .  (reference setup.py parity; no native build step needed
for the Python package — the C++ front door builds separately via
``make -C cpp``)."""

from setuptools import find_packages, setup

setup(
    name='dsc_tpu',
    version='0.1.0',
    description='NumPy-compatible array framework '
                '(dspcraft/dsc rebuilt for JAX/XLA)',
    packages=find_packages(include=['dsc_tpu', 'dsc_tpu.*']),
    python_requires='>=3.10',
    install_requires=['numpy', 'jax'],
)
