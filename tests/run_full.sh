#!/bin/sh
# Full-suite runner: the whole matrix in TWO pytest processes.
#
# A single pytest process over all of tests/ segfaults inside
# jaxlib's XLA:CPU backend_compile_and_load after several hundred
# in-process compilations (observed at ~75% progress, in whichever
# module lands there; the same module passes alone and in batch runs). The persistent compile cache is already disabled on CPU
# (dsc_tpu/context.py), so this is compiler-process longevity, not our
# cache: splitting the run into the fast and slow batches — the same
# shape CI and prior-round verdicts used — keeps each process under the
# crash horizon while still executing every test.
set -e
cd "$(dirname "$0")/.."
python -m pytest tests/ -q -m "not slow" "$@"
python -m pytest tests/ -q -m "slow" "$@"
