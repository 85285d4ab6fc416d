"""Tracing / profiler contract (reference dsc_tracing.h/.cpp, profiler.py)."""

import json

import jax
import numpy as np

import dsc_tpu as dsc
from dsc_tpu import tracing


def test_profile_dumps_chrome_trace(tmp_path):
    path = tmp_path / 'traces.json'
    x = dsc.from_numpy(np.random.randn(64, 64).astype(np.float32))
    with dsc.profile(str(path), serve=False):
        y = x + x
        z = dsc.exp(y)
        dsc.sum(z, axis=0)
        dsc.rfft(dsc.from_numpy(np.random.randn(128).astype(np.float32)))

    data = json.loads(path.read_text())
    events = data['traceEvents']
    assert len(events) > 0
    names = {e['name'] for e in events}
    assert {'add', 'exp', 'sum', 'rfft'} <= names
    # Begin/End pairing with us timestamps + pid/tid
    # (reference dsc_tracing.h:328-426)
    begins = [e for e in events if e['ph'] == 'B']
    ends = [e for e in events if e['ph'] == 'E']
    assert len(begins) == len(ends)
    for e in events:
        assert 'ts' in e and 'pid' in e and 'tid' in e
    # op args carry shapes/dtypes (reference dsc_tracing.h:20-163)
    add_ev = next(e for e in begins if e['name'] == 'add')
    assert add_ev['args']['xa_shape'] == [64, 64]
    assert add_ev['cat'] == 'op;binary'
    # events carry backend + byte-size per tensor arg — the PJRT analog
    # of the reference's per-tensor backend/data-address payload
    # (dsc_tracing.h:287-312)
    assert add_ev['args']['xa_backend'] == jax.default_backend()
    assert add_ev['args']['xa_nbytes'] == 64 * 64 * 4
    assert add_ev['args']['xa_dtype'] == 'f32'


def test_profile_xprof_merge(tmp_path):
    # with xprof_dir the device timeline is merged
    # into the SAME traces.json (one Perfetto view, reference
    # dsc_tracing.cpp:260-280 single-timeline UX)
    path = tmp_path / 'traces.json'
    xdir = tmp_path / 'xprof'
    x = dsc.from_numpy(np.random.randn(256, 256).astype(np.float32))
    with dsc.profile(str(path), serve=False, xprof_dir=str(xdir)):
        y = dsc.exp(x + x)
        dsc.sum(y, axis=0)

    data = json.loads(path.read_text())
    events = data['traceEvents']
    from dsc_tpu.profiler import _DEVICE_PID_BASE

    dsc_evs = [e for e in events if e.get('pid', 0) < _DEVICE_PID_BASE]
    dev_evs = [e for e in events if e.get('pid', 0) >= _DEVICE_PID_BASE]
    assert {'add', 'exp', 'sum'} <= {e['name'] for e in dsc_evs}
    # device timeline present: named processes + complete ('X') events
    assert any(e.get('ph') == 'M' and e.get('name') == 'process_name'
               for e in dev_evs)
    xs = [e for e in dev_evs if e.get('ph') == 'X']
    assert xs
    # time-aligned: device events lie within (or near) the dsc ops' span
    ts_dsc = [e['ts'] for e in dsc_evs]
    lo, hi = min(ts_dsc) - 2e6, max(ts_dsc) + 2e6
    assert all(lo <= e['ts'] <= hi for e in xs)


def test_recording_off_is_free():
    tracing.clear_traces()
    x = dsc.from_numpy(np.random.randn(8).astype(np.float32))
    _ = x * 2.0
    assert tracing.num_traces() == 0


def test_start_stop_recording(tmp_path):
    tracing.clear_traces()
    dsc.start_recording()
    x = dsc.from_numpy(np.random.randn(8).astype(np.float32))
    _ = x + 1.0
    assert tracing.num_traces() > 0
    dsc.stop_recording(str(tmp_path / 't.json'), serve=False)
    assert tracing.num_traces() == 0  # cleared after dump


def test_trace_ring_capacity():
    tracing.clear_traces()
    old = tracing.MAX_TRACES
    tracing.MAX_TRACES = 10
    try:
        dsc.start_recording()
        x = dsc.from_numpy(np.random.randn(8).astype(np.float32))
        for _ in range(20):
            _ = x + 1.0
        assert tracing.num_traces() <= 10
    finally:
        dsc.stop_recording()
        tracing.MAX_TRACES = old
        tracing.clear_traces()
