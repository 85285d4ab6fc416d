"""Tracing engine for dsc_tpu.

Rebuild of the reference tracing engine
(dsc/include/dsc_tracing.h, dsc/src/dsc_tracing.cpp).

The reference gates tracing at compile time and records Begin/End events in a
preallocated ring, dumping Chrome trace-event JSON for Perfetto. Here tracing
is gated at runtime by a flag checked on the op fast path (one branch when
off — the JAX analog of the compiled-out macros), events carry the same
payloads (op name, category, shapes, dtypes, us timestamps, pid/tid), and the
dump is the same Chrome trace-event JSON.

Because JAX dispatch is asynchronous, while recording each traced op blocks
on its result (``block_until_ready``) so the event duration reflects real
device time — the same perturb-when-profiling tradeoff the reference makes by
timestamping inside the op.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# DSC_MAX_TRACES equivalent (reference dsc.cpp:25-27, default 1000)
MAX_TRACES = int(os.environ.get('DSC_MAX_TRACES', '1000'))

_record = False
_events: List[Dict[str, Any]] = []
_lock = threading.Lock()
_t0_us: Optional[int] = None


def _now_us() -> int:
    return time.monotonic_ns() // 1000


def is_recording() -> bool:
    return _record


def set_recording(record: bool) -> None:
    """dsc_traces_record equivalent (reference dsc.cpp:327-329)."""
    global _record, _t0_us
    _record = bool(record)
    if _record and _t0_us is None:
        _t0_us = _now_us()


def clear_traces() -> None:
    """dsc_clear_traces equivalent (reference dsc.cpp:335-337)."""
    global _t0_us
    with _lock:
        _events.clear()
        _t0_us = None


def num_traces() -> int:
    return len(_events)


def _append(ev: Dict[str, Any]) -> None:
    with _lock:
        if len(_events) >= MAX_TRACES:
            # Preallocated-ring semantics: drop new events past capacity
            # (reference dsc_tracing.h ring of DSC_MAX_TRACES).
            return
        _events.append(ev)


@contextmanager
def trace_op(name: str, cat: str, args: Optional[Dict[str, Any]] = None):
    """RAII-equivalent of dsc_trace_tracker (dsc_tracing.h:328-426):
    records a Begin event on entry and an End event on exit."""
    if not _record:
        yield None
        return

    pid = os.getpid()
    tid = threading.get_ident() % 2**31
    begin = {
        'name': name,
        'cat': cat,
        'ph': 'B',
        'ts': _now_us(),
        'pid': pid,
        'tid': tid,
    }
    if args:
        begin['args'] = args
    _append(begin)
    holder = _ResultHolder()
    try:
        yield holder
    finally:
        # Make the duration meaningful under async dispatch.
        if holder.result is not None:
            try:
                import jax

                jax.block_until_ready(holder.result)
            except Exception:
                pass
        _append(
            {
                'name': name,
                'cat': cat,
                'ph': 'E',
                'ts': _now_us(),
                'pid': pid,
                'tid': tid,
            }
        )


class _ResultHolder:
    __slots__ = ('result',)

    def __init__(self):
        self.result = None


def tensor_args(**tensors) -> Dict[str, Any]:
    """Capture shapes/dtypes/backend/nbytes like the reference per-op arg
    structs (dsc_tracing.h:20-163, :287-312 — events there carry tensor
    backends and data addresses; device placement + byte size are the
    PJRT-world analog)."""
    if not _record:
        # args are ignored when recording is off — skip the introspection
        # cost on the untraced hot path
        return {}
    out: Dict[str, Any] = {}
    for key, t in tensors.items():
        if t is None:
            continue
        if hasattr(t, 'shape') and hasattr(t, 'dtype'):
            out[f'{key}_shape'] = list(t.shape)
            out[f'{key}_dtype'] = str(t.dtype)
            # storage leaf WITHOUT materializing planar tensors (t.jax on
            # a planar Tensor would build the dense complex array)
            pp = getattr(t, '_planar', None)
            leaf = pp.re if pp is not None else getattr(t, 'jax', t)
            try:
                dev = next(iter(leaf.devices()))
                out[f'{key}_backend'] = dev.platform
            except Exception:
                pass
            nb = getattr(pp if pp is not None else leaf, 'nbytes', None)
            if nb is not None:
                out[f'{key}_nbytes'] = int(nb)
        else:
            out[key] = t
    return out


def dump_traces(path: str, extra_events: Optional[List[Dict[str, Any]]] = None) -> None:
    """dsc_dump_traces equivalent: Chrome trace-event JSON consumable by
    Perfetto (reference dsc_tracing.cpp:260-280). ``extra_events`` lets the
    profiler append already-aligned device-timeline events (xprof merge)
    so ONE file holds dsc ops over device ops, preserving the reference's
    single-timeline UX (dsc_tracing.cpp:260-280)."""
    with _lock:
        events = list(_events)
    if extra_events:
        events = events + list(extra_events)
    with open(path, 'w') as f:
        json.dump({'traceEvents': events, 'displayTimeUnit': 'ms'}, f)


def now_us() -> int:
    """The tracing clock (monotonic µs) — event ``ts`` fields use this
    absolute base, so externally-aligned timelines (profiler xprof merge)
    offset against it."""
    return _now_us()
