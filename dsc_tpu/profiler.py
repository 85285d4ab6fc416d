"""Profiler / Perfetto UX for dsc_tpu.

Rebuild of the reference profiler (python/dsc/profiler.py):
``start_recording`` / ``stop_recording(file)`` toggle tracing and dump
Chrome trace-event JSON, and ``profile()`` is the context-manager wrapper.
``stop_recording`` can serve the trace over localhost and print a
ui.perfetto.dev deep link exactly like the reference (profiler.py:35-44,
technique credited there to JAX).

Addition: ``profile(xprof_dir=...)`` also wraps the region in
``jax.profiler.trace`` so device-level timelines (XLA ops, copies,
collectives) land in
an xprof trace next to the dsc-level events (SURVEY §5.1 obligation).
"""

from __future__ import annotations

import http.server
import os
import sys
from contextlib import contextmanager
from typing import Optional

from . import tracing

__all__ = ['start_recording', 'stop_recording', 'profile']


def start_recording() -> None:
    tracing.set_recording(True)


def _serve_traces(file_path: str, port: int = 9001) -> None:
    """Serve ``file_path`` once over localhost and print a Perfetto deep
    link (reference profiler.py:35-44)."""
    abs_path = os.path.abspath(file_path)
    directory = os.path.dirname(abs_path) or '.'
    filename = os.path.basename(abs_path)

    served = {'trace': False}

    class _Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, directory=directory, **kwargs)

        def end_headers(self):
            self.send_header('Access-Control-Allow-Origin', '*')
            super().end_headers()

        def do_GET(self):
            super().do_GET()
            if self.path.lstrip('/') == filename:
                served['trace'] = True

        def log_message(self, *args):
            pass

    with http.server.HTTPServer(('127.0.0.1', port), _Handler) as httpd:
        url = (
            f'https://ui.perfetto.dev/#!/?url=http://127.0.0.1:{port}/{filename}'
        )
        print(f'Open URL in browser: {url}')
        # Serve until the trace file itself has been fetched: the browser
        # may ask for favicon / CORS preflight first, so a single
        # handle_request() would hand Perfetto a connection refused
        while not served['trace']:
            httpd.handle_request()


def stop_recording(file: Optional[str] = None, serve: Optional[bool] = None,
                   _extra_events=None) -> None:
    """Stop tracing; if ``file`` is given dump Chrome trace-event JSON there
    and (interactively) serve it for ui.perfetto.dev."""
    tracing.set_recording(False)
    if file:
        tracing.dump_traces(file, extra_events=_extra_events)
        if serve is None:
            serve = sys.stdout.isatty() and not os.environ.get('DSC_NO_SERVE')
        if serve:
            _serve_traces(file)
    tracing.clear_traces()


# device-timeline events get pids far above any real os.getpid() so the
# merged view keeps dsc ops and device ops as separate Perfetto processes
_DEVICE_PID_BASE = 1 << 22


def _load_xprof_events(xprof_dir: str, offset_us: float):
    """Newest xprof run under ``xprof_dir`` -> Chrome trace events aligned
    to the dsc tracing clock (xprof ``ts`` is µs since its start_trace;
    ``offset_us`` is that instant on the dsc monotonic-µs clock). One
    Perfetto view then shows dsc ops OVER device ops — the reference's
    single-timeline UX (dsc_tracing.cpp:260-280)."""
    import glob
    import gzip
    import json

    paths = sorted(
        glob.glob(os.path.join(xprof_dir, 'plugins', 'profile', '*',
                               '*.trace.json.gz'))
    )
    if not paths:
        return []
    with gzip.open(paths[-1], 'rt') as f:
        tr = json.load(f)
    out = []
    for ev in tr.get('traceEvents', []):
        if not isinstance(ev, dict) or 'pid' not in ev:
            continue
        ev = dict(ev)
        ev['pid'] = _DEVICE_PID_BASE + int(ev['pid'])
        if 'ts' in ev:
            ev['ts'] = round(ev['ts'] + offset_us, 3)
        out.append(ev)
    return out


@contextmanager
def profile(file: str = 'traces.json', serve: Optional[bool] = None,
            xprof_dir: Optional[str] = None):
    """``with dsc.profile(): ...`` (reference profiler.py:57-63).

    With ``xprof_dir`` the region is also captured by ``jax.profiler``
    and the device timeline (XLA ops, DMA) is MERGED into ``file`` next
    to the dsc-level events, time-aligned, as extra Perfetto processes —
    plus the raw xprof artifacts stay under ``xprof_dir`` for xprof UIs."""
    t_xprof_us = None
    if xprof_dir:
        import jax

        jax.profiler.start_trace(xprof_dir)
        t_xprof_us = tracing.now_us()
    start_recording()
    try:
        yield
    finally:
        extra = None
        if xprof_dir:
            import jax

            jax.profiler.stop_trace()
            try:
                extra = _load_xprof_events(xprof_dir, float(t_xprof_us))
            except Exception as e:  # pragma: no cover — merge is best-effort
                print(f'dsc_tpu: xprof merge failed: {e}', file=sys.stderr)
        stop_recording(file, serve=serve, _extra_events=extra)
