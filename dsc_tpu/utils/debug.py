"""Debug / observability helpers.

Rebuild of the reference's debug story (SURVEY §5.2, §5.5):
- DSC_LOG_DEBUG-gated stderr logging (reference dsc.h:14-34) via the
  DSC_DEBUG env var or enable_debug_logging()
- sanitizer analog: jax_debug_nans (the nan_guard context manager)
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager

_debug = bool(os.environ.get('DSC_DEBUG'))


def enable_debug_logging(on: bool = True) -> None:
    global _debug
    _debug = on


def log_debug(msg: str) -> None:
    if _debug:
        print(f'[DSC DEBUG] {msg}', file=sys.stderr)


@contextmanager
def nan_guard():
    """Fail fast on NaNs inside jitted computations (the reference's
    ASan/assert analog for numeric bugs)."""
    import jax

    prev = jax.config.read('jax_debug_nans')
    jax.config.update('jax_debug_nans', True)
    try:
        yield
    finally:
        jax.config.update('jax_debug_nans', prev)
