"""Device-mesh helpers.

The reference has no distributed story at all (SURVEY §2.4); the scaling
path here is jax.sharding over a Mesh with XLA collectives over the device
interconnect (SURVEY §5.8). The two axes used by this framework:

- 'data'  — batch (DP): independent transforms spread over devices
- 'model' — transform-length (the TP/SP analog): one large FFT factorized
  over devices, exchanging via all-to-all (the four-step transpose)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ('data', 'model'),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a 2-D ('data', 'model') mesh. Default: all devices on 'data'."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise RuntimeError(f'mesh shape {shape} != {n} devices')
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))
