"""Device mesh helpers for multi-chip rendering.

The reference is single-GPU; its only work fan-out is the (unused) Rayon
secondary-command-buffer recorder (multithreading.rs:75-134) that splits
draw ranges across CPU threads. Here the *framebuffer rows* split across
devices: geometry is tiny (KBs) and replicated, pixel work dominates and
shards perfectly, and the only cross-device traffic is all-gathering the
finished row slabs + shadow map slices. The mesh is a plain 1-D axis:
the GPUs of one host are joined all to all (NVLink).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


ROWS_AXIS = "rows"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A 1D mesh over the framebuffer-rows axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ROWS_AXIS,))
