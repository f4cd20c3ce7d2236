"""Device-mesh construction (SURVEY.md §2.4, L5).

The build's parallel layout is a 2-D mesh:
- ``rows``: the vertex dimension is row-sharded — each device owns a
  contiguous block of vertices, their out-edges (forward mode) or in-edges
  (reverse mode), their degrees, and their rows of p/r. Push-round
  communication rides this axis (reduce-scatter of residual deltas).
- ``srcs``: the batched-query axis is data-parallel — no communication
  during push; only the retrieval head and metrics ever cross it.

The GPUs of one host reach each other all to all over NVLink, so the mesh
follows the algorithm alone: every per-round collective runs along 'rows',
and 'srcs' carries no per-round traffic. Multi-host runs initialize via
``jax.distributed.initialize()`` before building the mesh (SURVEY.md §5
"Distributed communication backend").
"""

from __future__ import annotations

import jax


def make_row_mesh(n_rows: int, n_srcs: int = 1, devices=None) -> jax.sharding.Mesh:
    """Build the ('rows', 'srcs') mesh over ``n_rows * n_srcs`` devices."""
    if devices is None:
        devices = jax.devices()
    need = n_rows * n_srcs
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    import numpy as np

    dev_array = np.asarray(devices[:need]).reshape(n_rows, n_srcs)
    return jax.sharding.Mesh(dev_array, ("rows", "srcs"))
