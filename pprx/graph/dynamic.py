"""Device-resident dynamic graph: fixed-capacity COO window.

Reference counterpart (SURVEY.md §2.1 "Dynamic graph store" / L0): the
reference mutates a CSR with the sliding window. This design instead
exploits the FIFO structure of the window: the live edge set is a
contiguous slice of the timestamped stream, so the device store is a
CIRCULAR COO BUFFER of static capacity — a slide step overwrites exactly
the slots whose edges are expiring. No in-place CSR surgery, no dynamic
shapes, and buffer donation makes the step allocation-free:

- ``src/dst: int32[capacity]`` — window edges, position ``i`` holds stream
  edge ``(step*b + i) mod capacity``. Unfilled slots point at the phantom
  vertex N (harmless in every gather/scatter, see pprx.engine.state).
- ``deg: int32[N+1]`` — out-degrees maintained incrementally (exact).

CSR/CSC views for the sparse frontier path are derived by (re)sorting this
buffer (pprx.engine.frontier), amortized over many slides — a sort is one
bulk pass, whereas scattered CSR mutation is not.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pprx import pytree


@pytree.dataclass
class WindowGraph:
    """COO edge window on device. Static capacity; phantom-padded."""

    src: jnp.ndarray  # int32[capacity]
    dst: jnp.ndarray  # int32[capacity]
    deg: jnp.ndarray  # int32[N+1] out-degrees (phantom row N unused)

    @property
    def n(self) -> int:
        return self.deg.shape[0] - 1

    @property
    def capacity(self) -> int:
        return self.src.shape[0]

    @classmethod
    def from_coo(cls, src, dst, n: int, capacity: int | None = None) -> "WindowGraph":
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        m = src.shape[0]
        if capacity is None:
            capacity = m
        if capacity < m:
            raise ValueError(f"capacity {capacity} < number of edges {m}")
        pad = np.full(capacity - m, n, dtype=np.int32)
        deg = np.bincount(src, minlength=n + 1).astype(np.int32)
        return cls(
            src=jnp.asarray(np.concatenate([src, pad])),
            dst=jnp.asarray(np.concatenate([dst, pad])),
            deg=jnp.asarray(deg),
        )

    def coo_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """Live (src, dst) with phantom padding stripped (host-side)."""
        s = np.asarray(self.src)
        d = np.asarray(self.dst)
        keep = s != self.n
        return s[keep], d[keep]
