"""Frontier compaction + load-balanced expansion + CSR snapshot machinery.

Reference counterparts (SURVEY.md §2.1): "Frontier compaction" (stream
compaction into a dense work queue) and "Load-balanced expansion" (the
paper's key GPU contribution — splitting skewed adjacency rows across
threads). The static-shape equivalents:

- compaction: ``jnp.nonzero(..., size=fcap)`` into a fixed-capacity padded
  frontier (static shapes under jit);
- load balancing: EDGE-BALANCED expansion — instead of one work item per
  frontier vertex (which a power-law row would skew), the round enumerates
  frontier EDGES 0..total-1 directly and maps each back to its source row
  with a scatter-of-row-starts + cumsum (a vectorized run-length decode).
  Every lane does identical work regardless of degree skew; this is the
  static-shape answer to warp/CTA row splitting.
- CSR snapshot + signed COO overlay: the sliding window mutates every step,
  but sorting 2M edges per step would dominate. The sparse path expands
  over a periodically rebuilt CSR snapshot and corrects with a small signed
  overlay (insertions +1, expirations -1 since the snapshot); a snapshot
  row may still contain expired edges (the overlay's -1 cancels them) and
  miss fresh ones (+1 adds them). Exactness is tested against the dense
  path on every round (tests/test_sparse.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pprx import pytree


@pytree.dataclass
class CsrSnapshot:
    """Adjacency snapshot sorted by gather endpoint.

    offsets: int32[n+2] — row pointer over vertex ids 0..n (incl. phantom n).
    nbr:     int32[cap] — the other endpoint, row-major.
    row_len: int32[n+1] — snapshot row lengths (NOT current degrees: rows
        keep expired edges until the next rebuild).
    """

    offsets: jnp.ndarray
    nbr: jnp.ndarray
    row_len: jnp.ndarray


def build_snapshot(key: jnp.ndarray, other: jnp.ndarray, n: int) -> CsrSnapshot:
    """Jittable CSR build by sorting the COO window. ``key`` is the gather
    endpoint (src for forward mode, dst for reverse); phantom entries
    (key == n) sort to the tail and land in the phantom row.

    Offsets come from a bincount + cumsum, not jnp.searchsorted (a
    per-lane binary search)."""
    order = jnp.argsort(key)
    snbr = other[order]
    counts = jnp.zeros(n + 1, jnp.int32).at[key].add(1)
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    return CsrSnapshot(offsets=offsets, nbr=snbr, row_len=counts)


@pytree.dataclass
class Overlay:
    """Signed COO ring of edge changes since the last snapshot.

    src/dst: int32[cap]; sign: int8ish int32[cap] in {-1, 0, +1} (0 = slot
    unused). count tracked by the HOST (it is deterministic: +2b per slide).
    """

    src: jnp.ndarray
    dst: jnp.ndarray
    sign: jnp.ndarray

    @classmethod
    def empty(cls, cap: int, n: int) -> "Overlay":
        return cls(
            src=jnp.full(cap, n, jnp.int32),
            dst=jnp.full(cap, n, jnp.int32),
            sign=jnp.zeros(cap, jnp.int32),
        )


def compact_frontier(act_any: jnp.ndarray, fcap: int, n: int) -> jnp.ndarray:
    """Indices of active vertices, padded with phantom n to fcap."""
    (fidx,) = jnp.nonzero(act_any[:n], size=fcap, fill_value=n)
    return fidx.astype(jnp.int32)


def expand(
    fidx: jnp.ndarray,
    snap: CsrSnapshot,
    ecap: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Edge-balanced expansion of the frontier's snapshot rows.

    Returns (t, nbr, valid, total): for each of ecap edge lanes, ``t`` is the
    frontier position of its source row (for gathering compact per-frontier
    values), ``nbr`` the neighbor vertex (phantom-masked), ``valid`` a 0/1
    mask and ``total`` the true frontier edge count (for overflow fallback).
    """
    row_len_f = snap.row_len[fidx]  # phantom row length may be >0 (padding
    # edges live in the phantom row) — but fidx padding IS phantom n, whose
    # snapshot row holds only phantom-keyed entries; their nbr is phantom, so
    # expanded contributions vanish. Still, exclude them from `total` by
    # zeroing padded rows:
    is_pad = fidx == snap.row_len.shape[0] - 1
    row_len_f = jnp.where(is_pad, 0, row_len_f)
    starts = snap.offsets[fidx]
    cum = jnp.cumsum(row_len_f)
    total = cum[-1]
    cum_prev = cum - row_len_f  # exclusive prefix: first edge lane of each row
    # Edge-lane -> frontier-row mapping via scatter + cumsum, NOT
    # jnp.searchsorted (a per-lane binary search).
    # Each row scatters +1 at its first lane; empty rows stack their +1 on
    # the next row's start, which makes the running count skip them exactly.
    j = jnp.arange(ecap, dtype=jnp.int32)
    boundary = jnp.zeros(ecap + 1, jnp.int32).at[
        jnp.minimum(cum_prev, ecap)
    ].add(jnp.ones_like(cum_prev, jnp.int32))
    t = (jnp.cumsum(boundary[:ecap]) - 1).astype(jnp.int32)
    t_c = jnp.clip(t, 0, fidx.shape[0] - 1)
    pos = starts[t_c] + (j - cum_prev[t_c])
    valid = j < total
    pos = jnp.where(valid, pos, 0)
    nbr = jnp.where(valid, snap.nbr[pos], snap.row_len.shape[0] - 1)
    return t_c, nbr, valid, total
