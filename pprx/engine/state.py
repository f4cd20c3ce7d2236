"""PPR reserve/residual state as a JAX pytree.

Reference counterpart (SURVEY.md §2.1 "PPR state" / L1): per-query dense
p[]/r[] arrays. Design decisions:

- Layout is VERTEX-MAJOR, SOURCE-MINOR: ``[N+1, S]`` with S the batched
  query axis (SURVEY.md §2.4 "multi-source batching"). Each per-edge mass
  transfer then moves a contiguous 4*S-byte row, so gathers and scatters
  coalesce instead of making strided scalar accesses.
- Row N is a PHANTOM vertex: padded edges point src=dst=N, so gathers and
  scatter-adds on padding land harmlessly in a row that is forced inactive.
  This keeps every shape static under jit with no boolean edge masks on the
  hot path.
- float32 by default (eps=1e-6 regime); float64 available for oracle-parity
  tests on CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp

from pprx import pytree


@pytree.dataclass
class PprState:
    """Reserve/residual pair for S batched queries over N vertices.

    p, r: ``[N+1, S]`` — row N is the phantom padding row (always zero).
    mode: 0 = forward (queries are sources), 1 = reverse (queries are
        targets). Static field: forward/reverse compile to distinct programs.
    """

    p: jnp.ndarray
    r: jnp.ndarray
    mode: int = pytree.static_field(default=0)

    @property
    def n(self) -> int:
        return self.p.shape[0] - 1

    @property
    def n_queries(self) -> int:
        return self.p.shape[1]


@pytree.dataclass
class PushStats:
    """Device-side counters (SURVEY.md §5 tracing: rounds/pushes returned
    from jitted fns). pushes counts active (vertex, query) pairs processed;
    edge_pushes counts edge traversals weighted by active queries — the unit
    behind the pushes/s/chip metric (pprx.eval.perf).

    Counters are float32: with x64 off int64 narrows to int32, and 2^31
    overflows within one large benchmark; f32's ~1e-7 relative error is
    irrelevant for throughput metrics."""

    rounds: jnp.ndarray
    pushes: jnp.ndarray
    edge_pushes: jnp.ndarray
    # rounds served by the worklist path (0 for engines without one)
    wl_rounds: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32)
    )
    # why rounds fell back to the scan path (candidate-list overflow /
    # frontier-edge bound over ecap / live-overlay bound over ovacap) —
    # the knobs to retune when wl_rounds drops (SURVEY.md §5 observability)
    scans_cand: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32)
    )
    scans_fed: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32)
    )
    scans_liv: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32)
    )

    @staticmethod
    def zero():
        return PushStats(
            rounds=jnp.zeros((), jnp.int32),
            pushes=jnp.zeros((), jnp.float32),
            edge_pushes=jnp.zeros((), jnp.float32),
            wl_rounds=jnp.zeros((), jnp.int32),
        )


FORWARD = 0
REVERSE = 1


def init_state(n: int, queries: Sequence[int], mode: int = FORWARD, dtype=jnp.float32) -> PprState:
    """r = one-hot at each query, p = 0. ``queries`` indexes the S axis."""
    queries = jnp.asarray(queries, dtype=jnp.int32)
    s = queries.shape[0]
    p = jnp.zeros((n + 1, s), dtype=dtype)
    r = jnp.zeros((n + 1, s), dtype=dtype)
    r = r.at[queries, jnp.arange(s)].set(1.0)
    return PprState(p=p, r=r, mode=mode)
