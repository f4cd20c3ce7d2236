"""Top-k-by-PPR-score retrieval head.

Build-only component (SURVEY.md L6 / [BASELINE] config 4): the reference
reports error/throughput, not top-k serving; this build adds a batched
candidate-generation head over the multi-source reserve matrix.

``p`` is vertex-major [N+1, S]; top-k runs per query over the vertex axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pprx.engine.state import PprState


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def topk_candidates(
    p: jnp.ndarray, k: int, chunk: int = 4096
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-query exact top-k vertices by reserve score.

    p: [N+1, S] reserve matrix (phantom row excluded from candidates).
    Returns (scores [S, k], ids [S, k]), scores descending per query.
    """
    return exact_topk_rows(p[:-1].T, k, chunk)


def exact_topk_rows(
    scores_t: jnp.ndarray, k: int, chunk: int = 4096
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact per-row top-k of [S, N] (trace-time helper for jitted callers,
    incl. the sharded local head).

    Two stages: per-chunk ``lax.top_k`` (each global top-k element is top-k
    within its own chunk, so the union of per-chunk winners provably
    contains the answer), then a final top-k over the m*k survivors."""
    s, n = scores_t.shape
    if n <= 2 * chunk or k > chunk:
        return jax.lax.top_k(scores_t, k)
    m = -(-n // chunk)
    pad = m * chunk - n
    xs = jnp.pad(scores_t, ((0, 0), (0, pad)), constant_values=-jnp.inf)
    sc, ix = jax.lax.top_k(xs.reshape(s, m, chunk), k)  # [S, m, k]
    ids = ix + (jnp.arange(m, dtype=ix.dtype) * chunk)[None, :, None]
    sc2, ij = jax.lax.top_k(sc.reshape(s, m * k), k)
    ids2 = jnp.take_along_axis(ids.reshape(s, m * k), ij, axis=1)
    # pad positions (score -inf) can surface ids >= n when a row has fewer
    # than k finite entries; clamp so the helper is safe for arbitrary input
    ids2 = jnp.where(ids2 < n, ids2, 0)
    return sc2, ids2


def retrieve(state: PprState, k: int = 100):
    """Candidate generation from a converged push state ([BASELINE] config 4:
    512 sources/launch, k=100)."""
    return topk_candidates(state.p, k)
