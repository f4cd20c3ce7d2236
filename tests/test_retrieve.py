"""Retrieval head + metrics ([BASELINE] config 4 shape, small scale)."""

import jax.numpy as jnp
import numpy as np

from pprx.config import PprConfig
from pprx.engine.push import push_to_convergence
from pprx.engine.state import FORWARD, init_state
from pprx.eval.metrics import l1_error, precision_at_k
from pprx.graph.dynamic import WindowGraph
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.ref.exact import exact_ppr
from pprx.retrieve import retrieve

ALPHA = 0.15
CFG = PprConfig(alpha=ALPHA, eps=1e-9, max_rounds=10_000)


def test_topk_matches_exact_ranking():
    n, m = 120, 900
    src, dst, _ = synthetic_powerlaw_stream(n, m, seed=4)
    graph = WindowGraph.from_coo(src, dst, n)
    queries = [0, 3, 17, 50]
    state = init_state(n, queries, mode=FORWARD, dtype=jnp.float64)
    state, _ = push_to_convergence(state, graph, CFG)
    k = 20
    scores, ids = retrieve(state, k=k)
    assert scores.shape == (len(queries), k) and ids.shape == (len(queries), k)
    for j, q in enumerate(queries):
        pi = exact_ppr(src, dst, n, q, ALPHA)
        prec = precision_at_k(np.asarray(ids[j]), pi, k)
        assert prec == 1.0, f"query {q}: precision@{k} = {prec}"
        # forward-push L1 bound: sum_v |r(v)| <= eps * sum_v d_out(v) = eps*E
        assert l1_error(np.asarray(state.p)[:n, j], pi) < CFG.eps * m
        # scores descending
        s = np.asarray(scores[j])
        assert (np.diff(s) <= 1e-15).all()


def test_precision_at_k_tie_handling():
    exact = np.array([0.5, 0.3, 0.3, 0.1])
    assert precision_at_k(np.array([0, 2]), exact, 2) == 1.0  # tie at boundary
    assert precision_at_k(np.array([0, 3]), exact, 2) == 0.5


def test_recall_at_k_ties_rigorous():
    from pprx.eval.metrics import recall_at_k_ties

    exact = np.array([0.5, 0.3, 0.3, 0.3, 0.1])
    # k=2 boundary at 0.3: one strictly-above (id 0) + one boundary slot.
    # Any tie-equivalent pick for the slot scores 1.0 ...
    assert recall_at_k_ties(np.array([0, 3]), exact, 2) == 1.0
    assert recall_at_k_ties(np.array([0, 1]), exact, 2) == 1.0
    # ... but backfilling ties can NOT mask a missed strictly-above vertex
    # (this is where the plain >=kth convention overcounts)
    assert recall_at_k_ties(np.array([2, 3]), exact, 2) == 0.5
    assert precision_at_k(np.array([2, 3]), exact, 2) == 1.0
    # tie-free boundary: equals plain set recall
    assert recall_at_k_ties(np.array([0, 4]), exact, 2) == 0.5


def test_two_stage_exact_topk_matches_single_sort():
    """The chunked exact path (pads N to a chunk multiple, per-chunk top-k,
    merge) must equal lax.top_k of the full rows — including duplicate
    scores and a non-divisible N."""
    from pprx.retrieve.topk import topk_candidates
    import jax

    rng = np.random.default_rng(11)
    n, s, k = 1000, 4, 7
    p = rng.random((n + 1, s)).astype(np.float32)
    p[50:60, :] = 0.5  # duplicate scores across the chunk boundary region
    p = jnp.asarray(p)
    sc_ref, _ = jax.lax.top_k(p[:-1].T, k)
    sc2, ids2 = topk_candidates(p, k=k, chunk=64)  # 1000 % 64 != 0
    np.testing.assert_array_equal(np.asarray(sc2), np.asarray(sc_ref))
    # returned ids must actually hold the returned scores
    got = np.take_along_axis(np.asarray(p[:-1].T), np.asarray(ids2), axis=1)
    np.testing.assert_array_equal(got, np.asarray(sc2))
