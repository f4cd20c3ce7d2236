"""Property tests locking the push + dynamic-correction math to the invariant.

SURVEY.md §4 tier "Property/unit" and §2.3's re-derivation lock: the
correction coefficients are verified against the exact invariant (via the
dense resolvent M) to machine precision after every event, which is the
strongest possible check that the recalled-from-paper formulas were rederived
correctly.
"""

import numpy as np
import pytest

from pprx.ref.exact import exact_ppr, exact_ppr_matrix
from pprx.ref.push import (
    OracleGraph,
    PushState,
    apply_edge_event,
    forward_push,
    reverse_push,
)
from tests.conftest import random_multigraph

ALPHA = 0.2


def check_invariant(g, st, atol=1e-10):
    src, dst = g.coo()
    M = exact_ppr_matrix(src, dst, g.n, ALPHA)
    if st.mode == "forward":
        lhs = st.p + st.r @ M
        rhs = M[st.query]
    else:
        lhs = st.p + M @ st.r
        rhs = M[:, st.query]
    np.testing.assert_allclose(lhs, rhs, atol=atol)


@pytest.mark.parametrize("mode", ["forward", "reverse"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_invariant_holds_during_push(mode, seed):
    rng = np.random.default_rng(seed)
    n, m = 12, 40
    src, dst = random_multigraph(rng, n, m)
    g = OracleGraph(n, src, dst)
    st = PushState.init(n, query=int(rng.integers(n)), mode=mode)
    check_invariant(g, st)
    # run push in small bites, checking the invariant between bites
    for _ in range(5):
        if mode == "forward":
            forward_push(g, st, ALPHA, eps=1e-3, max_pushes=7)
        else:
            reverse_push(g, st, ALPHA, eps=1e-3, max_pushes=7)
        check_invariant(g, st)


@pytest.mark.parametrize("mode", ["forward", "reverse"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_invariant_survives_random_mutations(mode, seed):
    """THE correction-rule lock: random interleaved pushes + edge events."""
    rng = np.random.default_rng(seed)
    n = 10
    src, dst = random_multigraph(rng, n, 30)
    g = OracleGraph(n, src, dst)
    st = PushState.init(n, query=int(rng.integers(n)), mode=mode)
    push = forward_push if mode == "forward" else reverse_push
    push(g, st, ALPHA, eps=1e-4)
    for _ in range(60):
        if rng.random() < 0.5 or all(len(o) == 0 for o in g.out):
            u = int(rng.integers(n))
            w = (u + 1 + int(rng.integers(n - 1))) % n
            apply_edge_event(g, st, u, w, insert=True, alpha=ALPHA)
        else:
            cands = [u for u in range(n) if g.out[u]]
            u = cands[int(rng.integers(len(cands)))]
            w = g.out[u][int(rng.integers(len(g.out[u])))]
            apply_edge_event(g, st, u, w, insert=False, alpha=ALPHA)
        check_invariant(g, st)
        if rng.random() < 0.3:
            push(g, st, ALPHA, eps=1e-4, max_pushes=11)
            check_invariant(g, st)


def test_insert_to_and_delete_from_dangling():
    """Degree 0<->1 transitions exercise the special-case branches."""
    g = OracleGraph(3)
    g.add_edge(0, 1)
    st = PushState.init(3, query=0, mode="forward")
    forward_push(g, st, ALPHA, eps=1e-8)
    check_invariant(g, st)
    # vertex 1 is dangling with accumulated reserve; give it an edge
    apply_edge_event(g, st, 1, 2, insert=True, alpha=ALPHA)
    check_invariant(g, st)
    # and take it away again -> back to dangling
    apply_edge_event(g, st, 1, 2, insert=False, alpha=ALPHA)
    check_invariant(g, st)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_push_matches_exact(seed):
    rng = np.random.default_rng(seed)
    n, m = 30, 150
    src, dst = random_multigraph(rng, n, m)
    g = OracleGraph(n, src, dst)
    eps = 1e-7
    st = PushState.init(n, query=3, mode="forward")
    forward_push(g, st, ALPHA, eps=eps)
    pi = exact_ppr(src, dst, n, 3, ALPHA)
    # additive per-entry bound: |pi(t) - p(t)| <= eps * n (loose but safe)
    assert np.abs(pi - st.p).max() < eps * n
    assert np.abs(pi - st.p).sum() < 50 * eps * n


@pytest.mark.parametrize("seed", [0, 1])
def test_reverse_push_matches_exact(seed):
    rng = np.random.default_rng(seed)
    n, m = 25, 120
    src, dst = random_multigraph(rng, n, m)
    g = OracleGraph(n, src, dst)
    eps = 1e-8
    t = 5
    st = PushState.init(n, query=t, mode="reverse")
    reverse_push(g, st, ALPHA, eps=eps)
    M = exact_ppr_matrix(src, dst, n, ALPHA)
    # p(s) approximates pi_s(t) with additive error <= eps (times pi mass <= 1)
    np.testing.assert_allclose(st.p, M[:, t], atol=eps * n)


def test_dynamic_equals_recompute():
    """SURVEY.md §4 reference-parity shape: maintained state after a stream of
    events reaches the same accuracy as a from-scratch run on the final graph."""
    rng = np.random.default_rng(7)
    n = 20
    src, dst = random_multigraph(rng, n, 60)
    g = OracleGraph(n, src, dst)
    eps = 1e-9
    st = PushState.init(n, query=0, mode="forward")
    forward_push(g, st, ALPHA, eps=eps)
    for k in range(40):
        u = int(rng.integers(n))
        w = (u + 1 + int(rng.integers(n - 1))) % n
        apply_edge_event(g, st, u, w, insert=True, alpha=ALPHA)
        if k % 4 == 0:
            cands = [x for x in range(n) if g.out[x]]
            u = cands[int(rng.integers(len(cands)))]
            w = g.out[u][int(rng.integers(len(g.out[u])))]
            apply_edge_event(g, st, u, w, insert=False, alpha=ALPHA)
        forward_push(g, st, ALPHA, eps=eps)
    src2, dst2 = g.coo()
    pi = exact_ppr(src2, dst2, n, 0, ALPHA)
    assert np.abs(pi - st.p).max() < eps * n * 10


def test_exact_oracles_agree_with_the_dense_solve():
    """The power-iteration oracles used at sizes the dense solve cannot
    reach: batched PPR rows and reverse contribution columns of M."""
    from pprx.ref.exact import exact_contribution, exact_ppr_many

    rng = np.random.default_rng(21)
    n = 40
    src, dst = random_multigraph(rng, n, 160)
    src = np.concatenate([src, [5]])  # vertex 39 may dangle; keep a hub
    dst = np.concatenate([dst, [6]])
    M = exact_ppr_matrix(src, dst, n, ALPHA)
    rows = exact_ppr_many(src, dst, n, [0, 7, 33], ALPHA, tol=1e-14)
    np.testing.assert_allclose(rows, M[[0, 7, 33]], atol=1e-12)
    for t in (2, 19):
        col = exact_contribution(src, dst, n, t, ALPHA, tol=1e-14)
        np.testing.assert_allclose(col, M[:, t], atol=1e-12)
