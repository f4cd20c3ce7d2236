"""Compact-frontier v2 engine (pprx.engine.wl2): exactness vs the dense
engine, including tier overflows, kills, fresh-CSR delivery, and rebuilds
(SURVEY.md §4 property + oracle tiers)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pprx.config import PprConfig, StreamConfig
from pprx.engine.push import push_to_convergence
from pprx.engine.state import FORWARD, REVERSE, init_state
from pprx.engine.wl2 import build_kill_graph, make_tiers2, push_to_convergence_wl2
from pprx.graph.dynamic import WindowGraph
from pprx.graph.fast_stream import FastStreamDriver
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.graph.stream import StreamDriver
from tests.conftest import random_multigraph

CFG = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)


def reference(src, dst, n, queries, mode):
    graph = WindowGraph.from_coo(src, dst, n)
    st = init_state(n, queries, mode=mode, dtype=jnp.float64)
    st, stats = push_to_convergence(st, graph, CFG)
    return np.asarray(st.p), np.asarray(st.r), int(stats.rounds)


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
@pytest.mark.parametrize(
    "tiers",
    [
        ((64, 512, 16),),                 # comfortable single tier
        ((8, 32, 4), (64, 512, 16)),      # two-tier ladder
        ((16, 16, 4),),                   # expansion overflow -> scans
        ((4, 512, 16),),                  # emission overflow -> scan reseeds
    ],
)
def test_wl2_convergence_matches_dense(mode, tiers):
    _wl2_convergence_case(mode, tiers)


def _wl2_convergence_case(mode, tiers):
    rng = np.random.default_rng(7)
    n, m = 40, 200
    src, dst = random_multigraph(rng, n, m)
    window = WindowGraph.from_coo(src, dst, n)
    kg = build_kill_graph(window, mode, fring=8)
    queries = [0, 13, 26]
    st = init_state(n, queries, mode=mode, dtype=jnp.float64)
    q = np.unique(np.asarray(queries, np.int32))
    cand0 = jnp.asarray(np.concatenate([q, np.full(8 - q.size, n, np.int32)]))
    st, stats = push_to_convergence_wl2(
        st, kg, CFG, cand0, jnp.asarray(q.size, jnp.int32), True, tiers,
    )
    p_ref, r_ref, rounds_ref = reference(src, dst, n, queries, mode)
    np.testing.assert_allclose(np.asarray(st.p), p_ref, atol=1e-13)
    np.testing.assert_allclose(np.asarray(st.r), r_ref, atol=1e-13)
    assert int(stats.rounds) == rounds_ref  # same push schedule on every path
    assert int(stats.wl_rounds) <= int(stats.rounds)


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_fast_stream_matches_dense_stream(mode):
    n, total = 35, 500
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=11)
    scfg = StreamConfig(window=250, slide=25)
    queries = [0, 6, 17]

    a = StreamDriver(src, dst, n, queries, CFG, scfg, mode=mode, dtype=jnp.float64)
    a.seed()
    ra = [int(s.rounds) for s in a.run(10)]

    # rebuild_every=3 forces multiple snapshot rebuilds (kill-map refreshes)
    b = FastStreamDriver(
        src, dst, n, queries, CFG, scfg, mode=mode, dtype=jnp.float64,
        rebuild_every=3, e_top=64, n_tiers=3,
    )
    b.seed()
    rb = [int(s.rounds) for s in b.run(10)]

    assert ra == rb
    np.testing.assert_allclose(
        np.asarray(b.state.p), np.asarray(a.state.p), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(b.state.r), np.asarray(a.state.r), atol=1e-12
    )
    np.testing.assert_array_equal(
        np.asarray(b.graph.window.deg), np.asarray(a.graph.deg)
    )


def test_make_tiers2_collapses_for_tiny_graphs():
    tiers = make_tiers2(n=40, cap_snap=200, fring=8, e_top=65_536)
    assert len(tiers) == 1  # cutoffs collapse degenerate ladders
    tiers = make_tiers2(n=200_000, cap_snap=2_000_000, fring=160_000, e_top=160_000)
    assert len(tiers) >= 3
    for (w1, e1, g1), (w2, e2, g2) in zip(tiers, tiers[1:]):
        assert w1 < w2 and e1 < e2 and g1 < g2


def test_fast_stream_determinism():
    n, total = 35, 500
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=3)
    scfg = StreamConfig(window=250, slide=25)

    def run():
        d = FastStreamDriver(
            src, dst, n, [0, 5], CFG, scfg, mode=FORWARD, dtype=jnp.float64,
            rebuild_every=4,
        )
        d.seed()
        list(d.run(8))
        return np.asarray(d.state.p), np.asarray(d.state.r)

    p1, r1 = run()
    p2, r2 = run()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(r1, r2)


def test_wl2_sorted_delivery_parity(monkeypatch):
    """Force every compact round onto the sorted-delivery path by dropping
    SORT_DELIVER_MIN: the sorted delivery must be exact vs the dense
    engine."""
    import pprx.engine.wl2 as wl2mod

    monkeypatch.setattr(wl2mod, "SORT_DELIVER_MIN", 1)
    _wl2_convergence_case(FORWARD, ((64, 512, 16),))
    _wl2_convergence_case(REVERSE, ((8, 32, 4), (64, 512, 16)))


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
@pytest.mark.parametrize("s", [1, 8, 16, 128])
def test_dense_round_sorted_matches_push_round(mode, s):
    """One delivery-sorted dense round (the window-scale XLA sorted scatter
    plus the fresh-ring delivery, after kills) equals one COO round of the
    dense engine on the same live edge set, at narrow and wide query
    batches."""
    from pprx.engine.push import push_round
    from pprx.engine.wl2 import dense_round_sorted, refresh_fresh_csr

    rng = np.random.default_rng(3 + s)
    n, m, fring = 40, 240, 24
    src, dst = random_multigraph(rng, n, m)
    window = WindowGraph.from_coo(src, dst, n)
    kg = build_kill_graph(window, mode, fring=fring)
    # kill 12 snapshot edges and refill their slots as fresh edges, the way
    # a slide does, so both delivery views carry live mass
    slots = rng.choice(m, size=12, replace=False).astype(np.int32)
    new_src, new_dst = random_multigraph(rng, n, 12)
    new_src, new_dst = new_src.astype(np.int32), new_dst.astype(np.int32)
    src2, dst2 = src.copy(), dst.copy()
    src2[slots], dst2[slots] = new_src, new_dst
    w2 = WindowGraph.from_coo(src2, dst2, n)
    gat = new_src if mode == FORWARD else new_dst
    sca = new_dst if mode == FORWARD else new_src
    kg = kg.replace(
        window=w2,
        nbr=kg.nbr.at[kg.snap_pos[slots]].set(n),
        d_gat=kg.d_gat.at[kg.d_pos[slots]].set(n),
        fr_gat=kg.fr_gat.at[:12].set(gat),
        fr_sca=kg.fr_sca.at[:12].set(sca),
        f_len=kg.f_len.at[gat].add(1),
    )
    kg = refresh_fresh_csr(kg)
    queries = rng.integers(0, n, size=s).tolist()
    st = init_state(n, queries, mode=mode, dtype=jnp.float64)
    # a few dense rounds first, so r is spread over many rows
    for _ in range(2):
        st, _, _ = push_round(st, w2, CFG)
    got, na, _ = dense_round_sorted(st, kg, CFG)
    want, na_ref, _ = push_round(st, w2, CFG)
    np.testing.assert_allclose(np.asarray(got.p), np.asarray(want.p), atol=1e-14)
    np.testing.assert_allclose(np.asarray(got.r), np.asarray(want.r), atol=1e-14)
    assert float(na) == float(na_ref) > 0
