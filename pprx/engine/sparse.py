"""Sparse-frontier push path with dense fallback (SURVEY.md §7 phase 4).

A dense round costs O(E*S) regardless of how little residual mass moves;
after a window slide the frontier is tiny (the corrections inject mass only
around the 2b touched endpoints), so the steady-state stream workload is
exactly where frontier sparsity pays. The sparse round costs
O(N*S_scan + F_edges*S) where the N*S term is one elementwise activity scan
of r (bandwidth-bound read) and F_edges is the frontier's snapshot row mass.

Round structure (forward; reverse swaps gather/scatter endpoints and
factors 1/d_out(u) out of the collective sum — see pprx/dist/sharded.py
for the same trick):

1. activity scan: act = |r| > threshold, any-source reduce, compaction
2. overflow test: frontier snapshot-row edges > ecap -> dense fallback
   (lax.cond; both branches exact, so the switch is pure performance)
3. frontier-restricted state update: p/r rows touched via fidx gathers
4. edge-balanced expansion over the CSR snapshot (pprx.engine.frontier)
5. signed overlay sweep (edges changed since snapshot)
6. one scatter-add of contributions into r

Exactness: sparse round == dense round to FP round-off on every state
(tested in tests/test_sparse.py, including snapshot-stale configurations).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from pprx import pytree
from pprx.config import PprConfig
from pprx.engine.frontier import CsrSnapshot, Overlay, build_snapshot, compact_frontier, expand
from pprx.engine.push import push_round_given_act, _active_mask
from pprx.engine.state import FORWARD, PprState, PushStats
from pprx.graph.dynamic import WindowGraph


@pytree.dataclass
class HybridGraph:
    """COO window + CSR snapshot + signed overlay (SURVEY.md §2.1 L0)."""

    window: WindowGraph
    snap: CsrSnapshot
    ov: Overlay

    @property
    def n(self) -> int:
        return self.window.n

    @classmethod
    def build(cls, window: WindowGraph, mode: int, overlay_cap: int) -> "HybridGraph":
        key = window.src if mode == FORWARD else window.dst
        other = window.dst if mode == FORWARD else window.src
        snap = build_snapshot(key, other, window.n)
        return cls(window=window, snap=snap, ov=Overlay.empty(overlay_cap, window.n))


def rebuild_snapshot(graph: HybridGraph, mode: int) -> HybridGraph:
    """Re-sort the live window into a fresh snapshot; clear the overlay."""
    w = graph.window
    key = w.src if mode == FORWARD else w.dst
    other = w.dst if mode == FORWARD else w.src
    snap = build_snapshot(key, other, w.n)
    cap = graph.ov.src.shape[0]
    return graph.replace(snap=snap, ov=Overlay.empty(cap, w.n))


def sparse_round(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int
) -> tuple[PprState, jnp.ndarray, jnp.ndarray]:
    """One frontier-sparse push round (caller guarantees no overflow; use
    ``adaptive_round`` for the guarded version)."""
    act = _active_mask(state, graph.window, cfg)
    return sparse_round_given_act(state, act, graph, cfg, fcap, ecap)


def sparse_round_given_act(
    state: PprState, act: jnp.ndarray, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int
) -> tuple[PprState, jnp.ndarray, jnp.ndarray]:
    dtype = state.r.dtype
    alpha = jnp.asarray(cfg.alpha, dtype)
    n = graph.n
    deg = graph.window.deg
    act_any = jnp.any(act, axis=1)
    fidx = compact_frontier(act_any, fcap, n)

    r_orig = state.r
    dangling = deg == 0
    inv_deg = 1.0 / jnp.maximum(deg, 1).astype(dtype)

    # frontier-restricted reserve absorption + residual removal
    act_f = act[fidx]
    mass_f = jnp.where(act_f, r_orig[fidx], jnp.zeros((), dtype))
    dang_f = dangling[fidx][:, None]
    p = state.p.at[fidx].add(jnp.where(dang_f, mass_f, alpha * mass_f))
    r = state.r.at[fidx].add(-mass_f)

    if state.mode == FORWARD:
        moving_f = (1.0 - alpha) * mass_f * inv_deg[fidx][:, None]
    else:
        beta = (1.0 - alpha) / alpha
        moving_f = jnp.where(dang_f, beta * mass_f, (1.0 - alpha) * mass_f)

    # snapshot expansion
    t, nbr, valid, _ = expand(fidx, graph.snap, ecap)
    contrib = moving_f[t] * valid.astype(dtype)[:, None]
    delta = jnp.zeros_like(r).at[nbr].add(contrib)

    # signed overlay sweep (gather at the mode's gather endpoint)
    ov = graph.ov
    gat = ov.src if state.mode == FORWARD else ov.dst
    sca = ov.dst if state.mode == FORWARD else ov.src
    mass_ov = jnp.where(act[gat], r_orig[gat], jnp.zeros((), dtype))
    if state.mode == FORWARD:
        mov_ov = (1.0 - alpha) * mass_ov * inv_deg[gat][:, None]
    else:
        beta = (1.0 - alpha) / alpha
        mov_ov = jnp.where(
            dangling[gat][:, None], beta * mass_ov, (1.0 - alpha) * mass_ov
        )
    delta = delta.at[sca].add(mov_ov * ov.sign.astype(dtype)[:, None])

    if state.mode == FORWARD:
        r = r + delta
    else:
        r = r + delta * inv_deg[:, None]

    p = p.at[-1].set(0.0)
    r = r.at[-1].set(0.0)
    n_active = jnp.sum(act, dtype=jnp.float32)
    edge_work = jnp.sum(
        act * graph.snap.row_len[:, None], dtype=jnp.float32
    )
    return state.replace(p=p, r=r), n_active, edge_work


def frontier_edge_count(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(#active pairs, #snapshot edges in any-source frontier rows)."""
    act = _active_mask(state, graph.window, cfg)
    act_any = jnp.any(act, axis=1)
    total = jnp.sum(
        jnp.where(act_any[: graph.n], graph.snap.row_len[: graph.n], 0),
        dtype=jnp.int64 if jax.config.jax_enable_x64 else jnp.int32,
    )
    n_active = jnp.sum(act, dtype=jnp.float32)
    return n_active, total


def adaptive_round_tiered(
    state: PprState,
    graph: HybridGraph,
    cfg: PprConfig,
    tiers: tuple[tuple[int, int], ...],
) -> tuple[PprState, jnp.ndarray, jnp.ndarray]:
    """Full-scan round at the smallest capacity tier that fits the EXACT
    frontier, dense fallback otherwise.

    ``tiers``: ((fcap_i, ecap_i), ...) smallest-first. The activity scan is
    O(N*S) either way; the tier only sizes the sparse round's gather/expand
    buffers (which otherwise dominate the round — static shapes mean a
    100-row frontier pays full-capacity buffers without this switch).
    The dense fallback also covers frontier-vertex overflow (> fcap)."""
    act = _active_mask(state, graph.window, cfg)
    act_any = jnp.any(act, axis=1)
    n_front = jnp.sum(act_any[: graph.n], dtype=jnp.int32)
    fedges = jnp.sum(
        jnp.where(act_any[: graph.n], graph.snap.row_len[: graph.n], 0),
        dtype=jnp.int32,
    )
    ov_n = graph.ov.src.shape[0]
    # worth it: frontier edge work (+overlay) below half the dense edge work
    worth = (fedges + ov_n) * 2 <= graph.window.capacity

    def sp_branch(i):
        f_i, e_i = tiers[i]

        def br(st, act_):
            return sparse_round_given_act(st, act_, graph, cfg, f_i, e_i)

        return br

    def dn(st, act_):
        return push_round_given_act(st, act_, graph.window, cfg)

    # fits: the expansion buffer must hold the frontier's snapshot edges
    # (the overlay sweep has its own fixed-size buffers and does not consume
    # expansion capacity). misses is monotone, so its sum is the first
    # fitting tier; len(tiers) selects the dense fallback.
    misses = [
        jnp.logical_not(
            jnp.logical_and(n_front <= f_i, fedges <= e_i)
        ).astype(jnp.int32)
        for (f_i, e_i) in tiers
    ]
    idx = jnp.where(worth, sum(misses), len(tiers))
    branches = [sp_branch(i) for i in range(len(tiers))] + [dn]
    return jax.lax.switch(idx, branches, state, act)


def adaptive_round(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int
) -> tuple[PprState, jnp.ndarray, jnp.ndarray]:
    """Single-tier adaptive round (sparse when the frontier fits and is
    worth it, dense otherwise)."""
    return adaptive_round_tiered(state, graph, cfg, ((fcap, ecap),))


def _dedup_compact(ids: jnp.ndarray, cap: int, phantom: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sorted dedup of a padded id list -> (unique ids padded to cap, count).

    Phantom entries sort last and are excluded from the count. Returns
    count > cap unchanged (caller must treat that as overflow; the returned
    list is then truncated and MUST NOT be used)."""
    s = jnp.sort(ids)
    first = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    keep = jnp.logical_and(first, s != phantom)
    count = jnp.sum(keep, dtype=jnp.int32)
    (pos,) = jnp.nonzero(keep, size=cap, fill_value=ids.shape[0] - 1)
    out = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, (cap,), 0) < jnp.minimum(count, cap),
        s[pos],
        phantom,
    )
    return out.astype(jnp.int32), count


def worklist_round(
    state: PprState,
    graph: HybridGraph,
    cfg: PprConfig,
    cand: jnp.ndarray,
    fcap: int,
    ecap: int,
    ovacap: int = 0,
) -> tuple[PprState, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, dict]:
    """One push round touching ONLY candidate rows — zero O(N*S) work.

    ``cand``: int32[wcap] DEDUPLICATED candidate rows (phantom-padded, live
    entries first), a superset of every currently-active row (the caller
    maintains this inductively: after a round, newly active rows are
    necessarily scatter targets of that round). This is the static-shape form
    of the reference's frontier work-queue (SURVEY.md §2.1 "Frontier compaction"):
    the queue lives across rounds, and each round's cost is proportional to
    the frontier, not to N.

    Returns (state', next_cand, next_count, n_active, edge_work, bounds)
    where ``bounds`` holds cheap 1-D-computed UPPER BOUNDS for the NEXT
    round's capacity needs (fed_ub: snapshot edges under all next
    candidates; live_ub: live overlay entries hitting them) — they let the
    convergence loop pick a capacity tier for the next round without an
    O(wcap*S) activity gather. The caller must verify next_count <= wcap
    BEFORE trusting next_cand (overflow -> scan-path reseed); the round
    itself is exact as long as the CALLER-chosen caps fit (guards the
    previous round's bounds provide inductively).
    """
    dtype = state.r.dtype
    alpha = jnp.asarray(cfg.alpha, dtype)
    n = graph.n
    deg = graph.window.deg
    wcap = cand.shape[0]

    r_c = state.r[cand]  # [wcap, S]
    deg_c = deg[cand]
    if state.mode == FORWARD:
        th = cfg.eps * jnp.maximum(deg_c, 1).astype(dtype)
        act_c = jnp.abs(r_c) > th[:, None]
    else:
        act_c = jnp.abs(r_c) > jnp.asarray(cfg.eps, dtype)
    any_c = jnp.any(act_c, axis=1)
    n_active = jnp.sum(act_c, dtype=jnp.float32)

    # compact the active subset (cand is deduped, so fidx rows are unique)
    (fpos,) = jnp.nonzero(any_c, size=fcap, fill_value=wcap - 1)
    in_range = jax.lax.broadcasted_iota(jnp.int32, (fcap,), 0) < jnp.sum(
        any_c, dtype=jnp.int32
    )
    fidx = jnp.where(in_range, cand[fpos], n).astype(jnp.int32)

    dangling = deg == 0
    inv_deg = 1.0 / jnp.maximum(deg, 1).astype(dtype)
    r_orig = state.r
    act_f = jnp.where(in_range[:, None], act_c[fpos], False)
    mass_f = jnp.where(act_f, r_orig[fidx], jnp.zeros((), dtype))
    dang_f = dangling[fidx][:, None]
    p = state.p.at[fidx].add(jnp.where(dang_f, mass_f, alpha * mass_f))
    r = state.r.at[fidx].add(-mass_f)

    if state.mode == FORWARD:
        moving_f = (1.0 - alpha) * mass_f * inv_deg[fidx][:, None]
    else:
        beta = (1.0 - alpha) / alpha
        moving_f = jnp.where(dang_f, beta * mass_f, (1.0 - alpha) * mass_f)

    t, nbr, valid, fedges = expand(fidx, graph.snap, ecap)
    contrib = moving_f[t] * valid.astype(dtype)[:, None]

    ov = graph.ov
    gat_full = ov.src if state.mode == FORWARD else ov.dst
    sca_full = ov.dst if state.mode == FORWARD else ov.src
    # Overlay sweep restricted to LIVE entries: only overlay edges whose
    # gather endpoint is in this round's frontier move mass, and the full
    # overlay capacity is typically >> the handful of live entries — the
    # unrestricted [ovcap, S] gather was the dominant per-round cost.
    # 1-D mark/compact over ovcap is cheap.
    ova = ovacap if ovacap > 0 else gat_full.shape[0]
    fmark = jnp.zeros(n + 1, jnp.int8).at[fidx].set(1).at[n].set(0)
    live = jnp.logical_and(fmark[gat_full] > 0, ov.sign != 0)
    n_live = jnp.sum(live, dtype=jnp.int32)
    (opos,) = jnp.nonzero(live, size=ova, fill_value=0)
    ovalid = jax.lax.broadcasted_iota(jnp.int32, (ova,), 0) < n_live
    gat = jnp.where(ovalid, gat_full[opos], n)
    sca = jnp.where(ovalid, sca_full[opos], n)
    sign_c = jnp.where(ovalid, ov.sign[opos], 0)
    if state.mode == FORWARD:
        th_ov = cfg.eps * jnp.maximum(deg[gat], 1).astype(dtype)
        act_ov = jnp.abs(r_orig[gat]) > th_ov[:, None]
        mass_ov = jnp.where(act_ov, r_orig[gat], jnp.zeros((), dtype))
        mov_ov = (1.0 - alpha) * mass_ov * inv_deg[gat][:, None]
    else:
        act_ov = jnp.abs(r_orig[gat]) > jnp.asarray(cfg.eps, dtype)
        mass_ov = jnp.where(act_ov, r_orig[gat], jnp.zeros((), dtype))
        beta = (1.0 - alpha) / alpha
        mov_ov = jnp.where(
            dangling[gat][:, None], beta * mass_ov, (1.0 - alpha) * mass_ov
        )
    mov_ov = mov_ov * sign_c.astype(dtype)[:, None]

    # scatter straight into r (no N-sized delta temp: saves ~3 full-state
    # memory passes per round). Reverse mode folds the receiver's 1/d_out
    # into each contribution via a gather instead of a full-state multiply.
    if state.mode != FORWARD:
        contrib = contrib * inv_deg[nbr][:, None]
        mov_ov = mov_ov * inv_deg[sca][:, None]
    r = r.at[nbr].add(contrib)
    r = r.at[sca].add(mov_ov)
    p = p.at[-1].set(0.0)
    r = r.at[-1].set(0.0)

    # next candidates = scatter targets (nbr + overlay). Dedup via a 1-D
    # mark array: O(N) scalar work per round is cheap (it was the O(N*S)
    # scans the worklist exists to avoid); a sort-based dedup of
    # ecap+overlay ids was slower on the previous accelerator.
    marks = jnp.zeros(n + 1, jnp.int8)
    marks = marks.at[nbr].set(1)
    marks = marks.at[sca].set(1)
    marks = marks.at[n].set(0)  # phantom never a candidate
    next_count = jnp.sum(marks, dtype=jnp.int32)
    (next_cand,) = jnp.nonzero(marks, size=wcap, fill_value=n)
    next_cand = next_cand.astype(jnp.int32)

    # capacity bounds for the NEXT round (all 1-D work): every next-round
    # active row is marked, so summing over marks upper-bounds the true
    # frontier's snapshot-edge and live-overlay needs
    fed_ub = jnp.sum(
        jnp.where(marks[:n] > 0, graph.snap.row_len[:n], 0), dtype=jnp.int32
    )
    live_ub = jnp.sum(
        jnp.logical_and(marks[gat_full] > 0, ov.sign != 0), dtype=jnp.int32
    )
    bounds = {"fed_ub": fed_ub, "live_ub": live_ub}

    edge_work = jnp.sum(act_c * graph.snap.row_len[cand][:, None], dtype=jnp.float32)
    return state.replace(p=p, r=r), next_cand, next_count, n_active, edge_work, bounds


def make_tiers(
    wcap: int,
    ecap: int,
    ovacap: int,
    n_tiers: int = 3,
    div: int = 4,
    min_wcap: int = 2048,
    min_ecap: int = 4096,
    min_ovacap: int = 1024,
) -> tuple[tuple[int, int, int], ...]:
    """Geometric capacity ladder for tiered worklist rounds, SMALLEST first.

    A worklist round's cost is proportional to its static buffer sizes, not
    to the actual frontier (static shapes under jit) — so steady-state
    rounds with a few hundred active rows must not pay the worst-round
    capacities. The convergence loop picks the smallest tier whose caps fit
    the (cheaply upper-bounded) frontier each round via ``lax.switch``.

    The ``min_*`` values are CUTOFFS, not clamps: a smaller tier is added
    only while every divided cap stays above its cutoff, so ladders are
    strictly monotone and small workloads collapse to a single tier.
    (Tiering tiny buffers has nothing to win, and only adds switch
    branches to compile.)"""
    tiers = [(wcap, ecap, ovacap)]
    for _ in range(n_tiers - 1):
        w2, e2, o2 = tiers[0]
        nxt = (w2 // div, e2 // div, o2 // div)
        if nxt[0] < min_wcap or nxt[1] < min_ecap or nxt[2] < min_ovacap:
            break
        tiers.insert(0, nxt)
    return tuple(tiers)


def push_to_convergence_worklist(
    state: PprState,
    graph: HybridGraph,
    cfg: PprConfig,
    cand0: jnp.ndarray,
    cand0_ok,
    tiers: tuple[tuple[int, int, int], ...],
    scan_fcap: int,
    scan_ecap: int,
) -> tuple[PprState, PushStats]:
    """Convergence loop whose steady-state rounds cost O(frontier), not O(N).

    Each iteration: if the candidate list is valid and the frontier bounds
    fit the largest tier, run a worklist round at the SMALLEST fitting
    capacity tier (``lax.switch`` over per-tier compilations of the round);
    otherwise run a full-scan adaptive round and reseed the candidate list
    from a fresh activity scan. ``tiers`` is smallest-first (see
    ``make_tiers``); the largest tier's wcap must equal ``cand0.shape[0]``.
    ``cand0`` seeds the list (e.g. the 4b correction endpoints after a
    window slide); pass ``cand0_ok=False`` to start with a scan (e.g. the
    initial seed push).

    Tier selection uses upper BOUNDS on the frontier's needs (snapshot edges
    / live overlay entries under ALL candidates, not just active ones),
    computed with 1-D ops only — no [wcap, S] activity gather per round.
    Bounds are carried between rounds (each round emits its successor's).
    """
    n = graph.n
    tiers = tuple(tiers)
    wcap, ecap, ovacap = tiers[-1]
    if cand0.shape[0] != wcap:
        raise ValueError(
            f"cand0 capacity {cand0.shape[0]} != largest tier wcap {wcap}"
        )
    row_len = graph.snap.row_len
    ov = graph.ov
    gat_full = ov.src if state.mode == FORWARD else ov.dst
    # scan rounds reuse the worklist ladder below their own (full-scan) caps
    scan_tiers = tuple((w, e) for (w, e, _) in tiers[:-1]) + ((scan_fcap, scan_ecap),)

    def overlay_live_bound(mark: jnp.ndarray) -> jnp.ndarray:
        return jnp.sum(
            jnp.logical_and(mark[gat_full] > 0, ov.sign != 0), dtype=jnp.int32
        )

    # seed bounds from cand0 (1-D work)
    live_rows0 = cand0 != n
    cn0 = jnp.sum(live_rows0, dtype=jnp.int32)
    fed0 = jnp.sum(jnp.where(live_rows0, row_len[cand0], 0), dtype=jnp.int32)
    cmark0 = jnp.zeros(n + 1, jnp.int8).at[cand0].set(1).at[n].set(0)
    liv0 = overlay_live_bound(cmark0)

    def body(c):
        st, cand, cn, fed, liv, cand_ok, _, stats = c
        # NOTE: an "exact-guard escalation" (recompute activity-based fed/liv
        # with an O(wcap*S) gather when these UBs overflow, to rescue rounds
        # for the worklist path) was tried and measured SLOWER: the rescued
        # rounds run near the TOP tier by construction, and a tiered scan
        # round beats a top-tier worklist round.
        fits = jnp.logical_and(
            jnp.logical_and(cn <= wcap, fed <= ecap), liv <= ovacap
        )
        use_wl = jnp.logical_and(cand_ok, fits)

        def tier_branch(i):
            w_i, e_i, o_i = tiers[i]

            def br(st):
                st2, cand2, n2, na, ew, b = worklist_round(
                    st, graph, cfg, cand[:w_i], w_i, e_i, o_i
                )
                # A tier round can mark up to e_i + o_i rows — more than its
                # own w_i — in which an event cand2 was TRUNCATED at w_i.
                # Overflow must be judged against the tier actually used, not
                # the carried wcap: flag it by pushing the count past wcap so
                # ok2 below goes False and the next round scan-reseeds.
                # (Round-1 advisor high finding: the old `n2 <= wcap` check
                # silently dropped candidates in (w_i, wcap] and converged
                # with unpushed residual above the eps bound.)
                n2 = jnp.where(n2 <= w_i, n2, wcap + 1)
                if w_i < wcap:  # pad back to the carried capacity
                    cand2 = jnp.full(wcap, n, jnp.int32).at[:w_i].set(cand2)
                return st2, cand2, n2, b["fed_ub"], b["live_ub"], na, ew

            return br

        def wl(st):
            if len(tiers) == 1:
                return tier_branch(0)(st)
            # smallest fitting tier; fits_i is monotone in i, and use_wl
            # guarantees the largest tier fits
            misses = [
                jnp.logical_not(
                    jnp.logical_and(
                        jnp.logical_and(cn <= w_i, fed <= e_i), liv <= o_i
                    )
                ).astype(jnp.int32)
                for (w_i, e_i, o_i) in tiers[:-1]
            ]
            idx = sum(misses)
            return jax.lax.switch(
                idx, [tier_branch(i) for i in range(len(tiers))], st
            )

        def scan(st):
            st2, na, ew = adaptive_round_tiered(st, graph, cfg, scan_tiers)
            act2 = _active_mask(st2, graph.window, cfg)
            any2 = jnp.any(act2[:n], axis=1)
            n2 = jnp.sum(any2, dtype=jnp.int32)
            (idx,) = jnp.nonzero(any2, size=wcap, fill_value=n)
            cand2 = idx.astype(jnp.int32)
            fed2 = jnp.sum(jnp.where(any2, row_len[:n], 0), dtype=jnp.int32)
            amark = jnp.zeros(n + 1, jnp.int8).at[:n].set(any2.astype(jnp.int8))
            return st2, cand2, n2, fed2, overlay_live_bound(amark), na, ew

        st2, cand2, n2, fed2, liv2, na, ew = jax.lax.cond(use_wl, wl, scan, st)
        # candidate overflow doesn't corrupt state (the round itself was
        # exact); it just forces a scan+reseed next iteration
        ok2 = n2 <= wcap
        not_wl = jnp.logical_not(use_wl).astype(jnp.int32)
        stats2 = PushStats(
            rounds=stats.rounds + 1,
            pushes=stats.pushes + na,
            edge_pushes=stats.edge_pushes + ew,
            wl_rounds=stats.wl_rounds + use_wl.astype(jnp.int32),
            scans_cand=stats.scans_cand
            + not_wl * jnp.logical_or(jnp.logical_not(cand_ok), cn > wcap).astype(jnp.int32),
            scans_fed=stats.scans_fed + not_wl * (fed > ecap).astype(jnp.int32),
            scans_liv=stats.scans_liv + not_wl * (liv > ovacap).astype(jnp.int32),
        )
        return st2, cand2, n2, fed2, liv2, ok2, na, stats2

    def cond(c):
        *_, na, stats = c
        return jnp.logical_and(na > 0, stats.rounds < cfg.max_rounds)

    # priming: with a valid candidate list, just enter the loop when any
    # candidate exists (a no-work round is an exact, tier-0-cheap no-op) —
    # the old activity-count prime cost an O(wcap*S) gather per slide;
    # without a candidate list, count via a full scan. Zero candidates means
    # zero active rows (candidates are a superset of the frontier), so idle
    # slides skip the loop and keep rounds-telemetry honest.
    def prime_wl(_):
        return (cn0 > 0).astype(jnp.float32)

    def prime_scan(_):
        return jnp.sum(_active_mask(state, graph.window, cfg), dtype=jnp.float32)

    na0 = jax.lax.cond(jnp.asarray(cand0_ok), prime_wl, prime_scan, 0)
    state, *_, stats = jax.lax.while_loop(
        cond,
        body,
        (state, cand0, cn0, fed0, liv0, jnp.asarray(cand0_ok), na0, PushStats.zero()),
    )
    return state, stats


def push_to_convergence_hybrid(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int
) -> tuple[PprState, PushStats]:
    """On-device convergence loop with per-round dense/sparse switching."""

    def cond(c):
        _, stats, n_active = c
        return jnp.logical_and(n_active > 0, stats.rounds < cfg.max_rounds)

    def body(c):
        st, stats, _ = c
        st2, na, ep = adaptive_round(st, graph, cfg, fcap, ecap)
        return (
            st2,
            PushStats(
                rounds=stats.rounds + 1,
                pushes=stats.pushes + na,
                edge_pushes=stats.edge_pushes + ep,
            ),
            na,
        )

    n0 = jnp.sum(_active_mask(state, graph.window, cfg), dtype=jnp.float32)
    state, stats, _ = jax.lax.while_loop(cond, body, (state, PushStats.zero(), n0))
    return state, stats
