"""Compact-frontier push engine v2: slot-sized rounds, kill-in-place CSR.

Reference counterparts (SURVEY.md §2.1 "Forward/Reverse-push kernel",
"Frontier compaction", "Load-balanced expansion", "Convergence controller";
§3.2 hot loop). This is the redesign of pprx.engine.sparse around two cost
facts of the earlier engine:

- ``jnp.nonzero`` and 1-D gathers over **N-sized** arrays set a per-round
  floor (mark-array dedup + compaction), while slot-sized
  (frontier-proportional) 1-D ops cost a small fraction of it.
- A ``lax.while_loop`` iteration has a fixed cost regardless of carry size,
  and an unsorted scatter pays per row on top of a fixed launch cost.

Consequences baked into this engine:

1. **Candidate lists stay compact.** Each round's next-frontier candidates
   are exactly its delivery targets; duplicates are resolved by a
   *winner-dedup*: scatter each target's lane id into a scratch row array
   and gather it back — the lane that reads its own id owns the row. All
   1-D work is sized by the round's own target count, never by N.
2. **No signed overlay.** Window expiries are *killed in place* in the CSR
   snapshot (neighbor slot set to the phantom vertex; the expansion masks
   phantom targets, so a dead slot wastes one lane and moves no mass).
   Kill positions come from a device-resident slot→snapshot-position map
   built with two argsorts at rebuild time. Fresh edges since the snapshot
   live in a per-slide-rebuilt mini-CSR sorted by gather endpoint, expanded
   exactly like the snapshot — no per-round sweep over an overlay ring.
3. **Exact tier selection.** Round capacities come from a geometric ladder
   (``make_tiers2``); the counts that pick a tier (live candidates cn,
   snapshot-edge bound fed, fresh-edge bound fre) are computed exactly from
   compact arrays, so rounds fall back to a full scan only when the
   frontier genuinely outgrows the ladder (or a growth round overflows its
   emission capacity). The scan fallback is one dense COO round
   (pprx.engine.push) plus an exact reseed.

Exactness: every path is exact (tier choice and scan fallback are pure
performance decisions); parity with the dense engine and the NumPy oracle
is tested in tests/test_wl2.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pprx import pytree
from pprx.config import PprConfig
from pprx.engine.push import _active_mask
from pprx.engine.state import FORWARD, PprState, PushStats
from pprx.graph.dynamic import WindowGraph

# Scan/dense-flush rounds skip the O(N*S) post-delivery rescan while the
# current frontier's edge mass exceeds STATS_GUARD * the ladder top: the
# successor round will be another scan anyway (the frontier decays about
# 1.45x per round at headline shapes). A misprediction costs one extra scan
# round; the skip saves the rescan on most mid-flush rounds.
# Shared with the sharded engine (pprx.dist.wl).
STATS_GUARD = 2


@pytree.dataclass
class KillGraph:
    """COO window + kill-in-place CSR snapshot + fresh mini-CSR (L0).

    offsets/nbr/row_len: CSR snapshot sorted by the mode's GATHER endpoint
        (src forward, dst reverse). ``nbr`` holds the scatter endpoint;
        killed (expired) slots hold the phantom vertex N. ``row_len`` is the
        snapshot traversal length (live + dead slots — it only shrinks at
        rebuild).
    snap_pos: int32[capacity] — window ring slot -> snapshot position, for
        O(1) kill lookups (valid for every slot that still holds a
        snapshot-era edge; fresh edges never expire between rebuilds, which
        the driver asserts via rebuild_every * slide <= window).
    fr_gat/fr_sca: raw fresh-edge ring (insertion order; phantom-padded).
    f_off/f_nbr/f_len: fresh mini-CSR re-sorted from the ring each slide.
    """

    window: WindowGraph
    offsets: jnp.ndarray
    nbr: jnp.ndarray
    row_len: jnp.ndarray
    snap_pos: jnp.ndarray
    fr_gat: jnp.ndarray
    fr_sca: jnp.ndarray
    f_off: jnp.ndarray
    f_nbr: jnp.ndarray
    f_len: jnp.ndarray
    # delivery-sorted snapshot view (sorted by SCATTER endpoint): big scan
    # rounds use it for a residual scatter with sorted indices, whose
    # writes to one destination row are contiguous. d_sca stays sorted for
    # the snapshot's life (kills only point d_gat at the phantom row).
    d_gat: jnp.ndarray
    d_sca: jnp.ndarray
    d_pos: jnp.ndarray
    # delivery-sorted FRESH view, re-sorted each slide alongside the
    # mini-CSR, so the dense round's fresh delivery is a sorted scatter too.
    fd_gat: jnp.ndarray
    fd_sca: jnp.ndarray

    @property
    def n(self) -> int:
        return self.window.n


def build_kill_graph(window: WindowGraph, mode: int, fring: int) -> KillGraph:
    """Jittable snapshot build: stable-sort the window by gather endpoint,
    plus a second view sorted by scatter endpoint for dense scan rounds.

    Both sorts carry the payload columns through ``lax.sort`` multi-operand
    (one sort moves key + iota + payload together) instead of an argsort
    followed by window-sized 1-D gathers. snap_pos (slot -> snapshot rank)
    comes from a double argsort rather than an O(W) unsorted scatter."""
    n = window.n
    key = window.src if mode == FORWARD else window.dst
    other = window.dst if mode == FORWARD else window.src
    cap = key.shape[0]
    iota = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0)
    _, order, nbr = jax.lax.sort(
        (key, iota, other), num_keys=1, is_stable=True
    )
    snap_pos = jnp.argsort(order, stable=True).astype(jnp.int32)
    counts = jnp.zeros(n + 1, jnp.int32).at[key].add(1)
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    d_sca0, order_d, d_gat0 = jax.lax.sort(
        (other, iota, key), num_keys=1, is_stable=True
    )
    d_pos = jnp.argsort(order_d, stable=True).astype(jnp.int32)
    fd_empty = jnp.full(fring, n, jnp.int32)
    return KillGraph(
        window=window,
        offsets=offsets,
        nbr=nbr.astype(jnp.int32),
        row_len=counts,
        snap_pos=snap_pos,
        fr_gat=jnp.full(fring, n, jnp.int32),
        fr_sca=jnp.full(fring, n, jnp.int32),
        f_off=jnp.zeros(n + 2, jnp.int32),
        f_nbr=jnp.full(fring, n, jnp.int32),
        f_len=jnp.zeros(n + 1, jnp.int32),
        d_gat=d_gat0.astype(jnp.int32),
        d_sca=d_sca0.astype(jnp.int32),
        d_pos=d_pos,
        fd_gat=fd_empty,
        fd_sca=fd_empty,
    )


def dense_round_sorted(
    state: PprState, kg: KillGraph, cfg: PprConfig
) -> tuple[PprState, jnp.ndarray, jnp.ndarray]:
    """Dense push round over the delivery-sorted snapshot + fresh ring.

    Exact peer of pprx.engine.push.push_round (tested): contributions are
    produced in scatter-endpoint order so the window-sized residual scatter
    runs with indices_are_sorted=True. Killed snapshot slots have d_gat ==
    phantom, whose moving row is zero. Reverse mode factors the receiver's
    1/d_out out of the sum (same trick as pprx/dist/sharded.py) to keep the
    scatter payload gather-free.
    """
    dtype = state.r.dtype
    alpha = jnp.asarray(cfg.alpha, dtype)
    deg = kg.window.deg
    act = _active_mask(state, kg.window, cfg)
    mass = jnp.where(act, state.r, jnp.zeros((), dtype))
    dangling = (deg == 0)[:, None]
    p2 = state.p + jnp.where(dangling, mass, alpha * mass)
    r2 = state.r - mass
    inv_deg = (1.0 / jnp.maximum(deg, 1).astype(dtype))[:, None]
    if state.mode == FORWARD:
        moving = (1.0 - alpha) * mass * inv_deg
        r2 = r2.at[kg.d_sca].add(moving[kg.d_gat], indices_are_sorted=True)
        r2 = r2.at[kg.fd_sca].add(moving[kg.fd_gat], indices_are_sorted=True)
        edge_pushes = jnp.sum(act * deg[:, None], dtype=jnp.float32)
    else:
        beta = (1.0 - alpha) / alpha
        outmass = jnp.where(dangling, beta * mass, (1.0 - alpha) * mass)
        delta = jnp.zeros_like(r2).at[kg.d_sca].add(
            outmass[kg.d_gat], indices_are_sorted=True
        )
        delta = delta.at[kg.fd_sca].add(
            outmass[kg.fd_gat], indices_are_sorted=True
        )
        r2 = r2 + delta * inv_deg
        edge_pushes = jnp.sum(act[kg.d_gat], dtype=jnp.float32) + jnp.sum(
            act[kg.fr_gat], dtype=jnp.float32
        )
    p2 = p2.at[-1].set(0.0)
    r2 = r2.at[-1].set(0.0)
    n_active = jnp.sum(act, dtype=jnp.float32)
    return state.replace(p=p2, r=r2), n_active, edge_pushes


def refresh_fresh_csr(kg: KillGraph) -> KillGraph:
    """Re-sort the fresh ring into the mini-CSR (called once per slide,
    after the ring append). f_len is maintained incrementally by the slide
    step; offsets are its cumsum; f_nbr is the ring's scatter endpoints in
    gather-sorted order (phantom padding sorts to the tail). Also rebuilds
    the delivery-sorted fresh view (fd_*) consumed by dense scan rounds."""
    _, f_nbr = jax.lax.sort_key_val(kg.fr_gat, kg.fr_sca, is_stable=True)
    f_off = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(kg.f_len, dtype=jnp.int32)]
    )
    fd_sca, fd_gat = jax.lax.sort_key_val(kg.fr_sca, kg.fr_gat, is_stable=True)
    return kg.replace(f_nbr=f_nbr, f_off=f_off, fd_sca=fd_sca, fd_gat=fd_gat)


def rld_expand(
    starts: jnp.ndarray, lens: jnp.ndarray, ecap: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Edge-balanced run-length decode: enumerate sum(lens) edge lanes,
    mapping lane j -> (owning row t, array position pos). The
    load-balanced expansion (SURVEY.md §2.1): every lane does identical
    work regardless of row-degree skew, with a scatter + cumsum instead of
    a per-lane binary search."""
    w = starts.shape[0]
    cum = jnp.cumsum(lens)
    total = cum[-1]
    cum_prev = cum - lens
    j = jax.lax.broadcasted_iota(jnp.int32, (ecap,), 0)
    boundary = jnp.zeros(ecap + 1, jnp.int32).at[
        jnp.minimum(cum_prev, ecap)
    ].add(jnp.ones_like(cum_prev, jnp.int32))
    t = (jnp.cumsum(boundary[:ecap]) - 1).astype(jnp.int32)
    t_c = jnp.clip(t, 0, w - 1)
    pos = starts[t_c] + (j - cum_prev[t_c])
    valid = j < total
    pos = jnp.where(valid, pos, 0)
    return t_c, pos, valid


def make_tiers2(
    n: int,
    cap_snap: int,
    fring: int,
    e_top: int,
    n_tiers: int = 8,
    div: int = 4,
    min_w: int = 1024,
    min_e: int = 2048,
    min_g: int = 512,
) -> tuple[tuple[int, int, int], ...]:
    """Geometric (w, e, g) capacity ladder, smallest first.

    w sizes the candidate-row buffers, e the snapshot-expansion lanes, g the
    fresh-expansion lanes. The ladder must span both regimes the stream
    workload produces: a deep BOTTOM (steady-state rounds have a few
    hundred live rows — a coarse bottom tier makes every one of them pay 4x
    buffer waste) and a high TOP (the 1-3 post-slide rounds have frontier
    edge counts near 4*slide*mean_degree — every tier they outgrow falls
    back to a window-wide dense scan round).

    ``min_*`` are CUTOFFS (not clamps): ladders stay strictly monotone and
    tiny workloads collapse to one tier, since tiering buffers that small
    saves nothing and only adds switch branches to compile."""
    e_top = min(e_top, cap_snap)
    g_top = max(min(fring, max(e_top // 4, 1)), 1)
    w_top = min(max(e_top // 2, min_w), n + 1)
    tiers = [(w_top, e_top, g_top)]
    for _ in range(n_tiers - 1):
        w2, e2, g2 = tiers[0]
        nxt = (
            min(max(w2 // div, 1), n + 1),
            max(e2 // div, 1),
            max(g2 // div, 1),
        )
        if nxt[0] < min_w or nxt[1] < min_e or nxt[2] < min_g:
            break
        tiers.insert(0, nxt)
    return tuple(tiers)


# big compact rounds deliver via sort + sorted scatter instead of an
# unsorted scatter above this many total lanes (tuned on the previous
# accelerator; not yet re-measured on the GPU)
SORT_DELIVER_MIN = 131_072


def _compact_round(
    state: PprState,
    kg: KillGraph,
    cfg: PprConfig,
    cand: jnp.ndarray,
    e_cap: int,
    g_cap: int,
    emit_w: int,
    rescan_emit: bool,
):
    """One push round over the compact candidate list ``cand`` (unique live
    rows first, phantom-padded). Caller guarantees: cand holds every active
    row, and the active rows' snapshot/fresh edge totals fit e_cap/g_cap.

    Returns (state2, cand2[emit_w], cn2, fed2, fre2, ok2, n_active,
    edge_work). ``ok2`` is False when the next frontier outgrew emit_w (the
    round itself is still exact; the caller must scan-reseed next round).
    """
    dtype = state.r.dtype
    alpha = jnp.asarray(cfg.alpha, dtype)
    n = kg.n
    deg = kg.window.deg
    w_i = cand.shape[0]

    r_c = state.r[cand]  # [w, S]
    deg_c = deg[cand]
    if state.mode == FORWARD:
        th = cfg.eps * jnp.maximum(deg_c, 1).astype(dtype)
        act_c = jnp.abs(r_c) > th[:, None]
    else:
        act_c = jnp.abs(r_c) > jnp.asarray(cfg.eps, dtype)
    any_c = jnp.any(act_c, axis=1)
    n_active = jnp.sum(act_c, dtype=jnp.float32)

    mass = jnp.where(act_c, r_c, jnp.zeros((), dtype))
    dang_c = (deg_c == 0)[:, None]
    p2 = state.p.at[cand].add(jnp.where(dang_c, mass, alpha * mass))
    if state.mode == FORWARD:
        inv_deg_c = 1.0 / jnp.maximum(deg_c, 1).astype(dtype)
        moving = (1.0 - alpha) * mass * inv_deg_c[:, None]
    else:
        beta = (1.0 - alpha) / alpha
        moving = jnp.where(dang_c, beta * mass, (1.0 - alpha) * mass)

    live_row = jnp.logical_and(any_c, cand != n)
    # snapshot expansion (killed slots have nbr == n and are masked below)
    len_s = jnp.where(live_row, kg.row_len[cand], 0)
    t1, pos1, val1 = rld_expand(kg.offsets[cand], len_s, e_cap)
    nbr1 = jnp.where(val1, kg.nbr[pos1], n)
    c1 = moving[t1] * jnp.logical_and(val1, nbr1 != n).astype(dtype)[:, None]
    # fresh expansion
    len_f = jnp.where(live_row, kg.f_len[cand], 0)
    t2, pos2, val2 = rld_expand(kg.f_off[cand], len_f, g_cap)
    nbr2 = jnp.where(val2, kg.f_nbr[pos2], n)
    c2 = moving[t2] * jnp.logical_and(val2, nbr2 != n).astype(dtype)[:, None]
    if state.mode != FORWARD:
        inv_deg = 1.0 / jnp.maximum(deg, 1).astype(dtype)
        c1 = c1 * inv_deg[nbr1][:, None]
        c2 = c2 * inv_deg[nbr2][:, None]

    # one scatter: residual removal at cand + delivery at both target lists
    tgt_d = jnp.concatenate([nbr1, nbr2])
    keys = jnp.concatenate([cand, tgt_d])
    vals = jnp.concatenate([-mass, c1, c2])
    L = keys.shape[0]
    if L >= SORT_DELIVER_MIN:
        lane = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
        keys_s, order = jax.lax.sort((keys, lane), num_keys=1, is_stable=True)
        r2 = state.r.at[keys_s].add(vals[order], indices_are_sorted=True)
    else:
        r2 = state.r.at[keys].add(vals)

    edge_work = jnp.sum(
        act_c * (kg.row_len[cand] + kg.f_len[cand])[:, None], dtype=jnp.float32
    )
    state2 = state.replace(p=p2, r=r2)

    if rescan_emit:
        # big rounds: a full activity rescan + N-compaction is cheaper than
        # winner-dedup over O(e_cap) targets (nonzero cost scales with its
        # input length)
        act2 = _active_mask(state2, kg.window, cfg)
        any2 = jnp.any(act2[:n], axis=1)
        cn2 = jnp.sum(any2, dtype=jnp.int32)
        (idx2,) = jnp.nonzero(any2, size=emit_w, fill_value=n)
        cand2 = idx2.astype(jnp.int32)
        fed2 = jnp.sum(jnp.where(any2, kg.row_len[:n], 0), dtype=jnp.int32)
        fre2 = jnp.sum(jnp.where(any2, kg.f_len[:n], 0), dtype=jnp.int32)
        ok2 = cn2 <= emit_w
    else:
        # winner-dedup: the lane that reads back its own id owns the row
        lane = jax.lax.broadcasted_iota(jnp.int32, tgt_d.shape, 0)
        scratch = jnp.zeros(n + 1, jnp.int32).at[tgt_d].set(lane)
        win = jnp.logical_and(scratch[tgt_d] == lane, tgt_d != n)
        cn2 = jnp.sum(win, dtype=jnp.int32)
        (cpos,) = jnp.nonzero(win, size=emit_w, fill_value=0)
        in_r = jax.lax.broadcasted_iota(jnp.int32, (emit_w,), 0) < cn2
        cand2 = jnp.where(in_r, tgt_d[cpos], n).astype(jnp.int32)
        fed2 = jnp.sum(jnp.where(win, kg.row_len[tgt_d], 0), dtype=jnp.int32)
        fre2 = jnp.sum(jnp.where(win, kg.f_len[tgt_d], 0), dtype=jnp.int32)
        ok2 = cn2 <= emit_w
    return state2, cand2, cn2, fed2, fre2, ok2, n_active, edge_work


def push_to_convergence_wl2(
    state: PprState,
    kg: KillGraph,
    cfg: PprConfig,
    cand0: jnp.ndarray,
    c0n,
    c0ok,
    tiers: tuple[tuple[int, int, int], ...],
) -> tuple[PprState, PushStats]:
    """On-device convergence loop; each iteration runs at the smallest
    capacity tier whose EXACT frontier counts fit, or one dense COO round +
    exact reseed when nothing fits. ``cand0`` seeds the candidate list at
    its own (static) capacity; pass ``c0ok=False`` to start with a scan.
    """
    n = kg.n
    tiers = tuple(tiers)
    # the carry holds any frontier (n rows max) plus the top tier's needs;
    # make_tiers2 caps w_top at n+1, so this is simply n+1
    wcarry = max(tiers[-1][0], n + 1)
    # reseed emission must be able to hold any frontier the scan can find
    scan_w = n + 1
    row_len = kg.row_len
    f_len = kg.f_len

    cap0 = cand0.shape[0]
    live0 = jnp.logical_and(
        cand0 != n,
        jax.lax.broadcasted_iota(jnp.int32, (cap0,), 0) < jnp.asarray(c0n),
    )
    cn0 = jnp.sum(live0, dtype=jnp.int32)
    fed0 = jnp.sum(jnp.where(live0, row_len[cand0], 0), dtype=jnp.int32)
    fre0 = jnp.sum(jnp.where(live0, f_len[cand0], 0), dtype=jnp.int32)
    if cap0 < wcarry:
        cand0 = jnp.concatenate([cand0, jnp.full(wcarry - cap0, n, jnp.int32)])
    else:
        cand0 = cand0[:wcarry]

    def body(c):
        st, cand, cn, fed, fre, ok, _, stats = c
        fits_top = jnp.logical_and(
            jnp.logical_and(cn <= tiers[-1][0], fed <= tiers[-1][1]),
            fre <= tiers[-1][2],
        )
        use_wl = jnp.logical_and(ok, fits_top)

        def pad(c2, emit_w):
            if emit_w < wcarry:
                return jnp.concatenate([c2, jnp.full(wcarry - emit_w, n, jnp.int32)])
            return c2[:wcarry]

        def tier_branch(i):
            w_i, e_i, g_i = tiers[i]
            emit_i = min(i + 1, len(tiers) - 1)
            emit_w = tiers[emit_i][0]
            # big tiers reseed by rescan (cheaper than slot-dedup at that
            # size) — which also tightens the next round's counts to the
            # true frontier
            rescan = (tiers[i][1] + tiers[i][2]) > max(n // 2, 4096)
            emit_w2 = scan_w if rescan else emit_w

            def br(st):
                st2, c2, cn2, fed2, fre2, ok2, na, ew = _compact_round(
                    st, kg, cfg, cand[:w_i], e_i, g_i, emit_w2, rescan,
                )
                return st2, pad(c2, emit_w2), cn2, fed2, fre2, ok2, na, ew

            return br

        def wl(st):
            if len(tiers) == 1:
                return tier_branch(0)(st)
            misses = [
                jnp.logical_not(
                    jnp.logical_and(
                        jnp.logical_and(cn <= w_i, fed <= e_i), fre <= g_i
                    )
                ).astype(jnp.int32)
                for (w_i, e_i, g_i) in tiers[:-1]
            ]
            return jax.lax.switch(
                sum(misses), [tier_branch(i) for i in range(len(tiers))], st
            )

        def scan(st):
            st2, na, ew = dense_round_sorted(st, kg, cfg)

            # Post-delivery rescan skip (mirrors the sharded engine):
            # while this round's frontier edge mass sits far above the
            # ladder top, the successor round is another scan with
            # near-certainty (the frontier decays ~1.45x/round), so the
            # O(N*S) activity mask + the N-input nonzero are wasted
            # work. A misprediction costs
            # one extra scan round; correctness is untouched (the loop's
            # work predicate is na, and forced scans still converge).
            heavy = ew > jnp.asarray(
                float(STATS_GUARD * (tiers[-1][1] + tiers[-1][2])),
                jnp.float32,
            )

            def full_stats(_):
                act2 = _active_mask(st2, kg.window, cfg)
                any2 = jnp.any(act2[:n], axis=1)
                cn2 = jnp.sum(any2, dtype=jnp.int32)
                (idx2,) = jnp.nonzero(any2, size=scan_w, fill_value=n)
                fed2 = jnp.sum(
                    jnp.where(any2, row_len[:n], 0), dtype=jnp.int32
                )
                fre2 = jnp.sum(jnp.where(any2, f_len[:n], 0), dtype=jnp.int32)
                return idx2.astype(jnp.int32), cn2, fed2, fre2, cn2 <= scan_w

            def skip_stats(_):
                big = jnp.asarray(jnp.iinfo(jnp.int32).max // 2, jnp.int32)
                return (
                    jnp.full(scan_w, n, jnp.int32), big, big, big,
                    jnp.asarray(False),
                )

            idx2, cn2, fed2, fre2, ok2 = jax.lax.cond(
                heavy, skip_stats, full_stats, None
            )
            return st2, pad(idx2, scan_w), cn2, fed2, fre2, ok2, na, ew

        st2, cand2, cn2, fed2, fre2, ok2, na, ew = jax.lax.cond(use_wl, wl, scan, st)
        not_wl = jnp.logical_not(use_wl).astype(jnp.int32)
        stats2 = PushStats(
            rounds=stats.rounds + 1,
            pushes=stats.pushes + na,
            edge_pushes=stats.edge_pushes + ew,
            wl_rounds=stats.wl_rounds + use_wl.astype(jnp.int32),
            scans_cand=stats.scans_cand
            + not_wl * jnp.logical_not(ok).astype(jnp.int32),
            scans_fed=stats.scans_fed
            + not_wl * (fed > tiers[-1][1]).astype(jnp.int32),
            scans_liv=stats.scans_liv
            + not_wl * (fre > tiers[-1][2]).astype(jnp.int32),
        )
        return st2, cand2, cn2, fed2, fre2, ok2, na, stats2

    def cond(c):
        *_, na, stats = c
        return jnp.logical_and(na > 0, stats.rounds < cfg.max_rounds)

    # prime: zero candidates with a valid list means zero active rows
    # (candidates are a frontier superset); otherwise force one scan round
    na0 = jnp.where(
        jnp.asarray(c0ok), (cn0 > 0).astype(jnp.float32), jnp.asarray(1.0, jnp.float32)
    )
    state, *_, stats = jax.lax.while_loop(
        cond,
        body,
        (state, cand0, cn0, fed0, fre0, jnp.asarray(c0ok), na0, PushStats.zero()),
    )
    return state, stats
