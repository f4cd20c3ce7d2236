"""Sharded compact-frontier push engine (SURVEY.md §3.5): the worklist
engine ported into the sharded path.

The dense sharded engine (pprx.dist.sharded) pays O(ecap*S) expansion and an
O(N_pad*S) reduce-scatter EVERY round. This engine runs the wl2
compact-frontier machinery (pprx.engine.wl2) PER SHARD inside shard_map:

- each shard keeps a kill-in-place CSR snapshot of its owned window edges
  (gather endpoint local, scatter endpoint GLOBAL; expired slots point at
  the global phantom n_pad) plus a per-slide-re-sorted fresh mini-CSR;
- a round gathers/pushes only the shard's compact candidate rows
  (candidate lists are unique ASCENDING by contract — the per-round p/r
  scatters run with indices_are_sorted), expands them with the
  edge-balanced run-length decode, dedups the delivery targets, and ships
  per-destination-shard buckets of (local id, mass[S]) over ONE
  ``lax.all_to_all`` along 'rows' — O(frontier) traffic, not O(N_pad*S);
  per-TIER quotas size each tier's exchange to its own worst-case deduped
  emission, so compact rounds do not overflow under balanced ownership;
- bucket overflow goes to a local [N_pad, S] carry outbox ([1, S] at K=1,
  where quotas provably cover every emission); any pending carry forces
  the next round onto the DENSE path (full local expansion + carry flush +
  psum_scatter + exact activity rescan) — mass is never dropped.
  ``proportional=True`` replaces both with a compact sorted carry drained
  by dedicated a2a rounds (push-path memory is O(n_local*S + frontier);
  the REVERSE-mode slide corrections still build an [n_pad, 2S] rowsum
  stack for their reduce-scatter — see the class docstring);
- big emissions (and, in the proportional engine, every round) dedup and
  bucket by SORT: one stable multi-operand sort, a sorted segment scatter,
  K+1 scalar binary searches, and GATHER-constructed send buffers
  (``sorted_bucket``); big deliveries sort on the receive side too;
- dense-flush rounds and the reverse slide's rowsum sweep use LOCAL-FIRST
  delivery views: locally-owned contributions run straight into r and only
  remote mass rides the reduce-scatter (statically absent at K=1) — the
  distributed-SpMV diagonal-block optimization;
- the tier / dense decision is made UNIFORM along 'rows' by pmax-ing the
  per-shard frontier counts (devices that share an all_to_all group must
  take the same branch); 'srcs' groups decide independently (their
  exchanges are disjoint).

Exactness argument (same induction as wl2): after a compact round the next
active rows are a subset of the delivery targets (pushed rows hit exact
zero; undelivered rows keep their sub-threshold residuals; carry-deferred
deliveries force a dense round whose rescan re-seeds exactly). Parity with
the single-device engine is tested in tests/test_dist_wl.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from pprx.config import PprConfig
from pprx.dist.sharded import (
    ShardedEngine,
    forward_corrections,
    forward_corrections_pairs,
    reverse_apply,
)
from pprx.engine.state import FORWARD
from pprx.engine.wl2 import STATS_GUARD, rld_expand


def make_wl_tiers(
    n_local: int,
    ecap: int,
    fring: int,
    e_top: int,
    w_top: int,
    n_tiers: int = 4,
    div: int = 4,
    min_w: int = 512,
    min_e: int = 1024,
    min_g: int = 256,
) -> tuple[tuple[int, int, int], ...]:
    """Per-shard geometric (w, e, g) capacity ladder, smallest first (the
    sharded sibling of pprx.engine.wl2.make_tiers2; ``min_*`` are cutoffs,
    not clamps, for the same reason as there)."""
    e_top = max(min(e_top, ecap), 1)
    g_top = max(min(fring, max(e_top // 4, 1)), 1)
    w_top = min(max(w_top, min_w), n_local + 1)
    tiers = [(w_top, e_top, g_top)]
    for _ in range(n_tiers - 1):
        w2, e2, g2 = tiers[0]
        nxt = (
            min(max(w2 // div, 1), n_local + 1),
            max(e2 // div, 1),
            max(g2 // div, 1),
        )
        if nxt[0] < min_w or nxt[1] < min_e or nxt[2] < min_g:
            break
        tiers.insert(0, nxt)
    return tuple(tiers)


# non-prop compact rounds switch to sort-based dedup+bucketing above this
# many emission lanes (the winner-dedup cbuf scatter is unsorted)
SORT_BUCKET_MIN = 65_536

# the per-shard snapshot dict's keys — also the checkpoint field list
# (pprx/io/checkpoint.py imports this; keep it the single source of truth).
# The delivery views hold LOCAL-destination edges first (sorted by dst),
# then remote-destination edges (sorted by dst). Local deliveries run
# straight into r — no reduce-scatter — and the remote acc/psum_scatter
# path is statically absent at K=1.
WL_SNAP_KEYS = (
    "soff", "snbr", "srl", "spos",
    "d_gat", "d_sca", "d_pos",
    "fd_gat", "fd_sca",
    "fr_gat", "fr_sca", "f_off", "f_nbr", "f_len", "fcnt",
)

# the forward slide's device-resident slot bookkeeping (round 4): a FIFO
# occupancy ring (slot ids in insertion order; the window is FIFO so each
# shard's expiring edges are exactly its oldest entries) + a LIFO free-slot
# stack. Lets the packed slide ship only the fresh edges + two counts —
# the clear/write slot schedules were HALF its H2D bytes. Reconstructible
# from the host's pos_owner/pos_slot/free-stack bookkeeping (checkpoints
# need no new fields; pprx/dist/stream.py builds it at init/load).
WL_RING_KEYS = ("oring", "hd", "tl", "fstack", "ftop")


def sorted_bucket(ids, vals, K, n_local, n_pad, ccap, ccarry, dtype):
    """Dedup-by-sort + owner-bucket of (global id, mass) pairs — the
    memory-proportional replacement for winner-dedup (which needs an
    O(n_pad) scratch) and the O(K*L) per-owner rank loop.

    ids: [L] global target ids, invalid = n_pad. vals: [L, S].
    One stable sort groups duplicates; a segment-scatter sums each group's
    mass; owners are contiguous in the sorted order, so per-owner ranks come
    from K+1 scalar binary searches instead of K full-length cumsums. The
    [K, ccap] send layout is then a pure GATHER from the sorted unique
    arrays (slot (k, j) reads sorted position starts[k] + j) — the earlier
    form scattered all L lanes into the send buffers, an unsorted
    scatter that dominated big compact rounds (round-4 phase timing).

    Returns (send_ids [K*ccap] LOCAL ids pad n_local, send_mass [K*ccap, S],
    carry_ids [ccarry] sorted global ids pad n_pad, carry_mass [ccarry, S],
    pend). Entries past each owner's ccap quota land in the carry (the
    caller drains it with dedicated rounds); the carry gather only runs when
    overflow exists (lax.cond). CONTRACT: the number of unique ids beyond
    quota must fit ccarry — entries are deduped, so ccarry >= min(L, n_pad)
    guarantees it — and since every quantity is static, the contract is
    ENFORCED at trace time below (a violated contract would otherwise drop
    mass).
    """
    # delegate: with rows = iota, moving[rows_s] is exactly vals[order]
    iota = jax.lax.broadcasted_iota(jnp.int32, (ids.shape[0],), 0)
    return sorted_bucket_rows(
        ids, iota, vals, K, n_local, n_pad, ccap, ccarry, dtype
    )


def sorted_bucket_rows(ids, rows, moving, K, n_local, n_pad, ccap, ccarry,
                       dtype):
    """sorted_bucket without the pre-sort mass materialization (round 4):
    a push round's per-edge mass is moving[row] — a row of the compact
    frontier's [w_i, S] moving array — so the sort carries the int ROW
    INDEX instead of an [L, S] payload, and the group sum gathers moving
    rows ONCE into the sorted segment scatter. Saves two full [L, S] HBM
    passes per big round (the c1/c2 materialization and the vals[order]
    re-gather). Invalid lanes (ids == n_pad) sort into the trailing group,
    whose mass is never read — no masking needed."""
    L = ids.shape[0]
    s = moving.shape[1]
    assert ccarry >= min(L, n_pad), (
        f"sorted_bucket_rows carry contract violated: ccarry={ccarry} < "
        f"min(L={L}, n_pad={n_pad})"
    )
    ids_s, rows_s = jax.lax.sort((ids, rows), num_keys=1, is_stable=True)
    prev = jnp.concatenate([jnp.full(1, -1, ids_s.dtype), ids_s[:-1]])
    seg_start = ids_s != prev
    sidx = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
    # duplicate writes carry identical values (one group = one id), so a
    # plain set is deterministic; groups past the last real one keep n_pad
    gids = jnp.full(L, n_pad, jnp.int32).at[sidx].set(
        ids_s.astype(jnp.int32), indices_are_sorted=True
    )
    gmass = jnp.zeros((L, s), dtype).at[sidx].add(
        moving[rows_s], indices_are_sorted=True
    )
    return _bucket_tail(gids, gmass, K, n_local, n_pad, ccap, ccarry, dtype)


def _bucket_tail(gids, gmass, K, n_local, n_pad, ccap, ccarry, dtype):
    L = gids.shape[0]
    s = gmass.shape[1]
    starts = jnp.searchsorted(
        gids, (jnp.arange(K + 1, dtype=jnp.int32) * n_local)
    ).astype(jnp.int32)
    counts = starts[1:] - starts[:-1]  # unique ids per owner
    # send buffers by gather: slot (k, j) <- sorted position starts[k] + j
    j_ix = jax.lax.broadcasted_iota(jnp.int32, (K, ccap), 1)
    valid = j_ix < jnp.minimum(counts, ccap)[:, None]
    g_idx = jnp.where(valid, starts[:K, None] + j_ix, 0).reshape(-1)
    valid = valid.reshape(-1)
    k_of = jax.lax.broadcasted_iota(jnp.int32, (K, ccap), 0).reshape(-1)
    send_ids = jnp.where(
        valid, gids[g_idx] - k_of * n_local, n_local
    ).astype(jnp.int32)
    send_mass = gmass[g_idx] * valid[:, None].astype(dtype)
    # overflow -> compact carry, also by gather; skipped when empty
    oc = jnp.maximum(counts - ccap, 0)
    base = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(oc, dtype=jnp.int32)]
    )
    pend = base[K]

    def carry_gather(_):
        ci = jax.lax.broadcasted_iota(jnp.int32, (ccarry,), 0)
        # owner of carry slot i: the last k with base[k] <= i
        o = (
            jnp.searchsorted(base, ci, side="right").astype(jnp.int32) - 1
        )
        oc_ = jnp.clip(o, 0, K - 1)
        c_idx = starts[oc_] + ccap + (ci - base[oc_])
        ok = ci < pend
        c_idx = jnp.where(ok, c_idx, 0)
        carry_ids = jnp.where(ok, gids[c_idx], n_pad).astype(jnp.int32)
        carry_mass = gmass[c_idx] * ok[:, None].astype(dtype)
        return carry_ids, carry_mass

    def carry_empty(_):
        return (
            jnp.full(ccarry, n_pad, jnp.int32),
            jnp.zeros((ccarry, s), dtype),
        )

    carry_ids, carry_mass = jax.lax.cond(
        pend > 0, carry_gather, carry_empty, 0
    )
    return send_ids, send_mass, carry_ids, carry_mass, pend


class ShardedWlEngine(ShardedEngine):
    """Row-sharded engine whose push loop runs compact-frontier rounds with
    bucketed all-to-all exchange (forward AND reverse modes; reverse applies
    the receiver-side 1/d_out factor exactly like the dense engine)."""

    def __init__(
        self,
        mesh: jax.sharding.Mesh,
        n: int,
        s_total: int,
        ecap: int,
        bcap: int,
        cfg: PprConfig,
        mode: int = FORWARD,
        dtype=jnp.float32,
        ccap: int | None = None,
        fring: int | None = None,
        e_top: int | None = None,
        n_tiers: int = 4,
        proportional: bool = False,
    ):
        """proportional=True builds the memory-proportional round loop: no
        [n_pad, S] arrays anywhere — the carry outbox becomes a compact
        sorted (id, mass) buffer drained by dedicated a2a rounds, the
        dense-flush fallback becomes an
        all-covering top tier, and forward-mode correction deliveries ride
        the same bucketed exchange. Per-device live memory is
        O(n_local*S + frontier_edges*S). (Reverse-mode slide corrections
        still use the parent's stacked rowsum reduce-scatter.)"""
        # per-destination a2a quotas are PER-TIER since round 4 (see below);
        # an explicit ccap caps every tier's quota (tests use tiny values to
        # force the carry/overflow paths)
        user_ccap = ccap
        # the dense machinery (corrections, fallback rounds, init_state,
        # device_graph) comes from the parent; exchange='dense_rs' there is
        # only the parent's own push path, which slide_wl never calls
        super().__init__(
            mesh, n, s_total, ecap, bcap, cfg, mode=mode, dtype=dtype,
            exchange="dense_rs", ccap=2048 if ccap is None else ccap,
        )
        # fring=2b: the per-slide fresh-ring sorts (mutate_graph) and the
        # dense rounds' fresh-view gathers scale with fring, so a short ring
        # trades more frequent rebuilds for less per-slide ring work (2b was
        # the best of {2b, 4b, 8b} on the previous accelerator)
        self.fring = max(bcap, fring if fring is not None else 2 * bcap)
        # snapshot arrays have ecap usable positions + 1 trash position
        self.sstride = self.slot_stride  # ecap + 1
        # e_top=64k: a big compact round re-sorts and re-gathers [L, S]
        # mass arrays several times in the exchange machinery, while the
        # local-direct dense flush streams the whole window once, so
        # frontiers beyond ~64k edges go to the dense scan (tuned on the
        # previous accelerator; the single-chip engine's delivery has no
        # exchange buffers, so its crossover sits higher).
        et = e_top if e_top is not None else min(65_536, ecap)
        self.e_top = et
        self.n_tiers = n_tiers
        self.proportional = proportional
        # checkpoint round-trips the USER's quota cap, not the derived
        # per-tier quotas (None = auto; pprx/io/checkpoint.py)
        self.user_ccap = user_ccap
        # row capacity mirrors the single-chip ladder (w_top ~ e_top/2); tying
        # w_top to K*ccap instead starved mid-size frontiers into dense-flush
        # rounds at mesh 1x1
        self.tiers = make_wl_tiers(
            self.n_local, ecap, self.fring, et,
            w_top=max(et // 2, 512), n_tiers=n_tiers,
        )
        if proportional:
            # all-covering top tier: any frontier fits (srl sums <= ecap,
            # f_len sums <= fring), so no dense-flush branch is needed
            top = (self.n_local + 1, ecap, self.fring)
            below = tuple(
                t for t in self.tiers
                if t[0] < top[0] or t[1] < top[1] or t[2] < top[2]
            )
            self.tiers = below + (top,)
            # carry must hold one round's worst-case emission (see
            # sorted_bucket contract) — but emissions are DEDUPED unique
            # global ids, so n_pad also bounds it (the uncapped form made
            # ccarry ~W at small K and blew HBM at single-chip scale)
            self.ccarry = min(
                max(e + g for (_, e, g) in self.tiers), self.n_pad
            )
        # PER-TIER a2a quotas: tier i's exchange ships ceil((e_i + g_i)/K)
        # rows per destination — the deduped emission of the tier always
        # fits under balanced ownership, so compact rounds do not overflow
        # into the carry (each overflow forces a dense-flush round). Skew
        # beyond the quota still lands in the carry — the overflow
        # semantics are unchanged.
        quotas = []
        for (w_i, e_i, g_i) in self.tiers:
            q = max(1024, -(-(e_i + g_i) // self.n_rows))
            if user_ccap is not None:
                q = min(q, user_ccap)
            quotas.append(min(q, self.n_local))
        # Round-4 verdict weak item 1 (explicit ccap clamping a K=1 quota
        # below the deduped-emission bound would overflow into the dummy
        # carry and silently lose mass) is closed STRUCTURALLY: K=1 compact
        # rounds take the quota-free direct-delivery path (no wire, no
        # send buffers, no overflow — see compact_round), so user_ccap is
        # a wire-buffer quota only and the carry is never fed at K=1.
        self.ccaps = tuple(quotas)
        self.wl_ccap = self.ccaps[-1]
        # the candidate carry holds UNIQUE local row ids, so n_local + 1
        # bounds every source of candidates (a2a deliveries, host-seeded
        # batches, dense rescans); the round-3 max(..., 4*bcap) = 640k form
        # paid 3x in every rescan's nonzero
        self.wcarry = self.n_local + 1
        self._build_wl_programs()

    # ------------------------------------------------------------------
    # graph construction (host): per-shard snapshot CSR + fresh ring
    # ------------------------------------------------------------------
    def device_graph_wl(self, src, dst):
        """Like device_graph, plus the per-shard snapshot CSR. Returns
        (deg, egl, eog, eva, counts, snap) where snap is the dict of
        P('rows')-sharded snapshot/fresh arrays fed to push_wl/slide_wl."""
        deg, egl, eog, eva, counts = self.device_graph(src, dst)
        snap = self._rebuild(egl, eog, eva)
        return deg, egl, eog, eva, counts, snap

    def rebuild(self, egl, eog, eva):
        """Re-sort the window slot buffers into a fresh snapshot (device,
        per shard), resetting the fresh ring. Call every `rebuild_every`
        slides (driver-managed, like FastStreamDriver)."""
        return self._rebuild(egl, eog, eva)

    # ------------------------------------------------------------------
    def _build_wl_programs(self):
        mesh = self.mesh
        dtype = self.dtype
        cfg = self.cfg
        mode = self.mode
        n = self.n
        K = self.n_rows
        n_local = self.n_local
        n_pad = self.n_pad
        sstride = self.sstride
        fring = self.fring
        ccap = self.wl_ccap  # top-tier quota (corrections / carry drains)
        ccaps = self.ccaps  # per-tier a2a quotas
        tiers = self.tiers
        wcarry = self.wcarry
        alpha_f = cfg.alpha
        spec_state, spec_row, rep = self.state_spec, self.row_spec, P()
        smap = functools.partial(shard_map, mesh=mesh, check_vma=False)

        # ---------------- rebuild: slot buffers -> snapshot ----------------
        RS = fring + 1  # fresh ring + trash slot (padding writes land there)
        _snap_spec_names = WL_SNAP_KEYS

        def _delivery_views(dst, gat, live, length, base, need_pos=True):
            """Sort one edge set into the delivery layout: LOCAL
            destinations first (by dst), then remote (by dst), dead last.
            Returns (sca, gatv, pos). need_pos=False skips the
            slot->position argsort (a full extra sort of `length` lanes)
            for callers that discard pos — the per-slide fresh view
            rebuilds from scratch each slide and never kills by position."""
            iota_e = jax.lax.broadcasted_iota(jnp.int32, (length,), 0)
            is_loc = jnp.logical_and(dst >= base, dst < base + n_local)
            key = jnp.where(
                live,
                jnp.where(is_loc, dst - base, dst + n_pad),
                2 * n_pad,
            )
            _, order, gat_s, sca_s = jax.lax.sort(
                (key, iota_e, jnp.where(live, gat, n_local).astype(jnp.int32),
                 dst.astype(jnp.int32)),
                num_keys=1, is_stable=True,
            )
            if need_pos:
                pos = jnp.argsort(order, stable=True).astype(jnp.int32)
            else:
                pos = jnp.zeros(0, jnp.int32)
            return sca_s, gat_s, pos

        @jax.jit
        @functools.partial(
            smap,
            in_specs=(spec_row,) * 3,
            out_specs={k: spec_row for k in _snap_spec_names},
        )
        def rebuild_fn(egl, eog, eva):
            # dead slots sort to the tail (key n_local) and become trash
            key = jnp.where(eva > 0, egl, n_local)
            iota_ss = jax.lax.broadcasted_iota(jnp.int32, (sstride,), 0)
            _, order, snbr = jax.lax.sort(
                (key, iota_ss, jnp.where(eva > 0, eog, n_pad).astype(jnp.int32)),
                num_keys=1, is_stable=True,
            )
            spos = jnp.argsort(order, stable=True).astype(jnp.int32)
            counts = jnp.zeros(n_local, jnp.int32).at[egl].add(eva)
            soff = jnp.concatenate(
                [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
            )
            # delivery view, local-first layout (see WL_SNAP_KEYS note).
            # Kills only ever touch d_gat (-> the zero trash row), so d_sca
            # stays sorted between rebuilds — same design as the
            # single-chip KillGraph.
            base = jax.lax.axis_index("rows").astype(jnp.int32) * n_local
            dst = jnp.where(eva > 0, eog, n_pad).astype(jnp.int32)
            d_sca, d_gat, d_pos = _delivery_views(
                dst, egl, eva > 0, sstride, base
            )
            return {
                "soff": soff,
                "snbr": snbr,
                "srl": counts,
                "spos": spos,
                "d_gat": d_gat,
                "d_sca": d_sca,
                "d_pos": d_pos,
                "fd_gat": jnp.full(RS, n_local, jnp.int32),
                "fd_sca": jnp.full(RS, n_pad, jnp.int32),
                "fr_gat": jnp.full(RS, n_local, jnp.int32),
                "fr_sca": jnp.full(RS, n_pad, jnp.int32),
                "f_off": jnp.zeros(n_local + 1, jnp.int32),
                "f_nbr": jnp.full(RS, n_pad, jnp.int32),
                "f_len": jnp.zeros(n_local, jnp.int32),
                "fcnt": jnp.zeros(1, jnp.int32),
            }

        self._rebuild = rebuild_fn

        # ---------------- the push loop (block-local) ----------------
        def active_of(r_, deg_):
            if mode == FORWARD:
                th = cfg.eps * jnp.maximum(deg_, 1).astype(dtype)
                return jnp.abs(r_) > th[:, None]
            return jnp.abs(r_) > jnp.asarray(cfg.eps, dtype)

        def wl_push_loop(p, r, deg, snap, cand0, ok0):
            """Per-shard body. cand0: [wcarry] UNIQUE local row ids (pad
            n_local); caller guarantees cand0 covers every locally-active
            row when ok0 is 1 (else the first round is a dense rescan)."""
            alpha = jnp.asarray(alpha_f, dtype)
            beta = (1.0 - alpha) / alpha
            s_loc = p.shape[1]
            inv_deg = (1.0 / jnp.maximum(deg, 1).astype(dtype))[:, None]
            dangling = (deg == 0)[:, None]
            soff, snbr, srl = snap["soff"], snap["snbr"], snap["srl"]
            f_off, f_nbr, f_len = snap["f_off"], snap["f_nbr"], snap["f_len"]
            d_gat, d_sca = snap["d_gat"], snap["d_sca"]
            fd_gat, fd_sca = snap["fd_gat"], snap["fd_sca"]

            def counts_of(rows, live):
                fed = jnp.sum(jnp.where(live, srl[jnp.clip(rows, 0, n_local - 1)], 0),
                              dtype=jnp.int32)
                fre = jnp.sum(jnp.where(live, f_len[jnp.clip(rows, 0, n_local - 1)], 0),
                              dtype=jnp.int32)
                return fed, fre

            def compact_round(i, c):
                w_i, e_i, g_i = tiers[i]
                ccap = ccaps[i]
                (p, r, cand, cn, fed, fre, okf, carry, pend, stats) = c
                candw = cand[:w_i]
                cc = jnp.clip(candw, 0, n_local - 1)
                live = candw < n_local
                r_c = jnp.where(live[:, None], r[cc], jnp.zeros((), dtype))
                deg_c = deg[cc]
                if mode == FORWARD:
                    th = cfg.eps * jnp.maximum(deg_c, 1).astype(dtype)
                    act = jnp.abs(r_c) > th[:, None]
                else:
                    act = jnp.abs(r_c) > jnp.asarray(cfg.eps, dtype)
                act = jnp.logical_and(act, live[:, None])
                mass = jnp.where(act, r_c, jnp.zeros((), dtype))
                dang_c = (deg_c == 0)[:, None]
                # candidate lists are ASCENDING by construction (sorted
                # recv dedup below, nonzero rescans, np.unique host seeds),
                # so the per-round p/r scatters run sorted (the unsorted
                # form dominated big compact rounds)
                p = p.at[cc].add(
                    jnp.where(dang_c, mass, alpha * mass),
                    indices_are_sorted=True,
                )
                r = r.at[cc].add(-mass, indices_are_sorted=True)
                if mode == FORWARD:
                    inv_c = 1.0 / jnp.maximum(deg_c, 1).astype(dtype)
                    moving = (1.0 - alpha) * mass * inv_c[:, None]
                else:
                    moving = jnp.where(dang_c, beta * mass, (1.0 - alpha) * mass)
                anyact = jnp.any(act, axis=1)
                # snapshot + fresh expansion (targets are GLOBAL ids)
                len1 = jnp.where(anyact, srl[cc], 0)
                t1, pos1, val1 = rld_expand(soff[cc], len1, e_i)
                g1 = jnp.where(val1, snbr[jnp.clip(pos1, 0, sstride - 1)], n_pad)
                len2 = jnp.where(anyact, f_len[cc], 0)
                t2, pos2, val2 = rld_expand(f_off[cc], len2, g_i)
                g2 = jnp.where(val2, f_nbr[jnp.clip(pos2, 0, fring)], n_pad)
                ids = jnp.concatenate([g1, g2])  # [L], invalid = n_pad
                L = e_i + g_i
                if K == 1:
                    # mesh 1x1: the all_to_all is an identity, so the whole
                    # exchange apparatus (quota'd send-buffer build, two
                    # a2a copies, receive-side re-sort) is pure overhead —
                    # and quotas themselves are moot with no wire. One
                    # stable sort dedups the emission; the sorted unique
                    # (id, mass) list IS the delivery AND the next round's
                    # ascending candidate list. Quota-free: the carry is
                    # statically never fed at K=1 (round-5; this also
                    # closes the round-4 "explicit ccap at K=1" mass-loss
                    # trap structurally — user_ccap only sizes wire
                    # buffers, and K=1 has no wire).
                    rowsc = jnp.concatenate([t1, t2])
                    ids_s, rows_s = jax.lax.sort(
                        (ids, rowsc), num_keys=1, is_stable=True
                    )
                    prevs = jnp.concatenate(
                        [jnp.full(1, -1, ids_s.dtype), ids_s[:-1]]
                    )
                    segs = ids_s != prevs
                    sidx = jnp.cumsum(segs.astype(jnp.int32)) - 1
                    # n_pad == n_local at K=1, so the pad value doubles as
                    # the candidate-list pad and the ascending-unique gids
                    # satisfy the cand contract directly
                    gids = jnp.full(L, n_pad, jnp.int32).at[sidx].set(
                        ids_s.astype(jnp.int32), indices_are_sorted=True
                    )
                    gmass = jnp.zeros((L, s_loc), dtype).at[sidx].add(
                        moving[rows_s], indices_are_sorted=True
                    )
                    validg = gids < n_local
                    gl = jnp.clip(gids, 0, n_local - 1)
                    gm = gmass * validg[:, None].astype(dtype)
                    if mode == FORWARD:
                        r = r.at[gl].add(gm, indices_are_sorted=True)
                    else:
                        r = r.at[gl].add(
                            gm * inv_deg[gl], indices_are_sorted=True
                        )
                    cn2 = jnp.sum(validg, dtype=jnp.int32)
                    fed2 = jnp.sum(
                        jnp.where(validg, srl[gl], 0), dtype=jnp.int32
                    )
                    fre2 = jnp.sum(
                        jnp.where(validg, f_len[gl], 0), dtype=jnp.int32
                    )
                    if L >= wcarry:
                        cand2 = gids[:wcarry]
                    else:
                        cand2 = jnp.concatenate(
                            [gids, jnp.full(wcarry - L, n_local, jnp.int32)]
                        )
                    ok2 = (cn2 <= wcarry).astype(jnp.int32)
                    na = jnp.sum(act, dtype=jnp.float32)
                    ew = jnp.sum(
                        act * (srl[cc] + f_len[cc])[:, None],
                        dtype=jnp.float32,
                    )
                    stats2 = (
                        stats[0] + 1, stats[1] + na, stats[2] + ew,
                        stats[3] + 1,
                    )
                    return (p, r, cand2, cn2, fed2, fre2, ok2, carry, pend,
                            stats2), na
                if L >= SORT_BUCKET_MIN:
                    # big rounds: sort-based dedup+bucketing instead of
                    # the winner-dedup's L-sized UNSORTED cbuf scatter. The
                    # sort carries the moving-row index, not an [L, S]
                    # payload — the per-lane mass is never materialized
                    # pre-sort (sorted_bucket_rows)
                    send_ids, send_mass, cids, cmass, pend2 = (
                        sorted_bucket_rows(
                            ids, jnp.concatenate([t1, t2]), moving, K,
                            n_local, n_pad, ccap, min(L, n_pad), dtype,
                        )
                    )
                    carry = carry.at[
                        jnp.clip(cids, 0, carry.shape[0] - 1)
                    ].add(cmass * (cids < n_pad).astype(dtype)[:, None])
                    pend = pend + pend2
                else:
                    c1 = moving[t1] * (g1 < n_pad).astype(dtype)[:, None]
                    c2 = moving[t2] * (g2 < n_pad).astype(dtype)[:, None]
                    vals = jnp.concatenate([c1, c2])
                    lane = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
                    # winner-dedup over GLOBAL target ids
                    scratch = jnp.zeros(n_pad + 1, jnp.int32).at[ids].set(lane)
                    win = jnp.logical_and(scratch[ids] == lane, ids < n_pad)
                    ucnt = jnp.sum(win, dtype=jnp.int32)
                    (cpos,) = jnp.nonzero(win, size=L, fill_value=0)
                    inr = jax.lax.broadcasted_iota(jnp.int32, (L,), 0) < ucnt
                    uids = jnp.where(inr, ids[cpos], n_pad)
                    # compact per-target mass: every lane adds into its
                    # winner row
                    cidx = jnp.zeros(n_pad + 1, jnp.int32).at[uids].set(lane)
                    cbuf = jnp.zeros((L, s_loc), dtype).at[cidx[ids]].add(vals)
                    # bucket unique targets by owner shard
                    owner = jnp.where(inr, uids // n_local, K)
                    rank = jnp.zeros(L, jnp.int32)
                    for k in range(K):
                        mk = owner == k
                        rank = jnp.where(
                            mk, jnp.cumsum(mk.astype(jnp.int32)) - 1, rank
                        )
                    sendable = jnp.logical_and(owner < K, rank < ccap)
                    flat = jnp.where(sendable, owner * ccap + rank, K * ccap)
                    send_ids = jnp.full(
                        K * ccap + 1, n_local, jnp.int32
                    ).at[flat].set(
                        jnp.where(sendable, uids - owner * n_local, n_local)
                    )[: K * ccap]
                    send_mass = jnp.zeros(
                        (K * ccap + 1, s_loc), dtype
                    ).at[flat].set(
                        cbuf * sendable[:, None].astype(dtype)
                    )[: K * ccap]
                    # leftovers wait in the carry outbox (flushed by dense
                    # rounds)
                    left = jnp.logical_and(owner < K, rank >= ccap)
                    carry = carry.at[
                        jnp.clip(uids, 0, carry.shape[0] - 1)
                    ].add(cbuf * left[:, None].astype(dtype))
                    pend = pend + jnp.sum(left, dtype=jnp.int32)
                # THE exchange: one all_to_all of (local id, mass) buckets
                recv_ids = jax.lax.all_to_all(
                    send_ids.reshape(K, ccap), "rows",
                    split_axis=0, concat_axis=0, tiled=True,
                ).reshape(-1)
                recv_mass = jax.lax.all_to_all(
                    send_mass.reshape(K, ccap, s_loc), "rows",
                    split_axis=0, concat_axis=0, tiled=True,
                ).reshape(-1, s_loc)
                # received blocks are sorted per SENDER but not globally —
                # one (id, lane) sort makes the residual scatter sorted
                # AND gives the next-candidate dedup + the ASCENDING cand2
                # the next round's sorted p/r scatters rely on
                M = K * ccap
                lane_r = jax.lax.broadcasted_iota(jnp.int32, (M,), 0)
                rid_s, order_r = jax.lax.sort(
                    (recv_ids, lane_r), num_keys=1, is_stable=True
                )
                rm_s = recv_mass[order_r] * (
                    rid_s < n_local
                ).astype(dtype)[:, None]
                rcs = jnp.clip(rid_s, 0, n_local - 1)
                if mode == FORWARD:
                    r = r.at[rcs].add(rm_s, indices_are_sorted=True)
                else:
                    r = r.at[rcs].add(
                        rm_s * inv_deg[rcs], indices_are_sorted=True
                    )
                prev_r = jnp.concatenate(
                    [jnp.full(1, -1, rid_s.dtype), rid_s[:-1]]
                )
                win2 = jnp.logical_and(rid_s != prev_r, rid_s < n_local)
                cn2 = jnp.sum(win2, dtype=jnp.int32)
                (cp2,) = jnp.nonzero(win2, size=min(M, wcarry), fill_value=0)
                inr2 = jax.lax.broadcasted_iota(jnp.int32, (min(M, wcarry),), 0) < cn2
                cand2 = jnp.where(inr2, rid_s[cp2], n_local)
                if cand2.shape[0] < wcarry:
                    cand2 = jnp.concatenate(
                        [cand2, jnp.full(wcarry - cand2.shape[0], n_local, jnp.int32)]
                    )
                fed2 = jnp.sum(jnp.where(win2, srl[rcs], 0), dtype=jnp.int32)
                fre2 = jnp.sum(jnp.where(win2, f_len[rcs], 0), dtype=jnp.int32)
                ok2 = (cn2 <= wcarry).astype(jnp.int32)
                na = jnp.sum(act, dtype=jnp.float32)
                ew = jnp.sum(
                    act * (srl[cc] + f_len[cc])[:, None], dtype=jnp.float32
                )
                stats2 = (stats[0] + 1, stats[1] + na, stats[2] + ew, stats[3] + 1)
                return (p, r, cand2, cn2, fed2, fre2, ok2, carry, pend, stats2), na

            def dense_round(c):
                (p, r, cand, cn, fed, fre, okf, carry, pend, stats) = c
                act = active_of(r, deg)
                mass = jnp.where(act, r, jnp.zeros((), dtype))
                p = p + jnp.where(dangling, mass, alpha * mass)
                r = r - mass
                if mode == FORWARD:
                    moving = (1.0 - alpha) * mass * inv_deg
                else:
                    moving = jnp.where(dangling, beta * mass, (1.0 - alpha) * mass)
                # delivery expansion over the local-first views: dead/pad
                # edges point d_gat at the zero trash row, so no masks are
                # needed. LOCAL-destination deliveries run straight into r —
                # the reduce-scatter only ever carries REMOTE mass, and is
                # statically absent at K=1 where every edge is local.
                moving_ext = jnp.concatenate(
                    [moving, jnp.zeros((1, mass.shape[1]), dtype)]
                )
                base = jax.lax.axis_index("rows").astype(jnp.int32) * n_local
                contrib = moving_ext[d_gat]
                fcontrib = moving_ext[fd_gat]
                if mode != FORWARD:
                    # receiver-side 1/d_out folds in per edge for the local
                    # delivery; the remote path stays unscaled — owners
                    # apply inv_deg after the reduce-scatter
                    fac = inv_deg[jnp.clip(d_sca - base, 0, n_local - 1), 0]
                    ffac = inv_deg[jnp.clip(fd_sca - base, 0, n_local - 1), 0]
                    contrib_l = contrib * fac[:, None]
                    fcontrib_l = fcontrib * ffac[:, None]
                else:
                    contrib_l, fcontrib_l = contrib, fcontrib
                in1 = jnp.logical_and(d_sca >= base, d_sca < base + n_local)
                in2 = jnp.logical_and(fd_sca >= base, fd_sca < base + n_local)
                # at K=1 the whole view is the local segment sorted by dst
                # (dead tail clips to n_local-1, still monotone) — the flag
                # is only unsafe when a remote part exists
                r = r.at[jnp.clip(d_sca - base, 0, n_local - 1)].add(
                    contrib_l * in1[:, None].astype(dtype),
                    indices_are_sorted=(K == 1),
                )
                r = r.at[jnp.clip(fd_sca - base, 0, n_local - 1)].add(
                    fcontrib_l * in2[:, None].astype(dtype),
                    indices_are_sorted=(K == 1),
                )
                if K > 1:
                    rem1 = jnp.logical_not(in1)
                    rem2 = jnp.logical_not(in2)
                    acc = carry.at[jnp.clip(d_sca, 0, n_pad - 1)].add(
                        contrib * rem1[:, None].astype(dtype)
                    )
                    acc = acc.at[jnp.clip(fd_sca, 0, n_pad - 1)].add(
                        fcontrib * rem2[:, None].astype(dtype)
                    )
                    delta = jax.lax.psum_scatter(
                        acc, "rows", scatter_dimension=0, tiled=True
                    )
                    if mode == FORWARD:
                        r = r + delta
                    else:
                        r = r + delta * inv_deg
                # else: K == 1 -> every edge is local by construction and
                # compact rounds deliver quota-free (no wire), so the
                # carry is statically never fed
                carry = jnp.zeros_like(carry)
                pend = jnp.zeros((), jnp.int32)
                # Post-delivery rescan: the whole O(n_local*S) activity
                # scan + stats block is SKIPPED while the current
                # frontier's edge mass sits far above the ladder top — a
                # mid-flush dense round's successor is another dense round
                # with near-certainty (the frontier decays ~1.45x/round).
                # Mispredicting costs one extra dense
                # round; skipping never affects correctness (forced-dense
                # rounds still converge, and the loop's work predicate
                # comes from na, not these stats). The decision must be
                # UNIFORM along 'rows' (cand2 feeds an all_to_all round):
                # pmax, like the tier choice.
                anyp = jnp.any(act, axis=1)
                ewr = jnp.sum(
                    jnp.where(anyp, srl + f_len, 0), dtype=jnp.int32
                )
                heavy = jax.lax.pmax(ewr, "rows") > jnp.asarray(
                    STATS_GUARD * tiers[-1][1], jnp.int32
                )

                def full_stats(_):
                    act2 = active_of(r, deg)
                    any2 = jnp.any(act2, axis=1)
                    cn2 = jnp.sum(any2, dtype=jnp.int32)
                    fed2 = jnp.sum(jnp.where(any2, srl, 0), dtype=jnp.int32)
                    fre2 = jnp.sum(
                        jnp.where(any2, f_len, 0), dtype=jnp.int32
                    )
                    fits2 = jnp.logical_and(
                        jnp.logical_and(
                            jax.lax.pmax(cn2, "rows") <= tiers[-1][0],
                            jax.lax.pmax(fed2, "rows") <= tiers[-1][1],
                        ),
                        jax.lax.pmax(fre2, "rows") <= tiers[-1][2],
                    )

                    def reseed(any2):
                        (idx2,) = jnp.nonzero(
                            any2, size=wcarry, fill_value=n_local
                        )
                        return idx2.astype(jnp.int32)

                    cand2 = jax.lax.cond(
                        fits2, reseed,
                        lambda _: jnp.full(wcarry, n_local, jnp.int32), any2,
                    )
                    return cand2, cn2, fed2, fre2, fits2.astype(jnp.int32)

                def skip_stats(_):
                    big = jnp.asarray(jnp.iinfo(jnp.int32).max // 2, jnp.int32)
                    return (
                        jnp.full(wcarry, n_local, jnp.int32),
                        big, big, big, jnp.zeros((), jnp.int32),
                    )

                cand2, cn2, fed2, fre2, ok2 = jax.lax.cond(
                    heavy, skip_stats, full_stats, None
                )
                na = jnp.sum(act, dtype=jnp.float32)
                ew = jnp.sum(act * (srl + f_len)[:, None], dtype=jnp.float32)
                stats2 = (stats[0] + 1, stats[1] + na, stats[2] + ew, stats[3])
                return (p, r, cand2, cn2, fed2, fre2, ok2, carry, pend, stats2), na

            def body(c):
                (p_, r_, cand, cn, fed, fre, okf, carry, pend, stats, _na) = c
                # UNIFORM (along 'rows') decision: all shards of one a2a
                # group must take the same branch
                cn_g = jax.lax.pmax(cn, "rows")
                fed_g = jax.lax.pmax(fed, "rows")
                fre_g = jax.lax.pmax(fre, "rows")
                ok_g = jax.lax.pmin(okf, "rows")
                pend_g = jax.lax.pmax(pend, "rows")
                w_t, e_t, g_t = tiers[-1]
                fits_top = jnp.logical_and(
                    jnp.logical_and(cn_g <= w_t, fed_g <= e_t), fre_g <= g_t
                )
                use_wl = jnp.logical_and(
                    jnp.logical_and(ok_g > 0, fits_top), pend_g == 0
                )
                if len(tiers) == 1:
                    miss = jnp.zeros((), jnp.int32)
                else:
                    miss = sum(
                        jnp.logical_not(
                            jnp.logical_and(
                                jnp.logical_and(cn_g <= w_i, fed_g <= e_i),
                                fre_g <= g_i,
                            )
                        ).astype(jnp.int32)
                        for (w_i, e_i, g_i) in tiers[:-1]
                    )
                branch = jnp.where(use_wl, miss, len(tiers))
                state = (p_, r_, cand, cn, fed, fre, okf, carry, pend, stats)
                branches = [
                    functools.partial(compact_round, i) for i in range(len(tiers))
                ] + [dense_round]
                state2, na_loc = jax.lax.switch(branch, branches, state)
                (p2, r2, cand2, cn2, fed2, fre2, ok2, carry2, pend2, stats2) = state2
                na = jax.lax.psum(na_loc, ("rows", "srcs"))
                pend_any = jax.lax.psum(
                    (pend2 > 0).astype(jnp.float32), ("rows", "srcs")
                )
                work = na + pend_any
                return (p2, r2, cand2, cn2, fed2, fre2, ok2, carry2, pend2,
                        stats2, work)

            def cond(c):
                *_, stats, work = c
                return jnp.logical_and(work > 0, stats[0] < cfg.max_rounds)

            live0 = cand0 < n_local
            cn0 = jnp.sum(live0, dtype=jnp.int32)
            fed0, fre0 = counts_of(cand0, live0)
            # at K=1 the carry is provably never fed (compact rounds
            # deliver quota-free — no wire), so it shrinks to a dummy row:
            # an [n_pad, S] zero buffer in the loop carry costs real copies
            carry0 = jnp.zeros((n_pad if K > 1 else 1, s_loc), dtype)
            stats0 = (
                jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32),
                jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32),
            )
            init = (
                p, r, cand0, cn0, fed0, fre0,
                jnp.asarray(ok0, jnp.int32), carry0, jnp.zeros((), jnp.int32),
                stats0, jnp.asarray(1.0, jnp.float32),
            )
            out = jax.lax.while_loop(cond, body, init)
            p, r = out[0], out[1]
            stats = out[9]
            rounds = stats[0]
            pushes = jax.lax.psum(stats[1], ("rows", "srcs"))
            epushes = jax.lax.psum(stats[2], ("rows", "srcs"))
            wl_rounds = stats[3]
            return p, r, rounds, pushes, epushes, wl_rounds

        # ---------------- memory-proportional push loop ----------------
        ccarry = getattr(self, "ccarry", 0)

        def prop_push_loop(p, r, deg, snap, cand0, ok0,
                           cids0=None, cmass0=None, pend0=None):
            """Per-shard proportional loop: compact rounds emit through
            sorted_bucket (no n_pad scratch, no [n_pad,S] outbox); overflow
            waits in a compact sorted carry drained by dedicated a2a rounds;
            frontiers that outgrow the ladder run the all-covering top tier
            seeded with every local row (rescan). Optional (cids0, cmass0,
            pend0) seed the carry with correction-delivery overflow."""
            alpha = jnp.asarray(alpha_f, dtype)
            beta = (1.0 - alpha) / alpha
            s_loc = p.shape[1]
            inv_deg = (1.0 / jnp.maximum(deg, 1).astype(dtype))[:, None]
            soff, snbr, srl = snap["soff"], snap["snbr"], snap["srl"]
            f_off, f_nbr, f_len = snap["f_off"], snap["f_nbr"], snap["f_len"]
            n_t = len(tiers)

            def deliver(r, send_ids, send_mass):
                q = send_ids.shape[0] // K  # per-destination quota
                recv_ids = jax.lax.all_to_all(
                    send_ids.reshape(K, q), "rows",
                    split_axis=0, concat_axis=0, tiled=True,
                ).reshape(-1)
                recv_mass = jax.lax.all_to_all(
                    send_mass.reshape(K, q, s_loc), "rows",
                    split_axis=0, concat_axis=0, tiled=True,
                ).reshape(-1, s_loc)
                M = K * q
                if M >= SORT_BUCKET_MIN:
                    lane_r = jax.lax.broadcasted_iota(jnp.int32, (M,), 0)
                    rid_s, order_r = jax.lax.sort(
                        (recv_ids, lane_r), num_keys=1, is_stable=True
                    )
                    rm_s = recv_mass[order_r] * (
                        rid_s < n_local
                    ).astype(dtype)[:, None]
                    rcs = jnp.clip(rid_s, 0, n_local - 1)
                    if mode == FORWARD:
                        r = r.at[rcs].add(rm_s, indices_are_sorted=True)
                    else:
                        r = r.at[rcs].add(
                            rm_s * inv_deg[rcs], indices_are_sorted=True
                        )
                else:
                    rc = jnp.clip(recv_ids, 0, n_local - 1)
                    if mode == FORWARD:
                        r = r.at[rc].add(recv_mass)
                    else:
                        r = r.at[rc].add(recv_mass * inv_deg[rc])
                return r, recv_ids

            def next_cand(prev_ids, prev_live, recv_ids):
                """Union of surviving candidates and fresh deliveries via an
                O(n_local) mark array (proportional; never O(n_pad))."""
                mark = jnp.zeros(n_local + 1, jnp.int32)
                mark = mark.at[prev_ids].max(prev_live.astype(jnp.int32))
                mark = mark.at[recv_ids].max(
                    (recv_ids < n_local).astype(jnp.int32)
                )
                any2 = mark[:n_local] > 0
                cn2 = jnp.sum(any2, dtype=jnp.int32)
                (idx2,) = jnp.nonzero(any2, size=wcarry, fill_value=n_local)
                cand2 = idx2.astype(jnp.int32)
                fed2 = jnp.sum(jnp.where(any2, srl, 0), dtype=jnp.int32)
                fre2 = jnp.sum(jnp.where(any2, f_len, 0), dtype=jnp.int32)
                return cand2, cn2, fed2, fre2

            def compact_round(i, c, cand_override=None):
                w_i, e_i, g_i = tiers[i]
                ccap = ccaps[i]
                (p, r, cand, cn, fed, fre, okf, cids, cmass, pend, stats) = c
                candw = cand[:w_i] if cand_override is None else cand_override
                cc = jnp.clip(candw, 0, n_local - 1)
                live = candw < n_local
                r_c = jnp.where(live[:, None], r[cc], jnp.zeros((), dtype))
                deg_c = deg[cc]
                if mode == FORWARD:
                    th = cfg.eps * jnp.maximum(deg_c, 1).astype(dtype)
                    act = jnp.abs(r_c) > th[:, None]
                else:
                    act = jnp.abs(r_c) > jnp.asarray(cfg.eps, dtype)
                act = jnp.logical_and(act, live[:, None])
                mass = jnp.where(act, r_c, jnp.zeros((), dtype))
                dang_c = (deg_c == 0)[:, None]
                # cand lists are ascending (next_cand nonzero / iota
                # override / np.unique host seeds) -> sorted scatters
                p = p.at[cc].add(
                    jnp.where(dang_c, mass, alpha * mass),
                    indices_are_sorted=True,
                )
                r = r.at[cc].add(-mass, indices_are_sorted=True)
                if mode == FORWARD:
                    inv_c = 1.0 / jnp.maximum(deg_c, 1).astype(dtype)
                    moving = (1.0 - alpha) * mass * inv_c[:, None]
                else:
                    moving = jnp.where(dang_c, beta * mass, (1.0 - alpha) * mass)
                anyact = jnp.any(act, axis=1)
                len1 = jnp.where(anyact, srl[cc], 0)
                t1, pos1, val1 = rld_expand(soff[cc], len1, e_i)
                g1 = jnp.where(val1, snbr[jnp.clip(pos1, 0, sstride - 1)], n_pad)
                len2 = jnp.where(anyact, f_len[cc], 0)
                t2, pos2, val2 = rld_expand(f_off[cc], len2, g_i)
                g2 = jnp.where(val2, f_nbr[jnp.clip(pos2, 0, fring)], n_pad)
                ids = jnp.concatenate([g1, g2])
                send_ids, send_mass, cids2, cmass2, pend2 = sorted_bucket_rows(
                    ids, jnp.concatenate([t1, t2]), moving, K, n_local,
                    n_pad, ccap, ccarry, dtype
                )
                r, recv_ids = deliver(r, send_ids, send_mass)
                empty = jnp.full(1, n_local, jnp.int32)
                cand2, cn2, fed2, fre2 = next_cand(
                    empty, jnp.zeros(1, bool), recv_ids
                )
                na = jnp.sum(act, dtype=jnp.float32)
                ew = jnp.sum(
                    act * (srl[cc] + f_len[cc])[:, None], dtype=jnp.float32
                )
                stats2 = (stats[0] + 1, stats[1] + na, stats[2] + ew, stats[3] + 1)
                return (p, r, cand2, cn2, fed2, fre2, jnp.ones((), jnp.int32),
                        cids2, cmass2, pend2, stats2), na

            def drain_round(c):
                (p, r, cand, cn, fed, fre, okf, cids, cmass, pend, stats) = c
                send_ids, send_mass, cids2, cmass2, pend2 = sorted_bucket(
                    cids, cmass, K, n_local, n_pad, ccap, ccarry, dtype
                )
                r, recv_ids = deliver(r, send_ids, send_mass)
                cand2, cn2, fed2, fre2 = next_cand(
                    cand, cand < n_local, recv_ids
                )
                stats2 = (stats[0] + 1, stats[1], stats[2], stats[3] + 1)
                work = (cn2 > 0).astype(jnp.float32)
                return (p, r, cand2, cn2, fed2, fre2, okf,
                        cids2, cmass2, pend2, stats2), work

            def rescan_round(c):
                all_rows = jax.lax.broadcasted_iota(jnp.int32, (n_local + 1,), 0)
                return compact_round(n_t - 1, c, cand_override=all_rows)

            def body(c):
                (p_, r_, cand, cn, fed, fre, okf, cids, cmass, pend,
                 stats, _w) = c
                cn_g = jax.lax.pmax(cn, "rows")
                fed_g = jax.lax.pmax(fed, "rows")
                fre_g = jax.lax.pmax(fre, "rows")
                ok_g = jax.lax.pmin(okf, "rows")
                pend_g = jax.lax.pmax(pend, "rows")
                if n_t == 1:
                    miss = jnp.zeros((), jnp.int32)
                else:
                    miss = sum(
                        jnp.logical_not(
                            jnp.logical_and(
                                jnp.logical_and(cn_g <= w_i, fed_g <= e_i),
                                fre_g <= g_i,
                            )
                        ).astype(jnp.int32)
                        for (w_i, e_i, g_i) in tiers[:-1]
                    )
                branch = jnp.where(
                    pend_g > 0, n_t,
                    jnp.where(ok_g > 0, miss, n_t + 1),
                )
                state = (p_, r_, cand, cn, fed, fre, okf, cids, cmass, pend,
                         stats)
                branches = [
                    functools.partial(compact_round, i) for i in range(n_t)
                ] + [drain_round, rescan_round]
                state2, w_loc = jax.lax.switch(branch, branches, state)
                work = jax.lax.psum(w_loc, ("rows", "srcs")) + jax.lax.psum(
                    (state2[9] > 0).astype(jnp.float32), ("rows", "srcs")
                )
                return (*state2, work)

            def cond(c):
                *_, stats, work = c
                return jnp.logical_and(work > 0, stats[0] < cfg.max_rounds)

            live0 = cand0 < n_local
            cn0 = jnp.sum(live0, dtype=jnp.int32)
            cc0 = jnp.clip(cand0, 0, n_local - 1)
            fed0 = jnp.sum(jnp.where(live0, srl[cc0], 0), dtype=jnp.int32)
            fre0 = jnp.sum(jnp.where(live0, f_len[cc0], 0), dtype=jnp.int32)
            if cids0 is None:
                cids0 = jnp.full(ccarry, n_pad, jnp.int32)
                cmass0 = jnp.zeros((ccarry, s_loc), dtype)
                pend0 = jnp.zeros((), jnp.int32)
            stats0 = (
                jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32),
                jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32),
            )
            init = (
                p, r, cand0, cn0, fed0, fre0,
                jnp.asarray(ok0, jnp.int32), cids0, cmass0, pend0,
                stats0, jnp.asarray(1.0, jnp.float32),
            )
            out = jax.lax.while_loop(cond, body, init)
            p, r = out[0], out[1]
            stats = out[10]
            rounds = stats[0]
            pushes = jax.lax.psum(stats[1], ("rows", "srcs"))
            epushes = jax.lax.psum(stats[2], ("rows", "srcs"))
            wl_rounds = stats[3]
            return p, r, rounds, pushes, epushes, wl_rounds

        loop_fn = prop_push_loop if self.proportional else wl_push_loop
        self._wl_loop_body = loop_fn

        snap_specs = {k: spec_row for k in _snap_spec_names}
        self._snap_specs = snap_specs

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        @functools.partial(
            smap,
            in_specs=(spec_state, spec_state, spec_row, snap_specs,
                      spec_row, rep),
            out_specs=(spec_state, spec_state, rep, rep, rep, rep),
        )
        def push_fn(p, r, deg, snap, cand0, ok0):
            return loop_fn(p, r, deg, snap, cand0, ok0)

        self._wl_push = push_fn

        # ---------------- graph mutation (block-local) ----------------
        def mutate_graph(snap, clear_slots, gat, sca, val):
            """Kill expiring edges in the snapshot (their slots are
            snapshot-era: the driver enforces the fresh ring never outlives
            a window) and append the fresh batch (contiguous valid prefix
            per shard; padding lands in the ring trash slot), then re-sort
            the fresh mini-CSR."""
            snbr2 = snap["snbr"].at[snap["spos"][clear_slots]].set(n_pad)
            # kill in the delivery view too: point the gather at the zero
            # trash row (d_sca and the tile ranges stay untouched)
            d_gat2 = snap["d_gat"].at[snap["d_pos"][clear_slots]].set(n_local)
            fcnt0 = snap["fcnt"][0]
            bk = gat.shape[0]
            pos = jnp.where(
                val > 0,
                fcnt0 + jax.lax.broadcasted_iota(jnp.int32, (bk,), 0),
                fring,
            )
            fr_gat2 = snap["fr_gat"].at[pos].set(
                jnp.where(val > 0, gat, n_local)
            ).at[fring].set(n_local)
            fr_sca2 = snap["fr_sca"].at[pos].set(
                jnp.where(val > 0, sca, n_pad)
            ).at[fring].set(n_pad)
            f_len2 = snap["f_len"].at[jnp.clip(gat, 0, n_local - 1)].add(val)
            _, f_nbr2 = jax.lax.sort_key_val(fr_gat2, fr_sca2, is_stable=True)
            f_off2 = jnp.concatenate(
                [jnp.zeros(1, jnp.int32), jnp.cumsum(f_len2, dtype=jnp.int32)]
            )
            # delivery-sorted fresh view for dense rounds (local-first
            # layout, same as the snapshot's d view)
            base = jax.lax.axis_index("rows").astype(jnp.int32) * n_local
            fd_sca2, fd_gat2, _ = _delivery_views(
                fr_sca2, fr_gat2, fr_sca2 < n_pad, RS, base, need_pos=False
            )
            return {
                **snap,
                "snbr": snbr2,
                "d_gat": d_gat2,
                "fd_gat": fd_gat2,
                "fd_sca": fd_sca2,
                "fr_gat": fr_gat2,
                "fr_sca": fr_sca2,
                "f_off": f_off2,
                "f_nbr": f_nbr2,
                "f_len": f_len2,
                "fcnt": jnp.reshape(fcnt0 + jnp.sum(val, dtype=jnp.int32), (1,)),
            }

        # ---------------- slides ----------------
        # The slide takes ONE packed int32 batch per shard (fewer, smaller
        # host-to-device transfers). Only non-derivable data ships: the fresh edges and the host's slot
        # schedule. Expiring edges are read back from the device window
        # buffers (egl/eog/eva at clear_slots — padding targets the trash
        # slot whose eva is 0, so validity comes along for free), insert
        # validity derives from the per-shard count, and the initial
        # candidate list derives from which rows the corrections touched.
        bcap_ = self.bcap

        def _cand_from_marks(mark):
            """Compact ascending candidate list from an [n_local+1] touch
            mask (the push loop's cand0 contract: unique live rows first,
            ascending, phantom-padded)."""
            m = mark[:n_local]
            (idx,) = jnp.nonzero(m, size=wcarry, fill_value=n_local)
            return idx.astype(jnp.int32)

        if mode == FORWARD:
            # pack layout per shard: [ins_u(b), ins_w(b), cnt_w, cnt_c,
            # pad...] — PACK_F words. The slot schedule (which slots the
            # expiring edges free and which slots the fresh edges claim)
            # is DERIVED ON DEVICE from a per-shard FIFO occupancy ring +
            # LIFO free stack (round-4 open lever: clear/write slots were
            # half the packed slide's H2D bytes). The sliding window is
            # FIFO, so each shard's expiring edges are exactly its oldest
            # cnt_c ring entries; the device replays the same
            # push-freed/pop-top schedule the host simulates for overflow
            # detection and checkpoints (bit-identical by construction).
            PACK_F = 2 * bcap_ + 8
            ecap_ = self.ecap
            RCAP = ecap_ + 1  # FIFO ring modulus (live slots <= ecap)
            ring_specs = {k: spec_row for k in WL_RING_KEYS}

            @functools.partial(jax.jit, donate_argnums=(0, 1, 3, 4, 5, 6, 8))
            @functools.partial(
                smap,
                in_specs=(spec_state, spec_state, spec_row, spec_row, spec_row,
                          spec_row, snap_specs, spec_row, ring_specs),
                out_specs=(spec_state, spec_state, rep, rep, rep, rep,
                           spec_row, spec_row, spec_row, spec_row, snap_specs,
                           ring_specs),
            )
            def slide_fn(p, r, deg, egl, eog, eva, snap, pack, ring):
                b = bcap_
                ins_u = pack[:b]
                ins_w = pack[b:2 * b]
                cnt_w = pack[2 * b]
                cnt_c = pack[2 * b + 1]
                iota_b = jax.lax.broadcasted_iota(jnp.int32, (b,), 0)
                ins_v = (iota_b < cnt_w).astype(jnp.int32)
                trash = jnp.int32(ecap_)
                hd = ring["hd"][0]
                oring, fstack = ring["oring"], ring["fstack"]
                ft = ring["ftop"][0]
                # expiring slots: the shard's cnt_c oldest ring entries
                pos_c = jax.lax.rem(hd + iota_b, jnp.int32(RCAP))
                clear_slots = jnp.where(iota_b < cnt_c, oring[pos_c], trash)
                hd2 = jax.lax.rem(hd + cnt_c, jnp.int32(RCAP))
                # push freed slots (stack dump index ecap is out of every
                # valid stack range: free + live == ecap per shard)
                fstack = fstack.at[
                    jnp.where(iota_b < cnt_c, ft + iota_b, jnp.int32(ecap_))
                ].set(clear_slots)
                ft = ft + cnt_c
                # pop top-first for the fresh batch (entry i <-> ins_* i)
                pos_w = jnp.clip(ft - 1 - iota_b, 0, ecap_)
                write_slots = jnp.where(iota_b < cnt_w, fstack[pos_w], trash)
                ft = ft - cnt_w
                # append claimed slots at the ring tail (dump index RCAP)
                tl = ring["tl"][0]
                oring = oring.at[
                    jnp.where(
                        iota_b < cnt_w,
                        jax.lax.rem(tl + iota_b, jnp.int32(RCAP)),
                        jnp.int32(RCAP),
                    )
                ].set(write_slots)
                tl2 = jax.lax.rem(tl + cnt_w, jnp.int32(RCAP))
                ring2 = {
                    "oring": oring, "fstack": fstack,
                    "hd": jnp.reshape(hd2, (1,)),
                    "tl": jnp.reshape(tl2, (1,)),
                    "ftop": jnp.reshape(ft, (1,)),
                }
                del_u = egl[clear_slots]
                del_w = eog[clear_slots]
                del_v = eva[clear_slots]
                mark = jnp.zeros(n_local + 1, jnp.bool_)
                mark = mark.at[jnp.where(del_v > 0, del_u, n_local)].set(True)
                mark = mark.at[jnp.where(ins_v > 0, ins_u, n_local)].set(True)
                carry_seed = ()
                if self.proportional:
                    # correction deliveries ride the bucketed exchange too;
                    # overflow seeds the push loop's carry (no [n_pad, S]
                    # acc / reduce-scatter anywhere on this path)
                    p, r, ids, vals, deg2 = forward_corrections_pairs(
                        p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v,
                        alpha_f, dtype, n_pad,
                    )
                    send_ids, send_mass, cids0, cmass0, pend0 = sorted_bucket(
                        ids, vals, K, n_local, n_pad, ccap, ccarry, dtype
                    )
                    recv_ids = jax.lax.all_to_all(
                        send_ids.reshape(K, ccap), "rows",
                        split_axis=0, concat_axis=0, tiled=True,
                    ).reshape(-1)
                    recv_mass = jax.lax.all_to_all(
                        send_mass.reshape(K, ccap, p.shape[1]), "rows",
                        split_axis=0, concat_axis=0, tiled=True,
                    ).reshape(-1, p.shape[1])
                    r = r.at[jnp.clip(recv_ids, 0, n_local - 1)].add(recv_mass)
                    carry_seed = (cids0, cmass0, pend0)
                    mark = mark.at[
                        jnp.where(recv_ids < n_local, recv_ids, n_local)
                    ].set(True)
                elif K == 1:
                    # no wire: correction deliveries scatter straight into
                    # r (global ids == local ids), skipping the [n_pad, S]
                    # acc build + identity reduce-scatter + full-state
                    # delta pass (round 5)
                    p, r, ids, vals, deg2 = forward_corrections_pairs(
                        p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v,
                        alpha_f, dtype, n_pad,
                    )
                    validc = ids < n_pad
                    r = r.at[jnp.clip(ids, 0, n_local - 1)].add(
                        vals * validc[:, None].astype(dtype)
                    )
                    mark = mark.at[
                        jnp.where(validc, ids, n_local)
                    ].set(True)
                else:
                    p, r, acc, deg2 = forward_corrections(
                        p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v,
                        alpha_f, dtype, n_pad,
                    )
                    delta = jax.lax.psum_scatter(
                        acc, "rows", scatter_dimension=0, tiled=True
                    )
                    r = r + delta
                    mark = jnp.logical_or(
                        mark,
                        jnp.concatenate(
                            [jnp.any(delta != 0, axis=1),
                             jnp.zeros(1, jnp.bool_)]
                        ),
                    )
                cand0 = _cand_from_marks(mark)
                eva2 = eva.at[clear_slots].set(0)
                egl2 = egl.at[write_slots].set(ins_u)
                eog2 = eog.at[write_slots].set(ins_w)
                eva2 = eva2.at[write_slots].set(ins_v)
                eva2 = eva2.at[-1].set(0)
                snap2 = mutate_graph(snap, clear_slots, ins_u, ins_w, ins_v)
                p, r, rounds, pushes, epushes, wl = loop_fn(
                    p, r, deg2, snap2, cand0, jnp.ones((), jnp.int32),
                    *carry_seed,
                )
                return (p, r, rounds, pushes, epushes, wl,
                        deg2, egl2, eog2, eva2, snap2, ring2)

            self.pack_len = PACK_F
        else:
            # pack layout per shard: [del_u(b), ins_u(b), clear(b),
            # write_slots(b), write_dl(b), write_sg(b), cnt_o, cnt_n,
            # cnt_w, pad...] — PACK_R words. del/ins batches are grouped by
            # SRC owner (degree updates), write batches by DST owner (slot
            # writes); validity flags derive from the counts.
            PACK_R = 6 * bcap_ + 8

            @functools.partial(jax.jit, donate_argnums=(0, 1, 3, 4, 5, 6))
            @functools.partial(
                smap,
                in_specs=(spec_state, spec_state, spec_row, spec_row, spec_row,
                          spec_row, snap_specs, spec_row),
                out_specs=(spec_state, spec_state, rep, rep, rep, rep,
                           spec_row, spec_row, spec_row, spec_row, snap_specs),
            )
            def slide_fn(p, r, deg, egl, eog, eva, snap, pack):
                b = bcap_
                del_u = pack[:b]
                ins_u = pack[b:2 * b]
                clear_slots = pack[2 * b:3 * b]
                write_slots = pack[3 * b:4 * b]
                write_dl = pack[4 * b:5 * b]
                write_sg = pack[5 * b:6 * b]
                cnt_o, cnt_n, cnt_w = pack[6 * b], pack[6 * b + 1], pack[6 * b + 2]
                iota_b = jax.lax.broadcasted_iota(jnp.int32, (b,), 0)
                del_v = (iota_b < cnt_o).astype(jnp.int32)
                ins_v = (iota_b < cnt_n).astype(jnp.int32)
                write_v = (iota_b < cnt_w).astype(jnp.int32)
                # reverse corrections with the rowsum sweep riding the
                # delivery-sorted views: the parent's form scatters p[egl]
                # UNSORTED over every window slot (the single largest
                # reverse-slide term); here s_old comes from the same
                # delivery-sorted views as dense rounds (d view =
                # snapshot-era live edges, fd view = fresh edges —
                # together exactly the eva-live set)
                s_loc = p.shape[1]
                p_ext = jnp.concatenate([p, jnp.zeros((1, s_loc), dtype)])
                base = jax.lax.axis_index("rows").astype(jnp.int32) * n_local
                d_sca_, fd_sca_ = snap["d_sca"], snap["fd_sca"]
                contrib = p_ext[snap["d_gat"]]
                fcontrib = p_ext[snap["fd_gat"]]
                # rowsum sweep over the local-first delivery views: rows
                # whose out-edges' sum lives on this shard accumulate
                # directly; only remote-row contributions ride the
                # reduce-scatter (statically none at K=1)
                in1 = jnp.logical_and(d_sca_ >= base, d_sca_ < base + n_local)
                in2 = jnp.logical_and(fd_sca_ >= base, fd_sca_ < base + n_local)
                s_loc_old = jnp.zeros((n_local, s_loc), dtype).at[
                    jnp.clip(d_sca_ - base, 0, n_local - 1)
                ].add(contrib * in1[:, None].astype(dtype),
                      indices_are_sorted=(K == 1))
                s_loc_old = s_loc_old.at[
                    jnp.clip(fd_sca_ - base, 0, n_local - 1)
                ].add(fcontrib * in2[:, None].astype(dtype),
                      indices_are_sorted=(K == 1))
                old_v = eva[clear_slots].astype(dtype)[:, None]
                acc_d = jnp.zeros((n_pad, s_loc), dtype).at[
                    eog[clear_slots]
                ].add(-p[egl[clear_slots]] * old_v)
                acc_d = acc_d.at[write_sg].add(
                    p[write_dl] * write_v.astype(dtype)[:, None]
                )
                if K > 1:
                    # remote rowsum accumulator: only edges whose row sum
                    # lives on another shard ride the reduce-scatter
                    acc_old = jnp.zeros((n_pad, s_loc), dtype).at[
                        jnp.clip(d_sca_, 0, n_pad - 1)
                    ].add(
                        contrib * jnp.logical_not(in1)[:, None].astype(dtype)
                    )
                    acc_old = acc_old.at[
                        jnp.clip(fd_sca_, 0, n_pad - 1)
                    ].add(
                        fcontrib * jnp.logical_not(in2)[:, None].astype(dtype)
                    )
                    red = jax.lax.psum_scatter(
                        jnp.concatenate([acc_old, acc_d], axis=1), "rows",
                        scatter_dimension=0, tiled=True,
                    )
                    s_old = s_loc_old + red[:, :s_loc]
                    s_new = s_old + red[:, s_loc:]
                else:
                    # single shard: the batch-delta "collective" is its own
                    # block — no reduce needed
                    s_old = s_loc_old
                    s_new = s_old + acc_d[:n_local]
                eva2 = eva.at[clear_slots].set(0)
                egl2 = egl.at[write_slots].set(write_dl)
                eog2 = eog.at[write_slots].set(write_sg)
                eva2 = eva2.at[write_slots].set(write_v)
                eva2 = eva2.at[-1].set(0)
                r, d_new = reverse_apply(
                    p, r, deg, del_u, del_v, ins_u, ins_v, s_old, s_new,
                    alpha_f, dtype,
                )
                # touched rows: any row whose correction was nonzero has a
                # changed out-row sum or changed degree (pp terms cancel
                # exactly otherwise), so this mark covers the new frontier
                mark = jnp.zeros(n_local + 1, jnp.bool_)
                mark = mark.at[jnp.where(del_v > 0, del_u, n_local)].set(True)
                mark = mark.at[jnp.where(ins_v > 0, ins_u, n_local)].set(True)
                mark = jnp.logical_or(
                    mark,
                    jnp.concatenate(
                        [jnp.logical_or(
                            jnp.any(s_new != s_old, axis=1), d_new != deg
                        ), jnp.zeros(1, jnp.bool_)]
                    ),
                )
                cand0 = _cand_from_marks(mark)
                snap2 = mutate_graph(snap, clear_slots, write_dl, write_sg, write_v)
                p, r, rounds, pushes, epushes, wl = loop_fn(
                    p, r, d_new, snap2, cand0, jnp.ones((), jnp.int32)
                )
                return (p, r, rounds, pushes, epushes, wl,
                        d_new, egl2, eog2, eva2, snap2)

            self.pack_len = PACK_R

        self._wl_slide = slide_fn

    # ------------------------------------------------------------------
    def push_wl(self, p, r, deg, snap, cand0=None, ok0=0):
        """Push to convergence with the compact-frontier loop. With no
        cand0, the first round is a dense rescan (exact)."""
        if cand0 is None:
            cand0 = jax.device_put(
                jnp.full(self.n_rows * self.wcarry, self.n_local, jnp.int32),
                NamedSharding(self.mesh, self.row_spec),
            )
            ok0 = 0
        return self._wl_push(p, r, deg, snap, cand0, jnp.asarray(ok0, jnp.int32))

    def slide_wl(self, p, r, deg, egl, eog, eva, snap, pack, ring=None):
        """One window slide on the compact-frontier push loop. ``pack`` is
        the per-shard packed int32 batch (layout in the slide builders —
        self.pack_len words per shard): the ONE host->device transfer per
        slide. Expiring edges, validity flags, the slot schedule (forward
        mode, from ``ring``) and the initial candidate list are derived on
        device. Forward mode returns ``ring2`` as the last element."""
        if self.mode == FORWARD:
            return self._wl_slide(p, r, deg, egl, eog, eva, snap, pack, ring)
        return self._wl_slide(p, r, deg, egl, eog, eva, snap, pack)

    def make_ring(self, oring, hd, tl, fstack, ftop):
        """Device slot-ring dict from host arrays: oring [K, ecap+2] (FIFO
        slot ids, oldest first from hd; dump row at index ecap+1), hd/tl/
        ftop [K], fstack [K, ecap+1] (free slots, LIFO; dump at ecap)."""
        sh = NamedSharding(self.mesh, self.row_spec)

        def put(a):
            return jax.device_put(
                jnp.asarray(np.asarray(a, np.int32).reshape(-1)), sh
            )

        return {
            "oring": put(oring), "hd": put(hd), "tl": put(tl),
            "fstack": put(fstack), "ftop": put(ftop),
        }

    def cand0_rows(self, rows_per_shard: np.ndarray):
        """Host helper: pack per-shard LOCAL candidate row lists (each
        [wcarry], unique ASCENDING, padded with n_local) into the sharded
        device array. Ascending order is a hard contract: compact rounds
        scatter p/r at the candidate rows with indices_are_sorted=True."""
        return jax.device_put(
            jnp.asarray(rows_per_shard.reshape(-1)),
            NamedSharding(self.mesh, self.row_spec),
        )
