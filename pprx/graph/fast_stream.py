"""Sliding-window driver on the compact-frontier v2 engine (pprx.engine.wl2).

Same contract as pprx.graph.stream.StreamDriver / hybrid_stream
.HybridStreamDriver, with the round-2 redesign of the per-slide device work
(SURVEY.md §3.2 outer loop):

- expiries are KILLED IN PLACE in the CSR snapshot via the device-resident
  slot->snapshot-position map (no signed overlay, no per-round overlay
  sweep);
- fresh edges ride a per-slide-re-sorted mini-CSR;
- the convergence loop runs compact slot-sized rounds with exact tier
  selection (see pprx/engine/wl2.py).

Host work per slide is vectorized NumPy (no per-edge Python loops): batch
sort by the correction-scatter endpoint (so the [b, S] correction scatters
run with sorted indices) and the deduplicated initial candidate list.
"""

from __future__ import annotations

import functools
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from pprx.config import PprConfig, StreamConfig
from pprx.engine.state import FORWARD, PprState, PushStats, init_state
from pprx.engine.update import apply_edge_batch
from pprx.engine.wl2 import (
    KillGraph,
    build_kill_graph,
    make_tiers2,
    push_to_convergence_wl2,
    refresh_fresh_csr,
)
from pprx.graph.dynamic import WindowGraph


@functools.partial(
    jax.jit, static_argnames=("cfg", "tiers"), donate_argnums=(0, 1),
)
def wl2_slide_step(
    state: PprState,
    kg: KillGraph,
    pack: jnp.ndarray,
    cfg: PprConfig,
    tiers: tuple[tuple[int, int, int], ...],
) -> tuple[PprState, KillGraph, PushStats]:
    """One window slide from a SINGLE packed int32 transfer.

    ``pack`` layout: [new_src(b), new_dst(b), head, fcnt] (stream order).
    Everything else is derived on device — the expiring batch is read back
    from the device ring at the (head-derived) slots, both batches are
    sorted by their correction-scatter endpoint with one (key, lane) sort
    each, and the initial candidate list comes from a touch-mark compaction.
    Device-derivable data never ships host-to-device.
    """
    n = kg.n
    b = (pack.shape[0] - 8) // 2
    new_src0 = pack[:b]
    new_dst0 = pack[b:2 * b]
    head = pack[2 * b]
    fcnt = pack[2 * b + 1]
    wcap = kg.window.src.shape[0]
    iota_b = jax.lax.broadcasted_iota(jnp.int32, (b,), 0)
    slots0 = jax.lax.rem(head + iota_b, jnp.int32(wcap))
    old_src0 = kg.window.src[slots0]
    old_dst0 = kg.window.dst[slots0]
    # sort both batches by the correction-scatter endpoint so the [b, S]
    # correction scatters see sorted indices (same policy the host sort
    # used; one stable (key, lane) sort each)
    sca_new = new_dst0 if state.mode == FORWARD else new_src0
    sca_old = old_dst0 if state.mode == FORWARD else old_src0
    _, pn = jax.lax.sort((sca_new, iota_b), num_keys=1, is_stable=True)
    _, po = jax.lax.sort((sca_old, iota_b), num_keys=1, is_stable=True)
    new_src, new_dst = new_src0[pn], new_dst0[pn]
    old_src, old_dst = old_src0[po], old_dst0[po]
    slots = slots0[pn]
    # initial candidates: every endpoint the slide touches, unique
    # ascending via an [n+1] touch mark
    mark = jnp.zeros(n + 1, jnp.bool_)
    mark = mark.at[old_src0].set(True).at[old_dst0].set(True)
    mark = mark.at[new_src0].set(True).at[new_dst0].set(True)
    c0n = jnp.sum(mark[:n], dtype=jnp.int32)
    cap0 = min(4 * b, n + 1)
    (cand0,) = jnp.nonzero(mark[:n], size=cap0, fill_value=n)
    cand0 = cand0.astype(jnp.int32)
    # corrections need the OLD window buffer (reverse-mode row sums), so
    # they run before any mutation
    state, w = apply_edge_batch(state, kg.window, new_src, new_dst, old_src, old_dst, cfg)
    # kill expiring edges in the snapshot (their slots are snapshot-era:
    # the driver asserts rebuild_every * slide <= window) — in BOTH views:
    # the gather-sorted CSR masks by nbr == phantom, the delivery-sorted
    # view by d_gat == phantom (whose moving row is zero)
    kill_pos = kg.snap_pos[slots]
    nbr = kg.nbr.at[kill_pos].set(n)
    d_gat = kg.d_gat.at[kg.d_pos[slots]].set(n)
    # recycle the ring slots with the fresh batch
    w = w.replace(
        src=w.src.at[slots].set(new_src),
        dst=w.dst.at[slots].set(new_dst),
    )
    # append fresh edges to the ring + incremental per-row counts
    new_gat = new_src if state.mode == FORWARD else new_dst
    new_sca = new_dst if state.mode == FORWARD else new_src
    kg = kg.replace(
        window=w,
        nbr=nbr,
        d_gat=d_gat,
        fr_gat=jax.lax.dynamic_update_slice(kg.fr_gat, new_gat, (fcnt,)),
        fr_sca=jax.lax.dynamic_update_slice(kg.fr_sca, new_sca, (fcnt,)),
        f_len=kg.f_len.at[new_gat].add(1).at[n].set(0),
    )
    kg = refresh_fresh_csr(kg)
    state, stats = push_to_convergence_wl2(
        state, kg, cfg, cand0, c0n, True, tiers
    )
    return state, kg, stats


@functools.partial(jax.jit, static_argnames=("mode", "fring"), donate_argnums=(0,))
def _rebuild_kill_jit(kg: KillGraph, mode: int, fring: int) -> KillGraph:
    return build_kill_graph(kg.window, mode, fring)


@functools.partial(
    jax.jit, static_argnames=("cfg", "tiers"), donate_argnums=(0,)
)
def _seed_wl2_jit(state, kg, cand0, c0n, cfg, tiers):
    return push_to_convergence_wl2(state, kg, cfg, cand0, c0n, True, tiers)


@functools.partial(
    jax.jit, static_argnames=("cfg", "tiers"), donate_argnums=(0,)
)
def _refine_wl2_jit(state, kg, cfg, tiers):
    # c0ok=False forces the first round to be a dense scan, which reseeds
    # the candidate list exactly for the tighter threshold
    cand0 = jnp.full(8, kg.n, jnp.int32)
    return push_to_convergence_wl2(
        state, kg, cfg, cand0, jnp.zeros((), jnp.int32), False, tiers
    )


class FastStreamDriver:
    """Sliding-window stream driver on the wl2 compact-frontier engine."""

    def __init__(
        self,
        stream_src: np.ndarray,
        stream_dst: np.ndarray,
        n: int,
        queries,
        cfg: PprConfig,
        scfg: StreamConfig,
        mode: int = FORWARD,
        dtype=jnp.float32,
        rebuild_every: int = 8,
        e_top: int | None = None,
        n_tiers: int = 5,
    ):
        if stream_src.shape[0] < scfg.window:
            raise ValueError("stream shorter than one window")
        if rebuild_every * scfg.slide > scfg.window:
            raise ValueError(
                "rebuild_every * slide must be <= window (fresh edges must "
                f"not expire between rebuilds): {rebuild_every} * {scfg.slide}"
                f" > {scfg.window}"
            )
        self.stream_src = np.asarray(stream_src, dtype=np.int32)
        self.stream_dst = np.asarray(stream_dst, dtype=np.int32)
        self.n = n
        self.cfg = cfg
        self.scfg = scfg
        self.mode = mode
        w = scfg.window
        b = scfg.slide
        window = WindowGraph.from_coo(
            self.stream_src[:w], self.stream_dst[:w], n, capacity=w
        )
        self.fring = b * rebuild_every
        self.graph = jax.jit(
            build_kill_graph, static_argnames=("mode", "fring")
        )(window, mode=mode, fring=self.fring)
        self.state = init_state(n, queries, mode=mode, dtype=dtype)
        # edge-lane tier top: big post-slide frontiers fall to the
        # delivery-sorted dense scan rather than run top-tier worklist
        # rounds, whose residual scatter is unsorted. Sub-128 source batches
        # cross over to the scan at a lower frontier size. Both defaults were
        # tuned on the previous accelerator and await a retune on the GPU.
        if e_top is not None:
            self.e_top = e_top
        elif self.state.p.shape[1] % 128:
            self.e_top = min(max(2 * b, 40_960), 262_144, w // 2)
        else:
            self.e_top = min(max(8 * b, 65_536), 262_144, w // 2)
        self.tiers = make_tiers2(n, w, self.fring, self.e_top, n_tiers=n_tiers)
        self.rebuild_every = rebuild_every
        self.fcnt = 0
        self.head = w
        self.step_idx = 0
        # host mirror of the ring (old-batch values + candidate seeds come
        # from here — vectorized, no device->host reads on the hot path)
        self.hsrc = self.stream_src[:w].copy()
        self.hdst = self.stream_dst[:w].copy()
        self.cap0 = 4 * b
        self._dev = jax.devices()[0]
        self._queries = list(queries)

    def seed(self) -> PushStats:
        q = np.unique(np.asarray(self._queries, np.int32))
        cand0 = np.full(max(q.size, 8), self.n, np.int32)
        cand0[: q.size] = q
        self.state, stats = _seed_wl2_jit(
            self.state,
            self.graph,
            jnp.asarray(cand0),
            jnp.asarray(q.size, jnp.int32),
            cfg=self.cfg,
            tiers=self.tiers,
        )
        return stats

    def refine(self, eps: float, rounds: int | None = None) -> PushStats:
        """Push the CURRENT state to a tighter threshold (retrieval-time
        refinement). The push invariant is preserved
        — refinement only moves more residual mass into the reserve — so the
        stream can continue from the refined state; maintenance stays at
        cfg.eps while retrieval reads an eps-refined reserve. The top-k tail
        scores shrink like O(1/N) at fixed query mass while push error stays
        O(eps), so large-N retrieval needs eps_retrieve < eps_maintain to
        hold precision@k.

        rounds bounds the refinement to that many push rounds (round-4
        verdict item 5: bounded-stall serving). An interrupted refinement
        is safe at any point — every round preserves the invariant, and the
        next slide's maintenance push restores cfg.eps freshness — so a
        small per-slide budget spreads the refine cost across the stream
        instead of stalling it seconds per event; stats.rounds < rounds
        signals convergence to eps."""
        import dataclasses

        cfg_r = dataclasses.replace(
            self.cfg, eps=eps,
            max_rounds=self.cfg.max_rounds if rounds is None else rounds,
        )
        self.state, stats = _refine_wl2_jit(
            self.state, self.graph, cfg=cfg_r, tiers=self.tiers
        )
        return stats

    @property
    def steps_available(self) -> int:
        return (self.stream_src.shape[0] - self.head) // self.scfg.slide

    def run(self, n_steps: int | None = None) -> Iterator[PushStats]:
        b = self.scfg.slide
        w = self.scfg.window
        total = self.steps_available if n_steps is None else n_steps
        if not hasattr(self, "_dev"):  # checkpoint loads bypass __init__
            self._dev = jax.devices()[0]
        for _ in range(total):
            if self.head + b > self.stream_src.shape[0]:
                return
            if self.fcnt + b > self.fring:
                self.graph = _rebuild_kill_jit(
                    self.graph, mode=self.mode, fring=self.fring
                )
                self.fcnt = 0
            slots = (np.arange(self.head, self.head + b) % w).astype(np.int32)
            new_src = self.stream_src[self.head : self.head + b]
            new_dst = self.stream_dst[self.head : self.head + b]
            # ONE packed transfer per slide; the expiring batch, the
            # scatter-endpoint sorts, and the candidate seed are derived on
            # device (see wl2_slide_step)
            pack = np.empty(2 * b + 8, np.int32)
            pack[:b] = new_src
            pack[b : 2 * b] = new_dst
            pack[2 * b :] = 0
            pack[2 * b] = self.head
            pack[2 * b + 1] = self.fcnt
            self.state, self.graph, stats = wl2_slide_step(
                self.state,
                self.graph,
                jax.device_put(pack, self._dev),
                cfg=self.cfg,
                tiers=self.tiers,
            )
            self.hsrc[slots] = new_src
            self.hdst[slots] = new_dst
            self.fcnt += b
            self.head += b
            self.step_idx += 1
            yield stats
