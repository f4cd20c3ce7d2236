"""Sliding-window driver on the hybrid (snapshot+overlay) sparse engine.

Same contract as pprx.graph.stream.StreamDriver, but each slide's
push-to-convergence uses frontier-sparse rounds (pprx.engine.sparse) — the
steady-state frontier after a slide is tiny, so this is the fast path for
the headline updates/s workload. The CSR snapshot is re-sorted every
``rebuild_every`` slides (amortized O(W log W) on device); between rebuilds
the slide appends its 2b edge changes to the signed overlay.
"""

from __future__ import annotations

import functools
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from pprx.config import PprConfig, StreamConfig
from pprx.engine.sparse import (
    HybridGraph,
    _dedup_compact,
    make_tiers,
    push_to_convergence_hybrid,
    push_to_convergence_worklist,
    rebuild_snapshot,
)
from pprx.engine.state import FORWARD, PprState, PushStats, init_state
from pprx.engine.update import apply_edge_batch
from pprx.graph.dynamic import WindowGraph


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "fcap", "ecap", "scan_ecap", "tiers", "worklist"),
    donate_argnums=(0, 1),
)
def hybrid_slide_step(
    state: PprState,
    graph: HybridGraph,
    new_src: jnp.ndarray,
    new_dst: jnp.ndarray,
    slots: jnp.ndarray,
    ov_count: jnp.ndarray,
    cfg: PprConfig,
    fcap: int,
    ecap: int,
    scan_ecap: int = 0,
    tiers: tuple[tuple[int, int, int], ...] = (),
    worklist: bool = True,
) -> tuple[PprState, HybridGraph, PushStats]:
    # scan_ecap sizes only the worklist loop's scan-fallback rounds; the
    # non-worklist engine and seed() run at the tuned ecap (keeping their
    # compiled programs consistent — round-1 advisor low finding)
    if scan_ecap <= 0:
        scan_ecap = ecap
    w = graph.window
    old_src = w.src[slots]
    old_dst = w.dst[slots]
    state, w = apply_edge_batch(state, w, new_src, new_dst, old_src, old_dst, cfg)
    # overlay: expirations (-1) then insertions (+1) at [ov_count, ov_count+2b)
    b = new_src.shape[0]
    ov = graph.ov
    seg_src = jnp.concatenate([old_src, new_src])
    seg_dst = jnp.concatenate([old_dst, new_dst])
    seg_sign = jnp.concatenate(
        [jnp.full(b, -1, jnp.int32), jnp.full(b, 1, jnp.int32)]
    )
    ov = ov.replace(
        src=jax.lax.dynamic_update_slice(ov.src, seg_src, (ov_count,)),
        dst=jax.lax.dynamic_update_slice(ov.dst, seg_dst, (ov_count,)),
        sign=jax.lax.dynamic_update_slice(ov.sign, seg_sign, (ov_count,)),
    )
    w = w.replace(
        src=w.src.at[slots].set(new_src),
        dst=w.dst.at[slots].set(new_dst),
    )
    graph = graph.replace(window=w, ov=ov)
    if worklist:
        # corrections only inject mass at the 4b batch endpoints: they are
        # the complete initial candidate set for the worklist rounds
        wcap = tiers[-1][0]
        cand0_ids = jnp.concatenate([old_src, old_dst, new_src, new_dst])
        cand0, c0n = _dedup_compact(cand0_ids, wcap, graph.n)
        state, stats = push_to_convergence_worklist(
            state, graph, cfg, cand0, c0n <= wcap, tiers, fcap, scan_ecap
        )
    else:
        state, stats = push_to_convergence_hybrid(state, graph, cfg, fcap, ecap)
    return state, graph, stats


_rebuild_jit = jax.jit(rebuild_snapshot, static_argnames=("mode",))


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "tiers", "scan_fcap", "scan_ecap"),
    donate_argnums=(0,),
)
def _seed_worklist_jit(state, graph, cand0, cfg, tiers, scan_fcap, scan_ecap):
    return push_to_convergence_worklist(
        state, graph, cfg, cand0, False, tiers, scan_fcap, scan_ecap
    )


class HybridStreamDriver:
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
        rebuild_every: int = 4,
        fcap: int | None = None,
        ecap: int | None = None,
        worklist: bool = True,
        n_tiers: int = 3,
    ):
        if stream_src.shape[0] < scfg.window:
            raise ValueError("stream shorter than one window")
        self.stream_src = np.asarray(stream_src, dtype=np.int32)
        self.stream_dst = np.asarray(stream_dst, dtype=np.int32)
        self.n = n
        self.cfg = cfg
        self.scfg = scfg
        self.mode = mode
        w = scfg.window
        window = WindowGraph.from_coo(self.stream_src[:w], self.stream_dst[:w], n, capacity=w)
        overlay_cap = 2 * scfg.slide * rebuild_every
        self.graph = HybridGraph.build(window, mode, overlay_cap)
        self.state = init_state(n, queries, mode=mode, dtype=dtype)
        self.fcap = fcap if fcap is not None else n + 1
        # the post-slide frontier's snapshot edges scale with the batch times
        # average degree; 8x slide measured best on power-law streams (bigger
        # caps make every round pay for the worst round, smaller ones force
        # scan fallbacks)
        self.ecap = ecap if ecap is not None else min(max(8 * scfg.slide, 65_536), w)
        # scan rounds get a deeper top tier: a big-sparse round at 4x ecap
        # still beats the O(W*S) dense fallback it replaces, but past ~W/2
        # the adaptive "worth" test correctly prefers dense
        self.scan_ecap = min(4 * self.ecap, max(w // 2, self.ecap))
        self.worklist = worklist
        # candidate-list capacity: counts ROWS (frontier vertices), which
        # track ~4b after a slide — decoupled from the EDGE capacity ecap
        # (coupling them once blew worklist gathers up 4x).
        # Overflow just falls back to one scan round.
        self.wcap = max(4 * scfg.slide, 32_768)
        # live overlay entries per worklist round (overflow -> scan round)
        self.ovacap = max(4 * scfg.slide, 8192)
        # geometric capacity ladder: steady-state rounds run at the smallest
        # tier that (provably) fits their frontier — see make_tiers
        self.tiers = make_tiers(self.wcap, self.ecap, self.ovacap, n_tiers=n_tiers)
        self.rebuild_every = rebuild_every
        self.ov_count = 0
        self.head = w
        self.step_idx = 0

    def seed(self) -> PushStats:
        if self.worklist:
            cand0 = jnp.full(self.wcap, self.n, jnp.int32)
            self.state, stats = _seed_worklist_jit(
                self.state, self.graph, cand0,
                cfg=self.cfg, tiers=self.tiers,
                scan_fcap=self.fcap, scan_ecap=self.scan_ecap,
            )
        else:
            self.state, stats = jax.jit(
                push_to_convergence_hybrid,
                static_argnames=("cfg", "fcap", "ecap"),
                donate_argnums=(0,),
            )(self.state, self.graph, cfg=self.cfg, fcap=self.fcap, ecap=self.ecap)
        return stats

    @property
    def steps_available(self) -> int:
        return (self.stream_src.shape[0] - self.head) // self.scfg.slide

    def run(self, n_steps: int | None = None) -> Iterator[PushStats]:
        b = self.scfg.slide
        w = self.scfg.window
        total = self.steps_available if n_steps is None else n_steps
        for _ in range(total):
            if self.head + b > self.stream_src.shape[0]:
                return
            if self.ov_count + 2 * b > self.graph.ov.src.shape[0]:
                self.graph = _rebuild_jit(self.graph, mode=self.mode)
                self.ov_count = 0
            new_src = jnp.asarray(self.stream_src[self.head : self.head + b])
            new_dst = jnp.asarray(self.stream_dst[self.head : self.head + b])
            slots = jnp.asarray(
                (np.arange(self.head, self.head + b) % w).astype(np.int32)
            )
            self.state, self.graph, stats = hybrid_slide_step(
                self.state,
                self.graph,
                new_src,
                new_dst,
                slots,
                jnp.asarray(self.ov_count, jnp.int32),
                cfg=self.cfg,
                fcap=self.fcap,
                ecap=self.ecap,
                scan_ecap=self.scan_ecap,
                tiers=self.tiers,
                worklist=self.worklist,
            )
            self.ov_count += 2 * b
            self.head += b
            self.step_idx += 1
            yield stats
