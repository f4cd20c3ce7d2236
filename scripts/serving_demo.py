"""ONE serving story: maintenance + refinement cadence + retrieval latency
+ precision measured in a single run (VERDICT round-3 item 4).

Round 3 measured precision 0.981 (refined state) and 8.9 ms latency
(unrefined state) in different universes. This script runs the headline
stream with a retrieval event every R slides; each event refines the
CURRENT state to eps_retrieve (the push invariant is preserved, the stream
continues from the refined state) and serves a top-100 batch from it.
Reported, all from the same run:

- steady updates/s INCLUDING the amortized refine cost,
- per-event refine cost and per-batch retrieval latency,
- tie-aware recall@100 and boundary-tie precision@100 vs exact PPR on the
  final window (sampled queries).

Usage: python scripts/serving_demo.py [R ...]   (default R=8)

Round 5 adds the BOUNDED-STALL mode (round-4 verdict item 5): pass
`inc:BUDGET[:R]` to spread the eps_retrieve refinement across the stream —
every slide runs maintenance plus a refine chunk capped at BUDGET push
rounds (invariant-preserving at any interruption point; the next slide's
maintenance restores eps freshness), so retrieval events serve the CURRENT
state with no multi-second refine stall. Reports worst per-slide wall (the
stall metric), throughput including the refine budget, retrieval latency,
and >=16-query accuracy sampling.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pprx.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from pprx.config import PprConfig, StreamConfig
from pprx.graph.fast_stream import FastStreamDriver
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.retrieve.topk import topk_candidates

N, W, B, S = 200_000, 2_000_000, 160_000, 128
EPS_R = 5e-8
K = 100
STEPS = 16  # slides in the timed region

ARGS = sys.argv[1:] or ["8"]
Rs = [int(a) for a in ARGS if not a.startswith("inc")]
INCS = []  # (budget_rounds, serve_every_R)
for a in ARGS:
    if a.startswith("inc"):
        parts = a.split(":")
        INCS.append((int(parts[1]) if len(parts) > 1 else 8,
                     int(parts[2]) if len(parts) > 2 else 4))

cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
scfg = StreamConfig(window=W, slide=B)
rebuild_every = max(1, min(8, W // (6 * B)))
warm = rebuild_every + 2
src, dst, _ = synthetic_powerlaw_stream(N, W + (2 * STEPS + warm + 4) * B, seed=7)
queries = list(range(S))

for R in Rs:
    drv = FastStreamDriver(src, dst, N, queries, cfg, scfg,
                           rebuild_every=rebuild_every)
    drv.seed()
    for _ in drv.run(warm):
        pass
    # warm the refine + retrieval programs (compile outside the timed region)
    drv.refine(EPS_R)
    scores, ids = topk_candidates(drv.state.p, k=K)
    jax.block_until_ready(ids)

    t0 = time.perf_counter()
    refine_ms = []
    retrieve_ms = []
    done = 0
    while done < STEPS:
        chunk = min(R, STEPS - done)
        for _ in drv.run(chunk):
            pass
        done += chunk
        t1 = time.perf_counter()
        drv.refine(EPS_R)
        jax.block_until_ready(drv.state.r)
        t2 = time.perf_counter()
        # pipelined batch reads (the config-4 latency protocol)
        REPS_Q = 10
        for _ in range(REPS_Q):
            scores, ids = topk_candidates(drv.state.p, k=K)
        jax.block_until_ready(ids)
        t3 = time.perf_counter()
        refine_ms.append((t2 - t1) * 1e3)
        retrieve_ms.append((t3 - t2) * 1e3 / REPS_Q)
    jax.block_until_ready(drv.state.r)
    wall = time.perf_counter() - t0
    ups = 2 * B * STEPS / wall

    # accuracy from THIS run's final refined state
    from pprx.eval.metrics import precision_at_k, recall_at_k_ties
    from pprx.ref.exact import exact_ppr

    p = np.asarray(drv.state.p)
    ids_h = np.asarray(ids)
    precs, recs = [], []
    for si in np.linspace(0, S - 1, 16).astype(int):
        pi = exact_ppr(np.asarray(drv.hsrc), np.asarray(drv.hdst), N,
                       queries[si], cfg.alpha, tol=1e-10)
        pred = np.argsort(-p[:N, si], kind="stable")[:K]
        precs.append(precision_at_k(pred, pi, K))
        recs.append(recall_at_k_ties(ids_h[si], pi, K))
    out = {
        "mode": "serving_demo",
        "refine_every_slides": R,
        "steps": STEPS,
        "updates_per_sec_incl_refine": round(ups, 1),
        "refine_ms_mean": round(float(np.mean(refine_ms)), 1),
        "retrieval_ms_batch": round(float(np.mean(retrieve_ms)), 2),
        "retrieval_ms_min": round(float(np.min(retrieve_ms)), 2),
        "top100_precision": round(float(np.mean(precs)), 4),
        "top100_recall_ties": round(float(np.mean(recs)), 4),
        "eps_maintain": cfg.eps,
        "eps_retrieve": EPS_R,
        "batch": S,
    }
    print(json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# Bounded-stall incremental mode (round-4 verdict item 5)
# ---------------------------------------------------------------------------
for (RB, R) in INCS:
    drv = FastStreamDriver(src, dst, N, queries, cfg, scfg,
                           rebuild_every=rebuild_every)
    drv.seed()
    for _ in drv.run(warm):
        pass
    # converge the state to EPS_R once (outside the timed region: a cold
    # start pays this as ramp-up; steady serving never re-pays it), and
    # compile the budgeted-refine + retrieval programs
    drv.refine(EPS_R)
    drv.refine(EPS_R, rounds=RB)
    scores, ids = topk_candidates(drv.state.p, k=K)
    jax.block_until_ready(ids)

    # region A: pipelined throughput (sync only at the end — the per-slide
    # protocol below waits for the device every slide)
    t0 = time.perf_counter()
    budget_rounds = []
    retrieve_ms = []
    for i in range(STEPS):
        for _ in drv.run(1):
            pass
        stf = drv.refine(EPS_R, rounds=RB)
        budget_rounds.append(stf)
        if (i + 1) % R == 0:
            # drain the queued slide+refine before timing the reads, or the
            # first read absorbs the whole pipeline
            jax.block_until_ready(drv.state.r)
            REPS_Q = 10
            t2 = time.perf_counter()
            for _ in range(REPS_Q):
                scores, ids = topk_candidates(drv.state.p, k=K)
            jax.block_until_ready(ids)
            retrieve_ms.append((time.perf_counter() - t2) * 1e3 / REPS_Q)
    jax.block_until_ready(drv.state.r)
    wall = time.perf_counter() - t0
    ups = 2 * B * STEPS / wall
    rounds_used = [int(s.rounds) for s in budget_rounds]

    # region B: per-slide walls (the stall metric; one device wait per
    # slide)
    slide_ms = []
    for i in range(STEPS):
        t1 = time.perf_counter()
        for _ in drv.run(1):
            pass
        drv.refine(EPS_R, rounds=RB)
        jax.block_until_ready(drv.state.r)
        slide_ms.append((time.perf_counter() - t1) * 1e3)

    from pprx.eval.metrics import precision_at_k, recall_at_k_ties
    from pprx.ref.exact import exact_ppr

    p = np.asarray(drv.state.p)
    scores, ids_f = topk_candidates(drv.state.p, k=K)
    ids_f = np.asarray(ids_f)
    precs, recs = [], []
    for si in np.linspace(0, S - 1, 16).astype(int):
        pi = exact_ppr(np.asarray(drv.hsrc), np.asarray(drv.hdst), N,
                       queries[si], cfg.alpha, tol=1e-10)
        pred = np.argsort(-p[:N, si], kind="stable")[:K]
        precs.append(precision_at_k(pred, pi, K))
        recs.append(recall_at_k_ties(ids_f[si], pi, K))
    out = {
        "mode": "serving_demo_incremental",
        "refine_budget_rounds": RB,
        "serve_every_slides": R,
        "steps": STEPS,
        "updates_per_sec_incl_refine": round(ups, 1),
        "slide_ms_worst": round(float(np.max(slide_ms)), 1),
        "slide_ms_mean": round(float(np.mean(slide_ms)), 1),
        "refine_rounds_used_mean": round(float(np.mean(rounds_used)), 1),
        "refine_rounds_budget_hit": int(sum(r >= RB for r in rounds_used)),
        "retrieval_ms_batch": round(float(np.mean(retrieve_ms)), 2),
        "top100_precision": round(float(np.mean(precs)), 4),
        "top100_recall_ties": round(float(np.mean(recs)), 4),
        "eps_maintain": cfg.eps,
        "eps_retrieve": EPS_R,
        "batch": S,
        "queries_sampled": 16,
    }
    print(json.dumps(out), flush=True)
