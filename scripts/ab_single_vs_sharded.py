"""Interleaved same-process A/B: single-chip fast engine vs sharded wl at
mesh 1x1, identical headline shapes. The quantity of interest is the
RATIO of the two, so both run interleaved in one process.

Protocol: both drivers built once, streams seeded and warmed past their
first rebuild; then ROUNDS alternating blocks of STEPS slides each, each
ended by block_until_ready; per-engine best block reported plus the
per-round ratio (best sharded / best single within each adjacent pair).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pprx.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from pprx.config import PprConfig, StreamConfig
from pprx.dist.mesh import make_row_mesh
from pprx.dist.stream import ShardedStreamDriver
from pprx.graph.fast_stream import FastStreamDriver
from pprx.graph.io import synthetic_powerlaw_stream

N, W, B, S = 200_000, 2_000_000, 160_000, 128
STEPS = int(os.environ.get("AB_STEPS", 5))
ROUNDS = int(os.environ.get("AB_ROUNDS", 4))

cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
scfg = StreamConfig(window=W, slide=B)
total = W + (2 + 2 * ROUNDS * STEPS + 4) * B
src, dst, _ = synthetic_powerlaw_stream(N, total, seed=5)
queries = list(range(S))

single = FastStreamDriver(src, dst, N, queries, cfg, scfg, rebuild_every=2)
single.seed()
for _ in single.run(4):
    pass
jax.block_until_ready(single.state.p)

mesh = make_row_mesh(1, 1)
shard = ShardedStreamDriver(src, dst, N, queries, cfg, scfg, mesh, engine="wl")
shard.seed()
for _ in shard.run(4):
    pass
jax.block_until_ready(shard.p)

results = {"single": [], "sharded": []}
for rnd in range(ROUNDS):
    t0 = time.perf_counter()
    for st in single.run(STEPS):
        pass
    jax.block_until_ready(single.state.p)
    u1 = 2 * B * STEPS / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for st in shard.run(STEPS):
        pass
    jax.block_until_ready(shard.p)
    u2 = 2 * B * STEPS / (time.perf_counter() - t0)
    results["single"].append(round(u1))
    results["sharded"].append(round(u2))
    print(f"[round {rnd}] single {u1:,.0f}  sharded {u2:,.0f}  "
          f"ratio {u2 / u1:.3f}", flush=True)

best_s, best_h = max(results["single"]), max(results["sharded"])
pair = [h / s for s, h in zip(results["single"], results["sharded"])]
out = {
    "mode": "ab_single_vs_sharded",
    "steps_per_block": STEPS, "rounds": ROUNDS,
    "single_blocks": results["single"], "sharded_blocks": results["sharded"],
    "single_best": best_s, "sharded_best": best_h,
    "ratio_best": round(best_h / best_s, 3),
    "ratio_pairs": [round(x, 3) for x in pair],
    "ratio_pair_best": round(max(pair), 3),
    "ratio_pair_median": round(float(np.median(pair)), 3),
}
print(json.dumps(out), flush=True)
