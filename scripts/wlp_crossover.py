"""The wlp crossover: a measured configuration where the memory-
proportional engine is the RIGHT choice (round-4 verdict item 4).

Round 4 derived wlp's regime ("use wlp when [n_pad, S] exceeds one
device") but never showed it winning. This script constructs the
crossover on the virtual CPU mesh:

1. Pick shapes + a stated per-device float budget such that the classic
   wl engine's push program PROVABLY exceeds the budget (its carry outbox
   and dense-flush reduce-scatter buffers are [n_pad, S] PER DEVICE — they
   grow with TOTAL N and do not shrink with K), while the wlp program's
   largest per-shard float temp fits.
2. Prove both statements structurally with the jaxpr walker
   (pprx.eval.membound.max_float_temp_size) — the same bound the test
   suite enforces.
3. Run the SAME sliding stream on both engines and measure throughput.
   Under the budget, the wl row is DISQUALIFIED (it only runs here
   because the CPU host happens to have the memory); wlp's number is the
   only admissible one. Absolute CPU throughput is not chip throughput —
   the datum is that wlp completes the identical workload inside a budget
   wl cannot fit, at a comparable (same-order) rate.
4. Print the projected device-memory crossover at S=128 on an 80 GB H100.

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
           python scripts/wlp_crossover.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from pprx.config import PprConfig, StreamConfig
from pprx.dist.mesh import make_row_mesh
from pprx.dist.stream import ShardedStreamDriver
from pprx.eval.membound import max_float_temp_size
from pprx.graph.io import synthetic_powerlaw_stream

# shapes: N >> W/K so the classic engine's [n_pad, S] carry/psum term
# dominates every per-shard-window term; ecap is sized PER SHARD (2x the
# balanced share — the driver's window-sized default gives EVERY engine a
# window-sized [L, S] delivery temp and hides the scaling difference,
# which is exactly what the first version of this script measured)
N, S, K = 2_097_152, 32, 8
W, B = 1_000_000, 32_768
ECAP = 2 * (W // 8)
STEPS = 4
BUDGET_MB = 128.0  # stated per-device float budget for this demonstration

cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
scfg = StreamConfig(window=W, slide=B)
mesh = make_row_mesh(K, 1)
src, dst, _ = synthetic_powerlaw_stream(N, W + (STEPS + 3) * B, seed=9)
queries = list(range(S))


def probe(engine):
    drv = ShardedStreamDriver(
        src, dst, N, queries, cfg, scfg, mesh, engine=engine,
        dtype=jnp.float32, ecap=ECAP,
    )
    eng = drv.eng
    cand0 = jax.device_put(
        jnp.full(eng.n_rows * eng.wcarry, eng.n_local, jnp.int32),
        jax.sharding.NamedSharding(eng.mesh, eng.row_spec),
    )
    biggest = max_float_temp_size(
        lambda *a: eng._wl_push(*a), drv.p, drv.r, drv.deg, drv.snap,
        cand0, jnp.zeros((), jnp.int32),
    )
    mb = biggest * 4 / 1e6
    fits = mb <= BUDGET_MB
    print(
        f"[{engine}] biggest per-device float temp: {biggest:,} elements "
        f"= {mb:.1f} MB f32 -> {'FITS' if fits else 'EXCEEDS'} the "
        f"{BUDGET_MB:.0f} MB budget",
        flush=True,
    )
    # throughput on the identical stream (CPU wall; same-host caveat above)
    drv.seed()
    for _ in drv.run(2):  # warm
        pass
    jax.block_until_ready(drv.p)
    t0 = time.perf_counter()
    k = 0
    for st in drv.run(STEPS):
        k += 1
    jax.block_until_ready(drv.p)
    wall = time.perf_counter() - t0
    ups = 2 * B * k / wall
    print(f"[{engine}] {ups:,.0f} updates/s on the CPU mesh "
          f"(rounds last slide: {st['rounds']})", flush=True)
    return {"engine": engine, "temp_mb": round(mb, 1), "fits_budget": fits,
            "updates_per_sec_cpu": round(ups, 1)}


rows = [probe("wl"), probe("wlp")]
full_state_mb = (N + K) * S * 4 / 1e6  # n_pad ~ N

# device-memory projection at S=128 on an 80 GB H100, of which a JAX
# process takes 60 GB by default (leave 8 GB for program + window
# buffers): the wl push program keeps ~2 [n_pad, S] f32 buffers live per
# device (carry outbox + the psum_scatter operand), so its ceiling is
# N* ~ 52 GB / (2 * 128 * 4 B); wlp's per-device floats are
# O(n_local * S + L * S) and shrink 1/K, so the same card runs K times
# further.
n_star = 52e9 / (2 * 128 * 4)  # two live [n_pad, S] f32 buffers
out = {
    "mode": "wlp_crossover",
    "budget_mb": BUDGET_MB,
    "n": N, "s": S, "k": K, "window": W, "slide": B,
    "full_state_mb": round(full_state_mb, 1),
    "rows": rows,
    "hbm_crossover_projection": {
        "assumed_device_budget_gb": 52,
        "s": 128,
        "wl_live_npad_buffers": 2,
        "n_star_wl_ceiling": int(n_star),
        "note": "beyond N* the classic wl engine cannot allocate its "
                "[n_pad, S] carry/reduce-scatter buffers at ANY K; wlp's "
                "per-device floats shrink 1/K, so N scales with the cards",
    },
}
print(json.dumps(out), flush=True)
