"""Interleaved same-process A/B of the headline stream bench (bench.py
shapes: N=200k, W=2M, b=160k, S=128) across FastStreamDriver settings —
by default rebuild_every 2 (what bench.py derives at b=160k) vs 8 (the
driver default).

Protocol: one process, every variant run twice interleaved, first pass
discarded (compile/cache warm), timing ended by block_until_ready. Drivers
are rebuilt fresh per run and dropped after, to free device memory.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from pprx.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from pprx.config import PprConfig, StreamConfig
from pprx.graph.fast_stream import FastStreamDriver
from pprx.graph.io import synthetic_powerlaw_stream

N = int(os.environ.get("AB_N", 200_000))
W = int(os.environ.get("AB_W", 2_000_000))
B = int(os.environ.get("AB_B", 160_000))
S = int(os.environ.get("AB_S", 128))
STEPS = int(os.environ.get("AB_STEPS", 8))

import json

_default_variants = [
    ("re=2", dict(rebuild_every=2)),
    ("re=8", dict(rebuild_every=8)),
]
# override via AB_VARIANTS: JSON list of kwarg dicts for FastStreamDriver
_env = os.environ.get("AB_VARIANTS")
if _env:
    VARIANTS = [
        (" ".join(f"{k}={v}" for k, v in kw.items()), kw)
        for kw in json.loads(_env)
    ]
else:
    VARIANTS = _default_variants

cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
scfg = StreamConfig(window=W, slide=B)
max_warm = max(kw.get("rebuild_every", 8) for _, kw in VARIANTS) + 2
stream_len = W + (STEPS + max_warm + 1) * B
src, dst, _ = synthetic_powerlaw_stream(N, stream_len, seed=7)
queries = list(range(S))


def run_once(kw):
    drv = FastStreamDriver(src, dst, N, queries, cfg, scfg, mode=0,
                           dtype=jnp.float32, **kw)
    drv.seed()
    warm = kw.get("rebuild_every", 8) + 2
    for _ in drv.run(warm):
        pass
    jax.block_until_ready(drv.state.r)
    t0 = time.perf_counter()
    stats = list(drv.run(STEPS))
    jax.block_until_ready(drv.state.r)
    wall = time.perf_counter() - t0
    ups = 2 * B * len(stats) / wall
    rounds = sum(int(st.rounds) for st in stats)
    wl = sum(int(st.wl_rounds) for st in stats)
    del drv
    return ups, wall, rounds, wl


for pass_i in range(int(os.environ.get("AB_PASSES", 2))):
    for name, kw in VARIANTS:
        ups, wall, rounds, wl = run_once(kw)
        tag = "WARM" if pass_i == 0 else f"MEAS{pass_i}"
        print(f"[{tag}] {name}: {ups/1e3:8.1f}k updates/s  wall={wall:6.3f}s  "
              f"rounds={rounds} wl={wl}", flush=True)
