"""Config-4 retrieval-head latency on the GPU: the exact two-stage top-k
across chunk sizes, and a direct single-stage lax.top_k. Shapes: N=500k,
E=5M, S=512 sources, k=100."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from pprx.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from pprx.config import PprConfig
from pprx.engine.push import push_to_convergence
from pprx.engine.state import FORWARD, init_state
from pprx.graph.dynamic import WindowGraph
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.retrieve.topk import topk_candidates

n, m, s, k = 500_000, 5_000_000, 512, 100
src, dst, _ = synthetic_powerlaw_stream(n, m, seed=4)
cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
rng = np.random.default_rng(0)
queries = rng.integers(0, n, size=s).tolist()
graph = WindowGraph.from_coo(src, dst, n)
state = init_state(n, queries, mode=FORWARD)
t0 = time.perf_counter()
state, stats = jax.jit(push_to_convergence, static_argnames=("cfg",))(
    state, graph, cfg=cfg
)
jax.block_until_ready(state.p)
print(f"cold push: {time.perf_counter()-t0:.1f}s, {int(stats.rounds)} rounds", flush=True)


def lat(reps=20, **kw):
    scores, ids = topk_candidates(state.p, k=k, **kw)
    jax.block_until_ready(ids)
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            scores, ids = topk_candidates(state.p, k=k, **kw)
        jax.block_until_ready(ids)
        ms = (time.perf_counter() - t0) / reps * 1e3
        best = ms if best is None else min(best, ms)
    return best, ids


ms, _ = lat(chunk=1 << 20)  # chunk >= N/2: one direct lax.top_k
print(f"direct lax.top_k: {ms:.2f} ms", flush=True)
for chunk in (2048, 4096, 8192, 16384, 32768):
    ms, _ = lat(chunk=chunk)
    print(f"exact two-stage chunk={chunk}: {ms:.2f} ms", flush=True)
