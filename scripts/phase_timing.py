"""Phase-level device timing of the headline slide: times the jitted
sub-programs standalone, each ended by block_until_ready."""

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
from pprx.engine.push import _active_mask
from pprx.engine.state import PprState
from pprx.engine.update import apply_edge_batch
from pprx.engine.wl2 import build_kill_graph, dense_round_sorted, refresh_fresh_csr
from pprx.graph.fast_stream import FastStreamDriver
from pprx.graph.io import synthetic_powerlaw_stream

N, W, B, S = 200_000, 2_000_000, 160_000, 128
RE = 2
cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
scfg = StreamConfig(window=W, slide=B)
warm = RE + 2
src, dst, _ = synthetic_powerlaw_stream(N, W + (warm + 10) * B, seed=7)
drv = FastStreamDriver(src, dst, N, list(range(S)), cfg, scfg, mode=0,
                       rebuild_every=RE)
drv.seed()
for _ in drv.run(warm):
    pass
jax.block_until_ready(drv.state.r)
print("tiers:", drv.tiers, flush=True)


def timeit(f, *a, reps=8, **kw):
    out = f(*a, **kw)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*a, **kw)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    return (time.perf_counter() - t0) / reps * 1e3


# 1. full slide (reference): time 4 slides
t0 = time.perf_counter()
stats = list(drv.run(4))
jax.block_until_ready(drv.state.r)
full_ms = (time.perf_counter() - t0) / 4 * 1e3
rounds = sum(int(s.rounds) for s in stats) / 4
wl = sum(int(s.wl_rounds) for s in stats) / 4
print(f"full slide: {full_ms:.1f} ms ({rounds:.1f} rounds, {wl:.1f} wl)", flush=True)

kg = drv.graph
state = drv.state

# 2. rebuild (non-donating standalone)
reb = jax.jit(build_kill_graph, static_argnames=("mode", "fring"))
ms = timeit(reb, kg.window, 0, drv.fring, reps=4)
print(f"rebuild_kill_graph: {ms:.1f} ms (amortized /{RE} slides = {ms/RE:.1f})", flush=True)

# 3. corrections standalone (realistic batch)
head = drv.head
b = B
slots = (np.arange(head, head + b) % W).astype(np.int32)
new_src = drv.stream_src[head : head + b]
new_dst = drv.stream_dst[head : head + b]
old_src = drv.hsrc[slots]
old_dst = drv.hdst[slots]
corr = jax.jit(apply_edge_batch, static_argnames=("cfg",))
ms = timeit(corr, state, kg.window, jnp.asarray(new_src), jnp.asarray(new_dst),
            jnp.asarray(old_src), jnp.asarray(old_dst), cfg=cfg)
print(f"apply_edge_batch (b={b}): {ms:.1f} ms", flush=True)

# 4. refresh_fresh_csr standalone
ms = timeit(jax.jit(refresh_fresh_csr), kg)
print(f"refresh_fresh_csr (fring={drv.fring}): {ms:.1f} ms", flush=True)

# 5. one dense round
dr = jax.jit(dense_round_sorted, static_argnames=("cfg",))
ms = timeit(dr, state, kg, cfg)
print(f"dense_round_sorted: {ms:.1f} ms", flush=True)

# 6. active-mask scan alone (the per-round [N,S] pass)
am = jax.jit(lambda st: jnp.any(_active_mask(st, kg.window, cfg)[:N], axis=1))
ms = timeit(am, state)
print(f"active_mask any: {ms:.2f} ms", flush=True)

# 7. no-op push (converged state): loop overhead floor
from pprx.graph.fast_stream import _refine_wl2_jit
ms = timeit(lambda: _refine_wl2_jit(
    PprState(p=state.p, r=state.r, mode=state.mode), kg, cfg=cfg,
    tiers=drv.tiers), reps=4)
print(f"push-to-convergence on converged state (1 scan round): {ms:.1f} ms", flush=True)
