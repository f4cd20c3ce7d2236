"""Measure top-100 precision vs exact PPR at the headline bench config as a
function of retrieval-time refinement eps (VERDICT round-2 item 3).

Reproduces the judge's scale-decay observation (precision at eps=1e-6 decays
with N because top-k tail scores shrink while push error stays O(eps)) and
calibrates the eps_retrieve policy: refine from the maintained state, so
each tightening step only pays the incremental push work.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from pprx.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from pprx.config import PprConfig, StreamConfig
from pprx.eval.metrics import precision_at_k
from pprx.graph.fast_stream import FastStreamDriver
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.ref.exact import exact_ppr

N = int(os.environ.get("PS_N", 200_000))
W = int(os.environ.get("PS_W", 2_000_000))
B = int(os.environ.get("PS_B", 160_000))
S = int(os.environ.get("PS_S", 128))
STEPS = int(os.environ.get("PS_STEPS", 4))
NQ = int(os.environ.get("PS_NQ", 16))
K = 100

cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
scfg = StreamConfig(window=W, slide=B)
re = max(1, min(8, W // (6 * B)))
warm = re + 2
src, dst, _ = synthetic_powerlaw_stream(N, W + (STEPS + warm + 1) * B, seed=7)
queries = list(range(S))
drv = FastStreamDriver(src, dst, N, queries, cfg, scfg, mode=0, rebuild_every=re)
drv.seed()
for _ in drv.run(warm + STEPS):
    pass
jax.block_until_ready(drv.state.r)

w = scfg.window
wsrc = drv.hsrc
wdst = drv.hdst
qidx = np.linspace(0, S - 1, NQ).astype(int)
print(f"computing exact PPR for {NQ} queries at N={N}, W={W} ...", flush=True)
t0 = time.perf_counter()
exact = {}
for si in qidx:
    exact[si] = exact_ppr(wsrc, wdst, N, queries[si], cfg.alpha, tol=1e-10)
print(f"exact done in {time.perf_counter()-t0:.1f}s", flush=True)


def prec():
    p = np.asarray(drv.state.p)
    vals = []
    for si in qidx:
        pred = np.argsort(-p[:N, si], kind="stable")[:K]
        vals.append(precision_at_k(pred, exact[si], K))
    return float(np.mean(vals)), float(np.min(vals))


m, lo = prec()
print(f"eps=1e-6 (maintained): precision mean={m:.4f} min={lo:.4f}", flush=True)
for eps_r in (5e-7, 2e-7, 1e-7, 5e-8, 2e-8):
    t0 = time.perf_counter()
    stats = drv.refine(eps_r)
    jax.block_until_ready(drv.state.r)
    dt = (time.perf_counter() - t0) * 1e3
    m, lo = prec()
    print(
        f"refine to eps={eps_r:.0e}: {dt:8.1f} ms ({int(stats.rounds)} rounds,"
        f" wl={int(stats.wl_rounds)})  precision mean={m:.4f} min={lo:.4f}",
        flush=True,
    )
