"""Profile steady-state slides of the headline bench config and aggregate
device-time by op. The trace is written under <repo>/.traces/slide (or
AB_TRACE_DIR)."""

import glob
import gzip
import json
import os
import shutil
import sys
from collections import defaultdict

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
RE = int(os.environ.get("AB_RE", 2))
PROF_STEPS = 2

cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
scfg = StreamConfig(window=W, slide=B)
warm = RE + 2
src, dst, _ = synthetic_powerlaw_stream(N, W + (warm + PROF_STEPS + 3) * B, seed=7)
drv = FastStreamDriver(src, dst, N, list(range(S)), cfg, scfg, mode=0,
                       rebuild_every=RE)
drv.seed()
for _ in drv.run(warm):
    pass
jax.block_until_ready(drv.state.r)

outdir = os.environ.get("AB_TRACE_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".traces", "slide"
)
shutil.rmtree(outdir, ignore_errors=True)
with jax.profiler.trace(outdir, create_perfetto_trace=True):
    for _ in drv.run(PROF_STEPS):
        pass
    jax.block_until_ready(drv.state.r)

# aggregate traceEvents by op name
files = glob.glob(f"{outdir}/**/*.trace.json.gz", recursive=True)
agg = defaultdict(float)
cnt = defaultdict(int)
total = 0.0
for f in files:
    with gzip.open(f, "rt") as fh:
        data = json.load(fh)
    for ev in data.get("traceEvents", []):
        # NOTE: aggregates every complete event from every pid (host +
        # device); read the [pid] column to tell them apart
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        dur = ev.get("dur", 0) / 1e3  # ms
        agg[(ev.get("pid"), name)] += dur
        cnt[(ev.get("pid"), name)] += 1

# identify device pids by looking for XLA op-like names
rows = sorted(agg.items(), key=lambda kv: -kv[1])
print(f"{'ms':>10} {'count':>7}  name")
for (pid, name), ms in rows[:60]:
    print(f"{ms:10.2f} {cnt[(pid,name)]:7d}  [{pid}] {name[:110]}")
