"""Record the sharded engines' throughput.

Mode A (one GPU, default): config-5 shapes = the single-chip headline
shapes, mesh 1x1 — isolates the sharding machinery's tax with no
collectives. Two runs per engine, best reported.

Mode B (SHARDED_SCALING=1, CPU): relative strong-scaling curve on the
virtual mesh, rows in {1, 2, 4, 8} at fixed problem size. Absolute CPU
numbers are meaningless; the curve shape is the datum.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCALING = os.environ.get("SHARDED_SCALING", "0") == "1"

import jax

from pprx.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
if SCALING:
    jax.config.update("jax_platforms", "cpu")

from pprx.bench.run import run_config

if not SCALING:
    for engine in os.environ.get("SHARDED_ENGINES", "wl,wlp").split(","):
        best = None
        for rep in range(2):
            out = run_config(5, n_rows=1, n_srcs=1, engine=engine, steps=5)
            tag = "warm" if rep == 0 else "meas"
            print(f"[{tag}] {engine}: {out}", flush=True)
            if best is None or out["updates_per_sec"] > best["updates_per_sec"]:
                best = out
        print(f"[best] {engine} mesh=1x1: {best['updates_per_sec']:.0f} updates/s "
              f"({best['updates_per_sec_per_chip']:.0f} per chip)", flush=True)
else:
    # CPU strong scaling: fixed problem, rows in {1,2,4,8}
    n, w, b, s = 50_000, 500_000, 20_000, 16
    for rows in (1, 2, 4, 8):
        out = run_config(5, n_rows=rows, n_srcs=1, engine="wl",
                         n=n, w=w, b=b, s=s, steps=4)
        print(f"rows={rows}: {out['updates_per_sec']:.0f} updates/s "
              f"(rounds={out['rounds']}, wl={out['wl_rounds']})", flush=True)
