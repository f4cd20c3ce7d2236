"""Round-4 A/B: sharded wl engine at mesh 1x1, headline shapes — isolate
the fresh-ring size lever (the sharded driver's default fring=8*b makes
every dense-flush round sweep a 1.28M-lane mostly-dead fresh view, while
the single-chip bench runs at fring=2*b) before the code fixes land.

Interleaved same-process runs, best-of-2 per variant.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pprx.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from pprx.bench.run import run_config

VARIANTS = {
    "fring_default": dict(),
    "fring_2b": dict(fring=320_000),
}

results = {k: [] for k in VARIANTS}
for rep in range(2):
    for name, kw in VARIANTS.items():
        out = run_config(5, n_rows=1, n_srcs=1, engine="wl", steps=5, **kw)
        results[name].append(out["updates_per_sec"])
        print(f"[rep {rep}] {name}: {out['updates_per_sec']:.0f} u/s "
              f"(rounds={out['rounds']}, wl={out['wl_rounds']})", flush=True)

for name, vals in results.items():
    print(f"[best] {name}: {max(vals):.0f} updates/s", flush=True)
