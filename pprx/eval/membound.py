"""Structural per-device memory introspection.

`max_float_temp_size` walks a function's jaxpr and reports the largest
float intermediate allocated inside any `shard_map` body — a compile-time
upper-bound proof of a program's per-device live-array footprint, used by
the wlp memory-budget tests (tests/test_dist_wlp.py) and the wl-vs-wlp
crossover demonstration (scripts/wlp_crossover.py). The reference has no
counterpart (single-GPU C++/CUDA artifact; memory accounting was manual);
the jaxpr is the allocation plan before XLA, so the bound is derivable
without running anything.
"""

from __future__ import annotations

import jax
import numpy as np


def max_float_temp_size(fn, *args) -> int:
    """Largest float intermediate (in ELEMENTS) anywhere in fn's jaxpr,
    recursing through pjit/shard_map/while/cond sub-jaxprs. Inside
    shard_map, shapes are PER-SHARD — exactly the per-device live-array
    budget we want to bound."""
    closed = jax.make_jaxpr(fn)(*args)
    biggest = 0

    def subjaxprs(eqn):
        for pval in eqn.params.values():
            for sub in jax.tree_util.tree_leaves(
                pval, is_leaf=lambda x: hasattr(x, "jaxpr") or hasattr(x, "eqns")
            ):
                if hasattr(sub, "eqns"):
                    yield sub
                elif hasattr(sub, "jaxpr"):
                    yield sub.jaxpr

    def measure(jaxpr):
        # inside shard_map: every aval is a PER-SHARD array
        nonlocal biggest
        for eqn in jaxpr.eqns:
            for v in eqn.outvars:
                aval = getattr(v, "aval", None)
                if aval is not None and getattr(aval, "dtype", None) is not None:
                    if np.issubdtype(aval.dtype, np.floating):
                        biggest = max(biggest, int(aval.size))
            for sub in subjaxprs(eqn):
                measure(sub)

    def find(jaxpr):
        for eqn in jaxpr.eqns:
            if "shard_map" in eqn.primitive.name:
                for sub in subjaxprs(eqn):
                    measure(sub)
            else:
                for sub in subjaxprs(eqn):
                    find(sub)

    find(closed.jaxpr)
    assert biggest > 0, "no shard_map body found in jaxpr"
    return biggest
