"""The five [BASELINE] milestone configs as scripted runs (SURVEY.md §4
"Integration/bench" tier). The paper's datasets are unreachable offline, so
each config runs on a synthetic power-law stand-in at a scale the local
device can hold; pass ``scale`` to grow toward the real dataset sizes
(wiki-Vote ~100k edges, soc-LiveJournal ~69M, Twitter-2010 ~1.5B,
Friendster ~1.8B — the last two need several cards, SURVEY.md §6).

Each config returns a metrics dict (wall clocks, rounds, accuracy where an
exact oracle is tractable).
"""

from __future__ import annotations

import time

import numpy as np


def _stream(graph: str | None, n: int, need: int, seed: int):
    """Edge stream for a config: a packed ``.npz`` (pprx convert output /
    pprx.graph.io.save_packed) when ``graph`` is given, else the synthetic
    power-law stand-in. Real streams shorter than the config's window+slides
    are tiled cyclically (window semantics stay exact; edges repeat, as in
    any loop-driven soak run). Returns (src, dst, n)."""
    if graph is None:
        from pprx.graph.io import synthetic_powerlaw_stream

        src, dst, _ = synthetic_powerlaw_stream(n, need, seed=seed)
        return src, dst, n
    from pprx.graph.io import load_packed

    src, dst, n_real = load_packed(graph)
    if src.shape[0] < need:
        reps = -(-need // src.shape[0])
        src = np.tile(src, reps)[:need]
        dst = np.tile(dst, reps)[:need]
    return src[:need], dst[:need], n_real


def _exact_ok(src, dst, n, queries, p_host, alpha, eps, mode):
    from pprx.engine.state import FORWARD
    from pprx.eval.metrics import l1_error
    from pprx.ref.exact import exact_ppr_matrix

    M = exact_ppr_matrix(src, dst, n, alpha)
    errs = []
    for j, q in enumerate(queries):
        tgt = M[q] if mode == FORWARD else M[:, q]
        errs.append(l1_error(p_host[:n, j], tgt))
    return errs


def config1_static_forward(scale: int = 1, check_exact: bool = True,
                           graph: str | None = None) -> dict:
    """Single-source forward push on a static wiki-Vote-like graph (CPU-class
    scale), accuracy vs exact."""
    import jax
    import jax.numpy as jnp

    from pprx.config import PprConfig
    from pprx.engine.push import push_to_convergence
    from pprx.engine.state import FORWARD, init_state
    from pprx.graph.dynamic import WindowGraph
    from pprx.graph.io import synthetic_powerlaw_stream

    n, m = 1000 * scale, 100_000 * scale
    src, dst, n = _stream(graph, n, m, seed=1)
    m = src.shape[0]
    cfg = PprConfig(alpha=0.15, eps=1e-6)
    window = WindowGraph.from_coo(src, dst, n)
    queries = [0]
    state = init_state(n, queries, mode=FORWARD)
    t0 = time.perf_counter()
    state, stats = jax.jit(push_to_convergence, static_argnames=("cfg",))(
        state, window, cfg=cfg
    )
    jax.block_until_ready(state.p)
    out = {
        "config": 1,
        "n": n,
        "edges": m,
        "rounds": int(stats.rounds),
        "wall_s": round(time.perf_counter() - t0, 4),
        "l1_bound": cfg.eps * m,
    }
    if check_exact and n <= 4000:
        errs = _exact_ok(src, dst, n, queries, np.asarray(state.p), 0.15, 1e-6, FORWARD)
        out["l1_error"] = errs
        out["within_bound"] = all(e < out["l1_bound"] for e in errs)
    return out


def config2_sliding_window(scale: int = 1, graph: str | None = None,
                           w: int = 0, b: int = 0, steps: int = 10) -> dict:
    """Incremental PPR under sliding-window batches (soc-LiveJournal-like)."""
    import jax
    import jax.numpy as jnp

    from pprx.config import PprConfig, StreamConfig
    from pprx.eval.perf import summarize
    from pprx.graph.fast_stream import FastStreamDriver
    from pprx.graph.io import synthetic_powerlaw_stream

    n = 200_000 * scale
    w = w or 2_000_000 * scale
    b = b or 20_000 * scale
    rebuild_every = max(1, min(8, w // (6 * b)))
    warm = rebuild_every + 2  # past the first snapshot rebuild
    src, dst, n = _stream(graph, n, w + (steps + warm + 1) * b, seed=2)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    drv = FastStreamDriver(
        src, dst, n, list(range(16)), cfg, StreamConfig(window=w, slide=b),
        rebuild_every=rebuild_every,
    )
    drv.seed()
    for _ in drv.run(warm):
        pass
    jax.block_until_ready(drv.state.r)
    t0 = time.perf_counter()
    stats = list(drv.run(steps))
    jax.block_until_ready(drv.state.r)
    rep = summarize(stats, time.perf_counter() - t0, edges_per_step=2 * b)
    return {"config": 2, "n": n, "window": w, "slide": b, **rep.as_dict()}


def config3_reverse_dynamic(scale: int = 1, graph: str | None = None,
                            w: int = 0, b: int = 0, steps: int = 10,
                            s: int = 8) -> dict:
    """Reverse-push contribution vectors maintained under the stream.

    ``s`` co-batches that many reverse targets in one engine."""
    import jax

    from pprx.config import PprConfig, StreamConfig
    from pprx.engine.state import REVERSE
    from pprx.eval.perf import summarize
    from pprx.graph.fast_stream import FastStreamDriver
    from pprx.graph.io import synthetic_powerlaw_stream

    n = 100_000 * scale
    w = w or 1_000_000 * scale
    b = b or 10_000 * scale
    rebuild_every = max(1, min(8, w // (6 * b)))
    warm = rebuild_every + 2
    src, dst, n = _stream(graph, n, w + (steps + warm + 1) * b, seed=3)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    drv = FastStreamDriver(
        src, dst, n, list(range(s)), cfg, StreamConfig(window=w, slide=b), mode=REVERSE,
        rebuild_every=rebuild_every,
    )
    drv.seed()
    for _ in drv.run(warm):
        pass
    jax.block_until_ready(drv.state.r)
    t0 = time.perf_counter()
    stats = list(drv.run(steps))
    jax.block_until_ready(drv.state.r)
    rep = summarize(stats, time.perf_counter() - t0, edges_per_step=2 * b)
    return {"config": 3, "n": n, "window": w, "slide": b, "sources": s,
            **rep.as_dict()}


def config4_retrieval(scale: int = 1, s: int = 512, k: int = 100,
                      graph: str | None = None) -> dict:
    """Multi-source batched retrieval: S sources/launch, top-k, serving
    latency from MAINTAINED state (the engine's serving pattern — the push
    work happened incrementally during the stream)."""
    import jax
    import jax.numpy as jnp

    from pprx.config import PprConfig
    from pprx.engine.push import push_to_convergence
    from pprx.engine.state import FORWARD, init_state
    from pprx.graph.dynamic import WindowGraph
    from pprx.graph.io import synthetic_powerlaw_stream
    from pprx.retrieve.topk import topk_candidates

    n, m = 500_000 * scale, 5_000_000 * scale
    src, dst, n = _stream(graph, n, m, seed=4)
    m = src.shape[0]
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    rng = np.random.default_rng(0)
    queries = rng.integers(0, n, size=s).tolist()
    window = WindowGraph.from_coo(src, dst, n)
    state = init_state(n, queries, mode=FORWARD)
    t0 = time.perf_counter()
    state, stats = jax.jit(push_to_convergence, static_argnames=("cfg",))(
        state, window, cfg=cfg
    )
    jax.block_until_ready(state.p)
    cold_s = time.perf_counter() - t0

    # serving latency: top-k from maintained reserve
    def lat():
        jax.block_until_ready(topk_candidates(state.p, k=k))
        t0 = time.perf_counter()
        for _ in range(20):
            scores, ids = topk_candidates(state.p, k=k)
        jax.block_until_ready(ids)
        return (time.perf_counter() - t0) / 20 * 1e3

    return {
        "config": 4,
        "n": n,
        "edges": m,
        "batch": s,
        "k": k,
        "cold_push_s": round(cold_s, 3),
        "push_rounds": int(stats.rounds),
        "retrieval_ms": round(lat(), 3),
    }


def config5_sharded(
    n_rows: int = 0,
    n_srcs: int = 1,
    engine: str = "wl",
    n: int = 0,
    w: int = 0,
    b: int = 0,
    s: int = 0,
    steps: int = 5,
    graph: str | None = None,
    scale: int = 1,
    ccap: int = 0,
    e_top: int = 0,
    fring: int = 0,
    mode: str = "forward",
) -> dict:
    """Row-sharded slide step (runs on however many devices exist: the
    8-device CPU mesh in tests, the GPUs of a host). Default engine is
    the compact-frontier 'wl' path (bucketed a2a frontier exchange,
    SURVEY.md §3.5); 'wlp' is the memory-proportional variant, 'dense' the
    reduce-scatter baseline. Defaults are the HEADLINE shapes (same as
    bench.py) so a mesh-1x1 run on one GPU measures the sharding tax
    directly; pass small n/w/b/s overrides for CPU-mesh smoke runs."""
    import jax

    from pprx.config import PprConfig, StreamConfig
    from pprx.dist.mesh import make_row_mesh
    from pprx.dist.stream import ShardedStreamDriver
    from pprx.engine.state import FORWARD, REVERSE

    if n_rows == 0:
        n_rows = max(1, len(jax.devices()) // n_srcs)
    mesh = make_row_mesh(n_rows, n_srcs)
    n = n or 200_000 * scale
    w = w or 2_000_000 * scale
    b = b or 160_000 * scale
    s = s or 128
    src, dst, n = _stream(graph, n, w + (steps + 4) * b, seed=5)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    chips = n_rows * n_srcs
    # ccap/e_top tuning lives in ShardedWlEngine's defaults (round-3 sweep)
    drv = ShardedStreamDriver(
        src, dst, n, list(range(s)), cfg, StreamConfig(window=w, slide=b),
        mesh, engine=engine, ccap=ccap or None, e_top=e_top or None,
        fring=fring or None,
        mode=REVERSE if mode == "reverse" else FORWARD,
    )
    drv.seed()
    for _ in drv.run(3):
        pass
    jax.block_until_ready(drv.p)
    t0 = time.perf_counter()
    stats = list(drv.run(steps))
    jax.block_until_ready(drv.p)
    wall = time.perf_counter() - t0
    return {
        "config": 5,
        "mesh": f"{n_rows}x{n_srcs}",
        "engine": engine,
        "mode": mode,
        "n": n,
        "window": w,
        "slide": b,
        "sources": s,
        "steps": steps,
        "wall_s": round(wall, 4),
        "updates_per_sec": round(2 * b * steps / wall, 1),
        "updates_per_sec_per_chip": round(2 * b * steps / wall / chips, 1),
        "rounds": sum(st["rounds"] for st in stats),
        "wl_rounds": sum(st.get("wl_rounds", 0) for st in stats),
    }


CONFIGS = {
    1: config1_static_forward,
    2: config2_sliding_window,
    3: config3_reverse_dynamic,
    4: config4_retrieval,
    5: config5_sharded,
}


def run_config(idx: int, **kw) -> dict:
    return CONFIGS[idx](**kw)
