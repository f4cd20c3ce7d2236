"""Command-line entry points (SURVEY.md §2.1 "CLI binaries", L7).

The reference ships one binary per variant (static/dynamic x fwd/rev x
cpu/gpu); here one ``python -m pprx.cli`` with subcommands:

  convert   edge-list text -> packed .npz stream (renumbered)
  static    forward/reverse push on a static graph, report accuracy/timing
  stream    sliding-window dynamic maintenance, JSONL per-step records
  retrieve  multi-source batched top-k candidate generation
  serve     bounded-stall serving loop: maintain + budgeted incremental
            refinement + periodic top-k reads
  bench     the headline updates/s benchmark (same as bench.py)

Common flags mirror the reference's: --alpha (0.15), --eps, --window,
--slide, --mode fwd|rev.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _add_common(p):
    p.add_argument("--alpha", type=float, default=0.15)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--max-rounds", type=int, default=10_000)
    p.add_argument("--mode", choices=["fwd", "rev"], default="fwd")
    p.add_argument("--queries", type=str, default="0", help="comma-separated query vertex ids")
    p.add_argument("--f64", action="store_true", help="float64 state (CPU/testing)")


def _load(args):
    from pprx.graph.io import load_edge_list, load_packed

    if args.graph.endswith(".npz"):
        return load_packed(args.graph)
    return load_edge_list(args.graph)


def _cfg(args):
    from pprx.config import PprConfig

    return PprConfig(alpha=args.alpha, eps=args.eps, max_rounds=args.max_rounds)


def _mode(args):
    from pprx.engine.state import FORWARD, REVERSE

    return FORWARD if args.mode == "fwd" else REVERSE


def _dtype(args):
    import jax.numpy as jnp

    return jnp.float64 if args.f64 else jnp.float32


def cmd_convert(args):
    from pprx.graph.io import load_edge_list, save_packed

    src, dst, n = load_edge_list(args.graph)
    save_packed(args.out, src, dst, n)
    print(json.dumps({"n": n, "edges": int(src.shape[0]), "out": args.out}))


def cmd_static(args):
    import jax

    from pprx.engine.push import push_to_convergence
    from pprx.engine.state import init_state
    from pprx.graph.dynamic import WindowGraph

    src, dst, n = _load(args)
    queries = [int(q) for q in args.queries.split(",")]
    graph = WindowGraph.from_coo(src, dst, n)
    state = init_state(n, queries, mode=_mode(args), dtype=_dtype(args))
    t0 = time.perf_counter()
    state, stats = jax.jit(push_to_convergence, static_argnames=("cfg",))(
        state, graph, cfg=_cfg(args)
    )
    jax.block_until_ready(state.p)
    wall = time.perf_counter() - t0
    out = {
        "n": n,
        "edges": int(src.shape[0]),
        "queries": queries,
        "rounds": int(stats.rounds),
        "pushes": float(stats.pushes),
        "edge_pushes": float(stats.edge_pushes),
        "wall_s": round(wall, 4),
    }
    if args.check_exact:
        from pprx.engine.state import FORWARD
        from pprx.eval.metrics import l1_error
        from pprx.ref.exact import exact_ppr_matrix

        M = exact_ppr_matrix(src, dst, n, args.alpha)
        p = np.asarray(state.p)[:n]
        errs = []
        for j, q in enumerate(queries):
            tgt = M[q] if _mode(args) == FORWARD else M[:, q]
            errs.append(l1_error(p[:, j], tgt))
        out["l1_error"] = errs
        out["l1_bound"] = args.eps * src.shape[0]
    print(json.dumps(out))


class _DictStats:
    """Adapter: sharded-driver dict records -> PushStats-like attrs."""

    def __init__(self, d):
        self.rounds = d["rounds"]
        self.pushes = d["pushes"]
        self.edge_pushes = d["edge_pushes"]
        self.wl_rounds = d.get("wl_rounds", 0)


def _make_stream_driver(args, src, dst, n, queries, scfg):
    """Build the engine selected by --engine; 'sharded' initializes the
    multi-host runtime (SURVEY.md §5 comm backend) and row-shards over
    the global device mesh."""
    from pprx.graph.fast_stream import FastStreamDriver
    from pprx.graph.hybrid_stream import HybridStreamDriver
    from pprx.graph.stream import StreamDriver

    common = dict(mode=_mode(args), dtype=_dtype(args))
    if args.engine in ("sharded", "sharded-wl", "sharded-wlp"):
        import jax

        from pprx.dist.init import init_distributed
        from pprx.dist.mesh import make_row_mesh
        from pprx.dist.stream import ShardedStreamDriver

        init_distributed(args.coordinator, args.num_processes, args.process_id)
        if args.mesh:
            rows, srcs = (int(x) for x in args.mesh.split(","))
        else:
            rows, srcs = len(jax.devices()), 1
        mesh = make_row_mesh(rows, srcs)
        return ShardedStreamDriver(
            src, dst, n, queries, _cfg(args), scfg, mesh, ecap=args.ecap,
            engine={"sharded-wl": "wl", "sharded-wlp": "wlp"}.get(args.engine, "dense"),
            **common
        ), rows * srcs
    ctor = {
        "fast": FastStreamDriver,
        "hybrid": HybridStreamDriver,
        "dense": StreamDriver,
    }[args.engine]
    return ctor(src, dst, n, queries, _cfg(args), scfg, **common), 1


def cmd_stream(args):
    from pprx.config import StreamConfig
    from pprx.eval.perf import summarize
    from pprx.logging import JsonlLogger

    src, dst, n = _load(args)
    queries = [int(q) for q in args.queries.split(",")]
    scfg = StreamConfig(window=args.window, slide=args.slide)
    drv, n_chips = _make_stream_driver(args, src, dst, n, queries, scfg)
    sharded = args.engine in ("sharded", "sharded-wl", "sharded-wlp")
    with JsonlLogger(args.log) as log:
        seed_stats = drv.seed()
        if sharded:
            seed_stats = _DictStats(seed_stats)
        log.log("seed", rounds=int(seed_stats.rounds), pushes=float(seed_stats.pushes))
        t0 = time.perf_counter()
        stats_list = []
        for i, s in enumerate(drv.run(args.steps)):
            if sharded:
                s = _DictStats(s)
            stats_list.append(s)
            log.log(
                "slide",
                step=i,
                rounds=int(s.rounds),
                pushes=float(s.pushes),
                edge_pushes=float(s.edge_pushes),
            )
            if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
                if sharded:
                    from pprx.io.checkpoint import save_sharded_checkpoint

                    save_sharded_checkpoint(args.checkpoint, drv)
                else:
                    from pprx.io.checkpoint import save_checkpoint

                    save_checkpoint(args.checkpoint, drv)
                log.log("checkpoint", step=i, path=args.checkpoint)
        wall = time.perf_counter() - t0
        rep = summarize(stats_list, wall, edges_per_step=2 * args.slide, n_chips=n_chips)
        log.log("summary", **rep.as_dict())
    print(json.dumps(rep.as_dict()))


def cmd_retrieve(args):
    import jax

    from pprx.engine.push import push_to_convergence
    from pprx.engine.state import init_state
    from pprx.graph.dynamic import WindowGraph
    from pprx.retrieve.topk import topk_candidates

    src, dst, n = _load(args)
    refine_info = {}
    if args.from_checkpoint:
        # serve from a MAINTAINED stream state (the engine's production
        # pattern): the checkpoint holds the converged reserve; optionally
        # refine it to a tighter eps before reading top-k (the retrieval
        # precision policy)
        from pprx.io.checkpoint import load_checkpoint

        try:
            import json as _json

            import numpy as _np

            _z = _np.load(args.from_checkpoint)
            _kind = _json.loads(bytes(_z["meta"]).decode()).get("kind")
        except Exception:
            _kind = None
        if _kind == "sharded":
            raise SystemExit(
                "this is a SHARDED checkpoint; serve it through the sharded "
                "driver (pprx.io.checkpoint.load_sharded_checkpoint + "
                "pprx.dist.retrieve.make_sharded_topk), not "
                "`retrieve --from-checkpoint`"
            )
        drv = load_checkpoint(args.from_checkpoint, src, dst)
        if args.refine_eps:
            if not hasattr(drv, "refine"):
                raise SystemExit(
                    "--refine-eps needs a fast-engine checkpoint "
                    f"(got {type(drv).__name__})"
                )
            t0 = time.perf_counter()
            rstats = drv.refine(args.refine_eps)
            jax.block_until_ready(drv.state.r)
            refine_info = {
                "refine_eps": args.refine_eps,
                "refine_ms": round((time.perf_counter() - t0) * 1e3, 3),
                "refine_rounds": int(rstats.rounds),
            }
        state = drv.state
        # batch size comes from the state itself; older checkpoints may not
        # carry the query vertex ids (do NOT fabricate them from range(S))
        queries = getattr(drv, "_queries", None)
        n_batch = state.p.shape[1]

        class _S:  # stats stand-in: the push work happened in the stream
            rounds = 0

        stats = _S()
    else:
        rng = np.random.default_rng(0)
        if args.queries == "random":
            queries = rng.integers(0, n, size=args.batch).tolist()
        else:
            queries = [int(q) for q in args.queries.split(",")]
        graph = WindowGraph.from_coo(src, dst, n)
        state = init_state(n, queries, mode=0, dtype=_dtype(args))
        state, stats = jax.jit(push_to_convergence, static_argnames=("cfg",))(
            state, graph, cfg=_cfg(args)
        )
        n_batch = len(queries)
    # warm up (compile) before timing the serving latency
    scores, ids = jax.block_until_ready(topk_candidates(state.p, k=args.k))
    t0 = time.perf_counter()
    scores, ids = jax.block_until_ready(topk_candidates(state.p, k=args.k))
    retr_ms = (time.perf_counter() - t0) * 1e3
    print(
        json.dumps(
            {
                "n": n,
                "batch": n_batch,
                "queries_known": queries is not None,
                "k": args.k,
                "push_rounds": int(stats.rounds),
                "retrieval_ms": round(retr_ms, 3),
                **refine_info,
                "top1": [int(i) for i in np.asarray(ids[:, 0])[: min(8, n_batch)]],
            }
        )
    )


def cmd_serve(args):
    """Bounded-stall serving loop: maintain the stream at --eps, spend up to
    --refine-budget push rounds per slide refining toward --eps-retrieve
    (invariant-preserving at any interruption point), and serve top-k reads
    from the CURRENT state every --serve-every slides — no long event-time
    refinement. --refine-budget 0 falls back to the event mode (one full
    refine before each read)."""
    import jax

    from pprx.config import StreamConfig
    from pprx.engine.state import FORWARD
    from pprx.graph.fast_stream import FastStreamDriver
    from pprx.logging import JsonlLogger
    from pprx.retrieve.topk import topk_candidates

    if args.mode != "fwd":
        raise SystemExit("serve: forward mode only (source-personalized top-k)")
    src, dst, n = _load(args)
    queries = [int(q) for q in args.queries.split(",")]
    scfg = StreamConfig(window=args.window, slide=args.slide)
    drv = FastStreamDriver(
        src, dst, n, queries, _cfg(args), scfg, mode=FORWARD,
        dtype=_dtype(args),
    )
    budget = args.refine_budget
    with JsonlLogger(args.log) as log:
        seed_stats = drv.seed()
        log.log("seed", rounds=int(seed_stats.rounds))
        if budget:
            # ramp-up: converge to eps_retrieve once so steady slides only
            # maintain it (a cold start pays this as ramp-up)
            st = drv.refine(args.eps_retrieve)
            log.log("ramp_refine", rounds=int(st.rounds))
        steps = args.steps if args.steps is not None else drv.steps_available
        slide_ms = []
        retr_ms = []
        served = 0
        t0 = time.perf_counter()
        for i in range(steps):
            t1 = time.perf_counter()
            ran = False
            for _ in drv.run(1):
                ran = True
            if not ran:
                break
            if budget:
                st = drv.refine(args.eps_retrieve, rounds=budget)
                jax.block_until_ready(drv.state.r)
                w = (time.perf_counter() - t1) * 1e3
                log.log("slide", step=i, wall_ms=round(w, 1),
                        refine_rounds=int(st.rounds))
            else:
                jax.block_until_ready(drv.state.r)
                w = (time.perf_counter() - t1) * 1e3
                log.log("slide", step=i, wall_ms=round(w, 1))
            slide_ms.append(w)
            if (i + 1) % args.serve_every == 0:
                if not budget:
                    t2 = time.perf_counter()
                    st = drv.refine(args.eps_retrieve)
                    jax.block_until_ready(drv.state.r)
                    log.log("event_refine", step=i, rounds=int(st.rounds),
                            wall_ms=round((time.perf_counter() - t2) * 1e3, 1))
                t2 = time.perf_counter()
                scores, ids = jax.block_until_ready(
                    topk_candidates(drv.state.p, k=args.k)
                )
                ms = (time.perf_counter() - t2) * 1e3
                retr_ms.append(ms)
                served += 1
                rec = {"step": i, "k": args.k, "latency_ms": round(ms, 2),
                       "batch": len(queries)}
                if args.emit_ids:
                    idh = np.asarray(ids)[: args.emit_ids]
                    rec["ids"] = [[int(x) for x in row] for row in idh]
                log.log("serve", **rec)
        wall = time.perf_counter() - t0
        done = len(slide_ms)
        rep = {
            "mode": "serve",
            "steps": done,
            "serve_events": served,
            "updates_per_sec_incl_refine": round(2 * args.slide * done / wall, 1)
            if done else 0.0,
            "slide_ms_worst": round(max(slide_ms), 1) if slide_ms else None,
            "slide_ms_mean": round(float(np.mean(slide_ms)), 1) if slide_ms else None,
            "retrieval_ms_mean": round(float(np.mean(retr_ms)), 2) if retr_ms else None,
            "refine_budget_rounds": budget,
            "serve_every": args.serve_every,
            "eps_maintain": args.eps,
            "eps_retrieve": args.eps_retrieve,
        }
        log.log("summary", **rep)
    print(json.dumps(rep))


def cmd_bench(args):
    if args.config:
        from pprx.bench.run import run_config

        kw = {}
        if args.graph:
            kw["graph"] = args.graph
        if args.scale != 1:
            kw["scale"] = args.scale
        print(json.dumps(run_config(args.config, **kw)))
        return
    import bench

    bench.main()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pprx", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("convert", help="edge-list text -> packed npz")
    p.add_argument("graph")
    p.add_argument("out")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("static", help="static push query")
    p.add_argument("graph")
    _add_common(p)
    p.add_argument("--check-exact", action="store_true")
    p.set_defaults(fn=cmd_static)

    p = sub.add_parser("stream", help="sliding-window dynamic maintenance")
    p.add_argument("graph")
    _add_common(p)
    p.add_argument("--window", type=int, required=True)
    p.add_argument("--slide", type=int, required=True)
    p.add_argument(
        "--engine",
        choices=["fast", "hybrid", "dense", "sharded", "sharded-wl", "sharded-wlp"],
        default="fast",
        help="fast = compact-frontier wl2 engine (default); sharded = "
        "row-sharded multi-device/multi-host engine (dense rounds); "
        "sharded-wl = row-sharded compact-frontier rounds (bucketed a2a); "
        "sharded-wlp = wl with memory-proportional carry/drain rounds",
    )
    p.add_argument(
        "--mesh",
        type=str,
        default=None,
        help="sharded engine mesh 'rows,srcs' (default: all devices x 1)",
    )
    p.add_argument(
        "--coordinator",
        type=str,
        default=None,
        help="multi-host: jax.distributed coordinator address host:port",
    )
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument(
        "--ecap", type=int, default=None,
        help="sharded engine: per-shard edge-buffer capacity (default: window)",
    )
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--log", type=str, default=None, help="JSONL log path (default stdout)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("retrieve", help="multi-source top-k candidates")
    p.add_argument(
        "--from-checkpoint",
        default=None,
        help="serve from a stream checkpoint's maintained state instead of "
        "pushing from scratch (the graph arg supplies the stream file)",
    )
    p.add_argument(
        "--refine-eps",
        type=float,
        default=0.0,
        help="refine the maintained state to this tighter eps before "
        "reading top-k (retrieval precision policy; fast engine only)",
    )
    p.add_argument("graph")
    _add_common(p)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--batch", type=int, default=512)
    p.set_defaults(fn=cmd_retrieve)

    p = sub.add_parser(
        "serve",
        help="bounded-stall serving: maintain + budgeted refine + top-k reads",
    )
    p.add_argument("graph")
    _add_common(p)
    p.add_argument("--window", type=int, required=True)
    p.add_argument("--slide", type=int, required=True)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--eps-retrieve", type=float, default=5e-8)
    p.add_argument(
        "--refine-budget", type=int, default=6,
        help="max refinement push rounds per slide (0 = full refine at "
        "each serve event instead)",
    )
    p.add_argument("--serve-every", type=int, default=4,
                   help="serve a top-k batch every N slides")
    p.add_argument(
        "--emit-ids", type=int, default=0,
        help="log top-k ids for the first N queries at each serve event",
    )
    p.add_argument("--log", type=str, default=None,
                   help="JSONL log path (default stdout)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench", help="headline updates/s benchmark")
    p.add_argument(
        "--config",
        type=int,
        choices=[1, 2, 3, 4, 5],
        default=0,
        help="run one of the five [BASELINE] milestone configs instead",
    )
    p.add_argument(
        "--graph",
        default=None,
        help="packed .npz edge stream (pprx convert output) to run the "
        "config on instead of the synthetic power-law stand-in",
    )
    p.add_argument("--scale", type=int, default=1)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from pprx.compile_cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
