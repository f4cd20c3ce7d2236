"""Smoke test of pprx on an NVIDIA GPU: the main path at real sizes, checked.

    python chip_smoke.py          # one GPU: phases 1-6
    python chip_smoke.py --four   # four GPUs: the row-sharded engines only

Phases (one process; ``nvidia-smi`` runs as a child that never imports JAX):

1. Device: exits non-zero unless JAX's first device is a GPU; prints the
   card, JAX's version and where the compile cache lives.
2. Delivery at real widths: one dense round of the single-chip engine over
   a W=2M, N=200k window at S=128 and S=16, against a float64 NumPy
   segment sum; ``memory_analysis()`` of the slide step.
3. The headline stream through the CLI: ``pprx serve`` for a few slides and
   reads, then ``pprx retrieve`` on the same graph.
4. The headline stream through ``FastStreamDriver``: timed slides, a
   bit-for-bit repeat from one snapshot, refinement to 5e-8, and the
   precision@100, L1 and mass-conservation checks against exact PPR.
5. Reverse push at config-3 shapes against exact contribution vectors.
6. The sharded ``wl`` engine at mesh 1x1 on the headline stream.
7. ``--four`` only (and alone): ``ShardedStreamDriver`` with the ``wl`` and
   the ``wlp`` engine on a (4, 1) row mesh over four GPUs, checked like 6.

Any failed check raises, so the process exits non-zero and prints no
result line. The last line of a passing run is one JSON object naming the
device. Float32 matrix products run at full precision
(``jax_default_matmul_precision="highest"``); the push path has none.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ALPHA = 0.15
EPS = 1e-6  # maintenance threshold
EPS_R = 5e-8  # retrieval-time refinement threshold
K = 100
N_CHECK = 16  # queries checked against exact PPR
PRECISION_REFINED = 0.95  # precision@100 floor after refinement to EPS_R
# precision@100 floor at the maintenance threshold: at N=200k, eps=1e-6
# makes no precision promise (top-k tail scores shrink like 1/N while the
# push error stays O(eps)); this floor only catches a broken state
PRECISION_MAINTAINED = 0.75
# float32 mass conservation: sum(p) + sum(r) = 1 per source, up to the
# round-off of ~1e2 push rounds per slide, each adding into 1e5-row states
MASS_TOL = 1e-3
U32 = 2.0**-24  # float32 unit round-off


@dataclasses.dataclass(frozen=True)
class Shapes:
    n: int
    window: int
    slide: int
    sources: int

    @property
    def rebuild_every(self) -> int:
        # bench.py's choice: rebuild the snapshot about every W/(6b) slides
        return max(1, min(8, self.window // (6 * self.slide)))


HEADLINE = Shapes(n=200_000, window=2_000_000, slide=160_000, sources=128)
REVERSE_SHAPES = Shapes(n=100_000, window=1_000_000, slide=10_000, sources=8)
TIMED_SLIDES = 3
REPEAT_SLIDES = 2


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> list[str]:
    """Name and power limit of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def check_device(min_count: int = 1):
    """The first JAX device, or exit non-zero: no CPU fallback."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX found {devs[0].platform!r}"
        )
    if len(devs) < min_count:
        raise SystemExit(f"needs {min_count} GPUs; JAX found {len(devs)}")
    return devs[0]


def phase_device(min_count: int = 1) -> str:
    import jax

    from pprx.compile_cache import enable_compile_cache

    dev = check_device(min_count)
    cache = enable_compile_cache()
    jax.config.update("jax_default_matmul_precision", "highest")
    cards = nvidia_smi()
    log(f"[1 device] kind={dev.device_kind} count={len(jax.devices())} "
        f"jax={jax.__version__} compile_cache={cache} "
        f"matmul_precision={jax.config.jax_default_matmul_precision}")
    for c in cards:
        log(f"[1 device] nvidia-smi: {c}")
    return cards[0]


# ---------------------------------------------------------------------------
# phase 2: delivery
# ---------------------------------------------------------------------------
def _delivery_reference(src, dst, n, r, deg, th):
    """float64 dense round of the forward engine, by a sorted NumPy segment
    sum over the window edges. Returns (p2, r2, per-element error bound)."""
    r64 = r.astype(np.float64)
    act = np.abs(r) > th[:, None]
    mass = np.where(act, r64, 0.0)
    inv = 1.0 / np.maximum(deg, 1)
    moving = (1.0 - ALPHA) * mass * inv[:, None]
    dangling = (deg == 0)[:, None]
    p2 = np.where(dangling, mass, ALPHA * mass)
    order = np.argsort(dst, kind="stable")
    d_sorted = dst[order]
    contrib = moving[src[order]]
    starts = np.flatnonzero(np.r_[True, d_sorted[1:] != d_sorted[:-1]])
    rows = d_sorted[starts]
    r2 = r64 - mass
    r2[rows] += np.add.reduceat(contrib, starts, axis=0)
    absum = np.abs(r64 - mass)
    absum[rows] += np.add.reduceat(np.abs(contrib), starts, axis=0)
    indeg = np.bincount(dst, minlength=n + 1)[:, None]
    # any summation order of k float32 terms (atomic adds included) is off
    # by at most k*u*sum|terms|; +4 covers the float32 rounding of each term
    bound = (indeg + 4) * U32 * absum
    return p2, r2, bound


def phase_delivery(drv, widths=(128, 16), reps=20, card: str = ""):
    """One dense delivery round (pprx.engine.wl2.dense_round_sorted) over
    the driver's window, against the float64 reference."""
    import jax
    import jax.numpy as jnp

    from pprx.config import PprConfig
    from pprx.engine.state import PprState
    from pprx.engine.wl2 import dense_round_sorted

    n = drv.n
    src = np.asarray(drv.hsrc, np.int64)
    dst = np.asarray(drv.hdst, np.int64)
    deg = np.bincount(src, minlength=n + 1).astype(np.int64)
    cfg = PprConfig(alpha=ALPHA, eps=EPS)
    th = (np.float32(EPS) * np.maximum(deg, 1).astype(np.float32))
    fn = jax.jit(dense_round_sorted, static_argnames=("cfg",))
    for s in widths:
        rng = np.random.default_rng(s)
        # residuals well clear of the activity threshold (2.5x above or
        # 0.4x below it), so the reference's mask cannot differ by rounding
        on = rng.random((n + 1, s)) < 0.7
        sign = np.where(rng.random((n + 1, s)) < 0.8, 1.0, -1.0)
        r = (sign * np.where(on, 2.5, 0.4) * th[:, None]).astype(np.float32)
        r[n] = 0.0
        st = PprState(p=jnp.zeros((n + 1, s), jnp.float32), r=jnp.asarray(r))
        c = fn.lower(st, drv.graph, cfg=cfg).compile()
        out, _, _ = c(st, drv.graph)
        jax.block_until_ready(out.r)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(c(st, drv.graph)[0].r)
            ts.append(time.perf_counter() - t0)
        p2, r2, bound = _delivery_reference(src, dst, n, r, deg, th)
        got_r = np.asarray(out.r, np.float64)
        got_p = np.asarray(out.p, np.float64)
        err = np.abs(got_r[:n] - r2[:n])
        worst = float((err / np.maximum(bound[:n], 1e-300)).max())
        p_err = float(np.abs(got_p[:n] - p2[:n]).max())
        log(f"[2 delivery] S={s} W={src.size} N={n}: median "
            f"{np.median(ts) * 1e3:.4f} ms (min {min(ts) * 1e3:.4f} ms) over "
            f"{reps}; max|r-ref|={err.max():.3e}, worst err/bound={worst:.3f}, "
            f"max|p-ref|={p_err:.3e}; float32 scatter-add, bound "
            f"(in-degree+4)*2^-24*sum|terms| per element ({card})")
        if not worst <= 1.0:
            raise AssertionError(f"delivery S={s}: error exceeds its bound")
        if not p_err <= 4 * U32 * np.abs(p2).max():
            raise AssertionError(f"delivery S={s}: reserve update off")
    log(f"[2 delivery] slide step memory_analysis: {slide_step_memory(drv)}")


def slide_step_memory(drv):
    """compiled.memory_analysis() of the driver's jitted slide step."""
    import jax.numpy as jnp

    from pprx.graph.fast_stream import wl2_slide_step

    pack = jnp.zeros(2 * drv.scfg.slide + 8, jnp.int32)
    compiled = wl2_slide_step.lower(
        drv.state, drv.graph, pack, cfg=drv.cfg, tiers=drv.tiers
    ).compile()
    return compiled.memory_analysis()


# ---------------------------------------------------------------------------
# phases 3-6
# ---------------------------------------------------------------------------
def make_stream(shapes: Shapes, slides: int, seed: int):
    from pprx.graph.io import synthetic_powerlaw_stream

    m = shapes.window + slides * shapes.slide
    src, dst, _ = synthetic_powerlaw_stream(shapes.n, m, seed=seed)
    return src, dst


def _run_cli(argv) -> dict:
    from pprx import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    line = buf.getvalue().strip().splitlines()[-1]
    log(f"[3 cli] pprx {argv[0]}: {line}")
    return json.loads(line)


def phase_cli(npz: str, shapes: Shapes, workdir: str, batch: int = 512):
    """`pprx serve` for a few slides and reads, then `pprx retrieve`."""
    queries = ",".join(str(q) for q in range(shapes.sources))
    steps, every = 4, 2
    out = _run_cli([
        "serve", npz, "--window", str(shapes.window),
        "--slide", str(shapes.slide), "--steps", str(steps),
        "--queries", queries, "--serve-every", str(every), "--k", str(K),
        "--log", os.path.join(workdir, "serve.jsonl"),
    ])
    if out["steps"] != steps or out["serve_events"] != steps // every:
        raise AssertionError(f"serve ran {out['steps']} slides, "
                             f"{out['serve_events']} reads")
    for key in ("slide_ms_worst", "slide_ms_mean", "retrieval_ms_mean"):
        if not np.isfinite(out[key]):
            raise AssertionError(f"serve: {key} = {out[key]}")
    out = _run_cli([
        "retrieve", npz, "--queries", "random", "--batch", str(batch),
        "--k", str(K),
    ])
    if out["batch"] != batch or not np.isfinite(out["retrieval_ms"]):
        raise AssertionError(f"retrieve: {out}")
    if not all(0 <= i < shapes.n for i in out["top1"]):
        raise AssertionError(f"retrieve: top-1 ids out of range {out['top1']}")


def exact_vectors(src, dst, head: int, shapes: Shapes, queries) -> dict:
    """Exact PPR of each query over the window ending at ``head``."""
    from pprx.ref.exact import exact_ppr_many

    lo = head - shapes.window
    t0 = time.perf_counter()
    pis = exact_ppr_many(src[lo:head], dst[lo:head], shapes.n, list(queries),
                         ALPHA, tol=1e-10)
    out = {int(q): pi for q, pi in zip(queries, pis)}
    log(f"[oracle] exact PPR of {len(out)} queries over the window ending "
        f"at {head}: {time.perf_counter() - t0:.1f} s")
    return out


def check_forward(tag: str, p, r, queries, exact: dict, shapes: Shapes,
                  eps: float, precision_floor: float):
    """precision@100, L1 <= eps*E and mass conservation for the checked
    queries (columns of p/r are the driver's query order)."""
    from pprx.eval.metrics import l1_error, precision_at_k

    n = shapes.n
    cols = {q: j for j, q in enumerate(queries)}
    precs, l1s = [], []
    for q, pi in exact.items():
        j = cols[q]
        pred = np.argsort(-p[:n, j], kind="stable")[:K]
        precs.append(precision_at_k(pred, pi, K))
        l1s.append(l1_error(p[:n, j].astype(np.float64), pi))
    mass = (p[:n].astype(np.float64).sum(axis=0)
            + r[:n].astype(np.float64).sum(axis=0))
    bound = eps * shapes.window  # eps * E, E = sum of out-degrees
    prec = float(np.mean(precs))
    mass_err = float(np.abs(mass - 1.0).max())
    log(f"[{tag}] precision@{K}={prec:.4f} (floor {precision_floor}) "
        f"L1 max={max(l1s):.4e} mean={np.mean(l1s):.4e} (bound eps*E="
        f"{bound:.4g}) mass |sum p + sum r - 1| max={mass_err:.3e} "
        f"(tol {MASS_TOL})")
    if not (prec >= precision_floor and max(l1s) <= bound
            and mass_err <= MASS_TOL):
        raise AssertionError(f"{tag}: accuracy checks failed")
    return prec


def _time_slides(tag, run_one, sync, count, card):
    walls = []
    for _ in range(count):
        t0 = time.perf_counter()
        run_one()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"[{tag}] per-slide wall ms {[round(w, 3) for w in walls]} "
        f"(smoke reading, not a benchmark; {card})")
    return walls


def build_forward_driver(src, dst, shapes: Shapes, card: str = ""):
    import jax.numpy as jnp

    from pprx.config import PprConfig, StreamConfig
    from pprx.graph.fast_stream import FastStreamDriver

    t0 = time.perf_counter()
    drv = FastStreamDriver(
        src, dst, shapes.n, list(range(shapes.sources)),
        PprConfig(alpha=ALPHA, eps=EPS, max_rounds=2000),
        StreamConfig(window=shapes.window, slide=shapes.slide),
        dtype=jnp.float32, rebuild_every=shapes.rebuild_every,
    )
    log(f"[4 forward] driver setup (incl. snapshot build compile) "
        f"{time.perf_counter() - t0:.2f} s ({card})")
    return drv


def forward_slide_count(shapes: Shapes) -> int:
    """Slides phase 4 runs in all: warm-up, timed, and the repeat."""
    return shapes.rebuild_every + 2 + TIMED_SLIDES + REPEAT_SLIDES


def phase_forward(drv, src, dst, shapes: Shapes, card: str):
    """Seed, warm past the first snapshot rebuild, time slides, repeat two
    slides from one snapshot, refine, and check against exact PPR."""
    import jax
    import jax.numpy as jnp

    sync = lambda: jax.block_until_ready(drv.state.r)  # noqa: E731
    t0 = time.perf_counter()
    drv.seed()
    sync()
    log(f"[4 forward] seed (incl. compile) {time.perf_counter() - t0:.2f} s "
        f"({card})")
    t0 = time.perf_counter()
    next(drv.run(1))
    sync()
    log(f"[4 forward] first slide (incl. compile) "
        f"{time.perf_counter() - t0:.2f} s ({card})")
    for _ in drv.run(shapes.rebuild_every + 1):
        pass
    sync()
    _time_slides("4 forward", lambda: next(drv.run(1)), sync, TIMED_SLIDES,
                 card)

    # the same slides twice from one snapshot (the slide step donates its
    # inputs, so the snapshot holds copies)
    def snapshot():
        return (jax.tree_util.tree_map(jnp.array, (drv.state, drv.graph)),
                drv.fcnt, drv.head, drv.step_idx,
                drv.hsrc.copy(), drv.hdst.copy())

    def restore(snap):
        st_kg, drv.fcnt, drv.head, drv.step_idx, hs, hd = snap
        drv.state, drv.graph = jax.tree_util.tree_map(jnp.array, st_kg)
        drv.hsrc, drv.hdst = hs.copy(), hd.copy()

    snap0 = snapshot()
    for _ in drv.run(REPEAT_SLIDES):
        pass
    p1 = np.asarray(drv.state.p)
    restore(snap0)
    for _ in drv.run(REPEAT_SLIDES):
        pass
    p2 = np.asarray(drv.state.p)
    log(f"[4 forward] {REPEAT_SLIDES} slides repeated from one snapshot: "
        f"p bit-identical={bool(np.array_equal(p1, p2))} "
        f"max|diff|={float(np.abs(p1 - p2).max()):.3e}")

    queries = list(range(shapes.sources))
    checked = [queries[i] for i in
               np.linspace(0, shapes.sources - 1, N_CHECK).astype(int)]
    exact = exact_vectors(src, dst, drv.head, shapes, checked)
    check_forward("4 forward eps=1e-6", np.asarray(drv.state.p),
                  np.asarray(drv.state.r), queries, exact, shapes, EPS,
                  PRECISION_MAINTAINED)
    t0 = time.perf_counter()
    st = drv.refine(EPS_R)
    sync()
    log(f"[4 forward] refine to {EPS_R} (incl. compile) "
        f"{time.perf_counter() - t0:.2f} s, {int(st.rounds)} rounds ({card})")
    check_forward(f"4 forward refined eps={EPS_R}", np.asarray(drv.state.p),
                  np.asarray(drv.state.r), queries, exact, shapes, EPS_R,
                  PRECISION_REFINED)
    return drv.head, exact


def phase_reverse(shapes: Shapes, card: str, seed: int = 3):
    """Reverse push at config-3 shapes: maintained p columns are the
    contribution vectors pi_.(t), within eps of exact."""
    import jax
    import jax.numpy as jnp

    from pprx.config import PprConfig, StreamConfig
    from pprx.engine.state import REVERSE
    from pprx.graph.fast_stream import FastStreamDriver
    from pprx.ref.exact import exact_contribution

    slides = shapes.rebuild_every + 2 + TIMED_SLIDES
    src, dst = make_stream(shapes, slides + 1, seed)
    targets = list(range(shapes.sources))
    t0 = time.perf_counter()
    drv = FastStreamDriver(
        src, dst, shapes.n, targets,
        PprConfig(alpha=ALPHA, eps=EPS, max_rounds=2000),
        StreamConfig(window=shapes.window, slide=shapes.slide),
        mode=REVERSE, dtype=jnp.float32, rebuild_every=shapes.rebuild_every,
    )
    drv.seed()
    for _ in drv.run(shapes.rebuild_every + 2):
        pass
    sync = lambda: jax.block_until_ready(drv.state.r)  # noqa: E731
    sync()
    log(f"[5 reverse] setup + seed + warm-up (incl. compile) "
        f"{time.perf_counter() - t0:.2f} s ({card})")
    _time_slides("5 reverse", lambda: next(drv.run(1)), sync, TIMED_SLIDES,
                 card)
    p = np.asarray(drv.state.p, np.float64)
    lo = drv.head - shapes.window
    # reverse invariant: pi_.(t) = p + M r with |r| <= eps and rows of M
    # summing to 1, so max_v |p(v) - pi_v(t)| <= eps; a further eps covers
    # float32 round-off accumulated over the stream
    tol = 2 * EPS
    worst = 0.0
    for j, t in enumerate(targets):
        x = exact_contribution(src[lo:drv.head], dst[lo:drv.head], shapes.n,
                               t, ALPHA, tol=1e-10)
        worst = max(worst, float(np.abs(p[:shapes.n, j] - x).max()))
    log(f"[5 reverse] max |p - exact pi_.(t)| over {len(targets)} targets = "
        f"{worst:.3e} (tol {tol:.1e})")
    if not worst <= tol:
        raise AssertionError("reverse: contribution vectors off")


def phase_sharded(src, dst, shapes: Shapes, rows: int, engine: str,
                  slides: int, exact: dict, card: str, tag: str):
    """ShardedStreamDriver on a (rows, 1) mesh: slides to the same head as
    phase 4, then the phase-4 checks at the maintenance threshold."""
    import jax
    import jax.numpy as jnp

    from pprx.config import PprConfig, StreamConfig
    from pprx.dist.mesh import make_row_mesh
    from pprx.dist.stream import ShardedStreamDriver

    t0 = time.perf_counter()
    drv = ShardedStreamDriver(
        src, dst, shapes.n, list(range(shapes.sources)),
        PprConfig(alpha=ALPHA, eps=EPS, max_rounds=2000),
        StreamConfig(window=shapes.window, slide=shapes.slide),
        make_row_mesh(rows, 1), dtype=jnp.float32, engine=engine,
    )
    drv.seed()
    sync = lambda: jax.block_until_ready(drv.p)  # noqa: E731
    sync()
    log(f"[{tag}] mesh ({rows}, 1) engine={engine}: setup + seed (incl. "
        f"compile) {time.perf_counter() - t0:.2f} s ({card})")
    warm = slides - TIMED_SLIDES
    for _ in drv.run(warm):
        pass
    sync()
    _time_slides(tag, lambda: next(drv.run(1)), sync, TIMED_SLIDES, card)
    check_forward(tag, drv.host_p(), drv.host_r(),
                  list(range(shapes.sources)), exact, shapes, EPS,
                  PRECISION_MAINTAINED)
    return drv.head


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded engines over four GPUs")
    args = ap.parse_args(argv)

    card = phase_device(4 if args.four else 1)
    import jax

    shapes = HEADLINE
    slides = forward_slide_count(shapes)
    t0 = time.perf_counter()
    src, dst = make_stream(shapes, slides + 6, seed=7)
    log(f"[stream] {src.size} edges, N={shapes.n}: "
        f"{time.perf_counter() - t0:.1f} s")
    checked = [int(q) for q in
               np.linspace(0, shapes.sources - 1, N_CHECK).astype(int)]
    if args.four:
        head = shapes.window + slides * shapes.slide
        exact = exact_vectors(src, dst, head, shapes, checked)
        for engine in ("wl", "wlp"):
            phase_sharded(src, dst, shapes, 4, engine, slides, exact, card,
                          f"7 four {engine}")
    else:
        drv = build_forward_driver(src, dst, shapes, card)
        phase_delivery(drv, card=card)
        with tempfile.TemporaryDirectory() as td:
            from pprx.graph.io import save_packed

            npz = os.path.join(td, "stream.npz")
            save_packed(npz, src, dst, shapes.n)
            phase_cli(npz, shapes, td)
        head, exact = phase_forward(drv, src, dst, shapes, card)
        del drv
        phase_reverse(REVERSE_SHAPES, card)
        phase_sharded(src, dst, shapes, 1, "wl", slides, exact, card,
                      "6 sharded 1x1")

    for line in nvidia_smi():
        print(line)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
