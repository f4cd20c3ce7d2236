"""Checkpoint/resume: a resumed stream must produce bit-identical states to
an uninterrupted run (SURVEY.md §5)."""

import jax.numpy as jnp
import numpy as np

from pprx.config import PprConfig, StreamConfig
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.graph.stream import StreamDriver
from pprx.io.checkpoint import load_checkpoint, save_checkpoint

CFG = PprConfig(alpha=0.15, eps=1e-7)


def test_checkpoint_resume_bit_identical(tmp_path):
    n, total = 30, 400
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=8)
    scfg = StreamConfig(window=200, slide=20)

    a = StreamDriver(src, dst, n, [0, 5], CFG, scfg, dtype=jnp.float64)
    a.seed()
    for _ in a.run(4):
        pass
    ckpt = str(tmp_path / "ck.npz")
    save_checkpoint(ckpt, a)
    for _ in a.run(4):
        pass

    b = load_checkpoint(ckpt, src, dst)
    assert b.head == 200 + 4 * 20 and b.step_idx == 4
    for _ in b.run(4):
        pass

    np.testing.assert_array_equal(np.asarray(a.state.p), np.asarray(b.state.p))
    np.testing.assert_array_equal(np.asarray(a.state.r), np.asarray(b.state.r))
    np.testing.assert_array_equal(np.asarray(a.graph.deg), np.asarray(b.graph.deg))


def test_checkpoint_resume_hybrid(tmp_path):
    """Hybrid-driver checkpoints resume exactly (snapshot rebuilt on load)."""
    from pprx.graph.hybrid_stream import HybridStreamDriver

    n, total = 30, 400
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=8)
    scfg = StreamConfig(window=200, slide=20)
    a = HybridStreamDriver(src, dst, n, [0, 5], CFG, scfg, dtype=jnp.float64)
    a.seed()
    for _ in a.run(4):
        pass
    ckpt = str(tmp_path / "ckh.npz")
    save_checkpoint(ckpt, a)
    for _ in a.run(4):
        pass

    b = load_checkpoint(ckpt, src, dst)
    assert isinstance(b, HybridStreamDriver)
    # the resumed driver must carry the WRITER's tuning, not re-derived caps
    # (round-1 finding: divergent formulas changed resumed-run perf)
    for attr in ("fcap", "ecap", "scan_ecap", "wcap", "ovacap", "tiers",
                 "rebuild_every", "worklist"):
        assert getattr(b, attr) == getattr(a, attr), attr
    for _ in b.run(4):
        pass
    np.testing.assert_array_equal(np.asarray(a.state.p), np.asarray(b.state.p))
    np.testing.assert_array_equal(np.asarray(a.state.r), np.asarray(b.state.r))


def test_checkpoint_resume_sharded(tmp_path):
    """Sharded-driver checkpoints resume bit-identically on the CPU mesh."""
    import jax

    from pprx.dist.mesh import make_row_mesh
    from pprx.dist.stream import ShardedStreamDriver
    from pprx.io.checkpoint import load_sharded_checkpoint, save_sharded_checkpoint

    n, total = 48, 600
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=11)
    scfg = StreamConfig(window=300, slide=30)
    mesh = make_row_mesh(4, 2)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=500)
    a = ShardedStreamDriver(src, dst, n, [0, 5, 9, 17], cfg, scfg, mesh,
                            dtype=jnp.float64)
    a.seed()
    for _ in a.run(3):
        pass
    ckpt = str(tmp_path / "cks.npz")
    save_sharded_checkpoint(ckpt, a)
    for _ in a.run(3):
        pass

    b = load_sharded_checkpoint(ckpt, src, dst, mesh)
    assert b.head == a.head - 3 * 30 and b.step_idx == a.step_idx - 3
    for _ in b.run(3):
        pass
    np.testing.assert_array_equal(a.host_p(), b.host_p())
    np.testing.assert_array_equal(a.host_r(), b.host_r())
    np.testing.assert_array_equal(a.host_deg(), b.host_deg())


def test_determinism_bitwise():
    """Two identical hybrid-stream runs are bit-identical end to end — the
    build's substitute for the reference's atomics-correctness story
    (SURVEY.md §5 race detection: no atomics, deterministic scatter order)."""
    from pprx.graph.hybrid_stream import HybridStreamDriver

    n, total = 60, 800
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=13)
    scfg = StreamConfig(window=400, slide=40)

    def run():
        drv = HybridStreamDriver(src, dst, n, [0, 7, 31], CFG, scfg,
                                 dtype=jnp.float32)
        drv.seed()
        for _ in drv.run(6):
            pass
        return np.asarray(drv.state.p), np.asarray(drv.state.r)

    p1, r1 = run()
    p2, r2 = run()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(r1, r2)


def test_checkpoint_resume_fast(tmp_path):
    """Fast (wl2) driver: full KillGraph persisted; resume bit-identical
    even across a snapshot-rebuild boundary."""
    from pprx.graph.fast_stream import FastStreamDriver

    n, total = 30, 500
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=8)
    scfg = StreamConfig(window=200, slide=20)
    a = FastStreamDriver(
        src, dst, n, [0, 5], CFG, scfg, dtype=jnp.float64, rebuild_every=3
    )
    a.seed()
    for _ in a.run(4):
        pass
    ckpt = str(tmp_path / "ckf.npz")
    save_checkpoint(ckpt, a)
    for _ in a.run(5):  # crosses a rebuild (fcnt wraps at 3 slides)
        pass

    b = load_checkpoint(ckpt, src, dst)
    assert isinstance(b, FastStreamDriver)
    # resumed driver carries the writer's tuning (static fields; fcnt is
    # positional state and differs once `a` ran further)
    for attr in ("tiers", "rebuild_every", "e_top", "fring", "cap0"):
        assert getattr(b, attr) == getattr(a, attr), attr
    for _ in b.run(5):
        pass
    np.testing.assert_array_equal(np.asarray(a.state.p), np.asarray(b.state.p))
    np.testing.assert_array_equal(np.asarray(a.state.r), np.asarray(b.state.r))
    np.testing.assert_array_equal(np.asarray(a.graph.nbr), np.asarray(b.graph.nbr))
    np.testing.assert_array_equal(a.hsrc, b.hsrc)


def test_checkpoint_resume_sharded_wl(tmp_path):
    """Sharded WL-engine checkpoints resume bit-identically, including
    across a snapshot-rebuild boundary (VERDICT round-2 item 5: the wl
    engine must persist its snapshot dict + rebuild counters, and loading
    must reconstruct a wl driver — never silently a dense one)."""
    from pprx.dist.mesh import make_row_mesh
    from pprx.dist.stream import ShardedStreamDriver
    from pprx.io.checkpoint import load_sharded_checkpoint, save_sharded_checkpoint

    n, total = 48, 600
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=11)
    scfg = StreamConfig(window=300, slide=30)
    mesh = make_row_mesh(4, 2)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=500)
    a = ShardedStreamDriver(src, dst, n, [0, 5, 9, 17], cfg, scfg, mesh,
                            dtype=jnp.float64, engine="wl", fring=90)
    a.seed()
    for _ in a.run(2):
        pass
    ckpt = str(tmp_path / "cksw.npz")
    save_sharded_checkpoint(ckpt, a)
    # 4 more steps cross a fresh-ring rebuild (fring=90 holds 3 slides)
    for _ in a.run(4):
        pass

    b = load_sharded_checkpoint(ckpt, src, dst, mesh)
    assert b._wl, "wl checkpoint must resume as a wl driver"
    assert b.eng.tiers == a.eng.tiers
    assert b._since_rb == 2 and b.step_idx == a.step_idx - 4
    for _ in b.run(4):
        pass
    np.testing.assert_array_equal(a.host_p(), b.host_p())
    np.testing.assert_array_equal(a.host_r(), b.host_r())
    np.testing.assert_array_equal(a.host_deg(), b.host_deg())
    np.testing.assert_array_equal(
        np.asarray(a._fcnt_host), np.asarray(b._fcnt_host)
    )


def test_checkpoint_fast_backcompat_no_fd(tmp_path):
    """Fast-driver checkpoints written before the delivery-sorted fresh
    view existed (no kg_fd_* arrays) must still load — the fd view is
    derived state, reconstructed from the persisted ring."""
    from pprx.graph.fast_stream import FastStreamDriver

    n, total = 30, 500
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=8)
    scfg = StreamConfig(window=200, slide=20)
    a = FastStreamDriver(
        src, dst, n, [0, 5], CFG, scfg, dtype=jnp.float64, rebuild_every=3
    )
    a.seed()
    for _ in a.run(4):
        pass
    ckpt = str(tmp_path / "ckold.npz")
    save_checkpoint(ckpt, a)
    # strip the fd arrays to simulate the old format
    z = dict(np.load(ckpt))
    for k in ("kg_fd_gat", "kg_fd_sca"):
        del z[k]
    np.savez_compressed(ckpt, **z)
    for _ in a.run(4):
        pass

    b = load_checkpoint(ckpt, src, dst)
    for _ in b.run(4):
        pass
    np.testing.assert_array_equal(np.asarray(a.state.p), np.asarray(b.state.p))
    np.testing.assert_array_equal(np.asarray(a.state.r), np.asarray(b.state.r))


def test_checkpoint_fast_loads_padded_views_with_tile_offsets(tmp_path):
    """Fast-driver checkpoints from before the delivery views were unpadded
    carry a phantom tail on d_*/fd_* and per-tile offset arrays (d_toff,
    fd_toff): the loader trims the tail, ignores the offsets, and resumes
    bit-identically."""
    from pprx.graph.fast_stream import FastStreamDriver

    n, total = 30, 500
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=8)
    scfg = StreamConfig(window=200, slide=20)
    a = FastStreamDriver(
        src, dst, n, [0, 5], CFG, scfg, dtype=jnp.float64, rebuild_every=3
    )
    a.seed()
    for _ in a.run(4):
        pass
    ckpt = str(tmp_path / "ckpad.npz")
    save_checkpoint(ckpt, a)
    z = dict(np.load(ckpt))
    for k in ("kg_d_gat", "kg_d_sca", "kg_fd_gat", "kg_fd_sca"):
        z[k] = np.concatenate([z[k], np.full(48, n, np.int32)])
    z["kg_d_toff"] = np.zeros(2, np.int32)
    z["kg_fd_toff"] = np.zeros(2, np.int32)
    np.savez_compressed(ckpt, **z)
    for _ in a.run(4):
        pass

    b = load_checkpoint(ckpt, src, dst)
    assert b.graph.d_gat.shape == a.graph.d_gat.shape
    assert b.graph.fd_gat.shape == a.graph.fd_gat.shape
    for _ in b.run(4):
        pass
    np.testing.assert_array_equal(np.asarray(a.state.p), np.asarray(b.state.p))
    np.testing.assert_array_equal(np.asarray(a.state.r), np.asarray(b.state.r))
