"""Exact-PPR parity of the stream engines on the GPU (skipped without one).

Run on a GPU machine: PPRX_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pprx.config import PprConfig, StreamConfig
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.ref.exact import exact_ppr_many

pytestmark = pytest.mark.gpu

CFG = PprConfig(alpha=0.15, eps=1e-6, max_rounds=5000)
N, W, B = 3000, 30_000, 2000
QUERIES = [0, 3, 17, 250, 999]


def _check(p, r, head, src, dst):
    lo = head - W
    exact = exact_ppr_many(src[lo:head], dst[lo:head], N, QUERIES, CFG.alpha,
                           tol=1e-12)
    for j, pi in enumerate(exact):
        # forward-push bound sum_t |pi(t) - p(t)| <= eps * E, E = W here
        assert np.abs(p[:N, j].astype(np.float64) - pi).sum() <= CFG.eps * W
    mass = p[:N].astype(np.float64).sum(0) + r[:N].astype(np.float64).sum(0)
    np.testing.assert_allclose(mass, 1.0, atol=1e-4)


def test_fast_stream_exact_parity_on_gpu(gpu_device):
    from pprx.graph.fast_stream import FastStreamDriver

    src, dst, _ = synthetic_powerlaw_stream(N, W + 6 * B, seed=2)
    drv = FastStreamDriver(src, dst, N, QUERIES, CFG,
                           StreamConfig(window=W, slide=B), dtype=jnp.float32,
                           rebuild_every=2)
    drv.seed()
    for _ in drv.run(5):
        pass
    assert drv.state.p.devices() == {gpu_device}
    _check(np.asarray(drv.state.p), np.asarray(drv.state.r), drv.head, src,
           dst)


def test_sharded_wl_exact_parity_on_gpu(gpu_device):
    from pprx.dist.mesh import make_row_mesh
    from pprx.dist.stream import ShardedStreamDriver

    src, dst, _ = synthetic_powerlaw_stream(N, W + 6 * B, seed=2)
    drv = ShardedStreamDriver(src, dst, N, QUERIES, CFG,
                              StreamConfig(window=W, slide=B),
                              make_row_mesh(1, 1, [gpu_device]),
                              dtype=jnp.float32, engine="wl")
    drv.seed()
    for _ in drv.run(5):
        pass
    _check(drv.host_p(), drv.host_r(), drv.head, src, dst)
