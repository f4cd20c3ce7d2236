"""Sharded retrieval head vs the single-device head (SURVEY.md §2.4
"all_gather for top-k merge"): local per-shard top-k + all_gather merge must
equal lax.top_k over the full reserve matrix, including tie order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pprx.dist.mesh import make_row_mesh
from pprx.dist.retrieve import make_sharded_topk
from pprx.retrieve.topk import topk_candidates


@pytest.mark.parametrize("rows,srcs", [(8, 1), (4, 2)])
def test_sharded_topk_matches_single_device(rows, srcs):
    rng = np.random.default_rng(7)
    n, s, k = 500, 8, 10
    mesh = make_row_mesh(rows, srcs)
    n_local = -(-(n + 1) // rows)
    n_pad = n_local * rows
    p = np.zeros((n_pad, s))
    p[:n] = rng.random((n, s))
    # inject score ties to pin down tie order (lowest global id wins)
    p[10, :] = p[20, :] = p[30, :] = 0.999
    pg = jax.device_put(jnp.asarray(p), NamedSharding(mesh, P("rows", "srcs")))

    f = make_sharded_topk(mesh, n, n_local, k)
    sc, ids = f(pg)
    # single-device head wants the [N+1, S] layout with a phantom last row
    ref_sc, ref_ids = topk_candidates(jnp.asarray(p[: n + 1]), k=k)
    np.testing.assert_allclose(np.asarray(sc), np.asarray(ref_sc))
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ref_ids))


def test_sharded_topk_never_emits_padding_rows():
    rng = np.random.default_rng(8)
    n, s, k = 37, 4, 12  # n_local*rows > n: real padded tail
    mesh = make_row_mesh(8, 1)
    n_local = -(-(n + 1) // 8)
    n_pad = n_local * 8
    p = np.zeros((n_pad, s))
    p[:n] = rng.random((n, s))
    p[n:] = 100.0  # poison the padding — must never be retrieved
    pg = jax.device_put(jnp.asarray(p), NamedSharding(mesh, P("rows", "srcs")))
    f = make_sharded_topk(mesh, n, n_local, k)
    sc, ids = f(pg)
    assert np.asarray(ids).max() < n
    assert np.asarray(sc).max() < 1.0
