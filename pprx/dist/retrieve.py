"""Distributed top-k retrieval over the row-sharded reserve matrix.

SURVEY.md §2.4 collectives row ("all_gather for top-k merge") / [BASELINE]
config 4 across several GPUs. The reference has no retrieval head (it reports
error/throughput only); this is the sharded counterpart of
pprx.retrieve.topk for states living on a ('rows', 'srcs') mesh:

- each 'rows' shard runs a LOCAL exact top-k over its n_local vertex rows;
- the k (score, global-id) winners per shard ride ONE ``all_gather`` along
  'rows' — k*K rows instead of N, so the merge traffic is tiny;
- a final top-k over the K*k gathered candidates is exact with respect to
  the local heads (exact local heads => exact global top-k, since every
  global top-k element is in its owner's local top-k).

Queries stay sharded over 'srcs' (data-parallel: no cross-'srcs' traffic);
the result is replicated along 'rows', so any host can serve it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pprx.retrieve.topk import exact_topk_rows


def make_sharded_topk(mesh: jax.sharding.Mesh, n: int, n_local: int, k: int):
    """Build the jitted sharded retrieval program.

    Returns ``f(p_global) -> (scores [S, k], ids [S, k])`` where
    ``p_global`` is the [N_pad, S] reserve matrix sharded P('rows','srcs');
    outputs are replicated along 'rows' and sharded along 'srcs'.
    Rows >= n (padding + the phantom row) never appear as candidates.
    """

    @jax.jit
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P("rows", "srcs"),
        out_specs=(P("srcs", None), P("srcs", None)),
        check_vma=False,
    )
    def topk(p_local):
        # a shard holds only n_local rows, so its local head is capped there
        # (k_loc = n_local still captures every possible global winner)
        k_loc = min(k, n_local)
        row0 = jax.lax.axis_index("rows") * n_local
        sc, ids = exact_topk_rows(p_local.T, k_loc)  # [s_loc, k_loc]
        gids = ids + row0
        sc = jnp.where(gids < n, sc, -jnp.inf)
        # [s_loc, K*k_loc] candidate table — k_loc rows per shard, not N
        sc_all = jax.lax.all_gather(sc, "rows", axis=1, tiled=True)
        id_all = jax.lax.all_gather(gids, "rows", axis=1, tiled=True)
        if sc_all.shape[1] < k:  # degenerate ask: k > available rows
            pad = k - sc_all.shape[1]
            sc_all = jnp.pad(sc_all, ((0, 0), (0, pad)), constant_values=-jnp.inf)
            id_all = jnp.pad(id_all, ((0, 0), (0, pad)))
        sc2, pos = jax.lax.top_k(sc_all, k)
        return sc2, jnp.take_along_axis(id_all, pos, axis=1)

    return topk
