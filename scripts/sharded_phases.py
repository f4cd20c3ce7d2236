"""Phase-level timing of the SHARDED wl slide at mesh 1x1, headline shapes,
to compare against the single-chip engine. Times standalone jitted
replicas of each slide phase, each ended by block_until_ready.

NOTE: the dense-round replica below delivers through an acc +
psum_scatter, as the engine did before its local-first delivery layout;
it no longer mirrors the shipped dense round exactly."""

import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from pprx.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from jax import shard_map  # noqa: E402

from pprx.config import PprConfig, StreamConfig
from pprx.dist.mesh import make_row_mesh
from pprx.dist.sharded import forward_corrections, forward_corrections_pairs
from pprx.dist.stream import ShardedStreamDriver

N, W, B, S = 200_000, 2_000_000, 160_000, 128
cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
scfg = StreamConfig(window=W, slide=B)
mesh = make_row_mesh(1, 1)

from pprx.graph.io import synthetic_powerlaw_stream

src, dst, _ = synthetic_powerlaw_stream(N, W + 16 * B, seed=5)
drv = ShardedStreamDriver(src, dst, N, list(range(S)), cfg, scfg, mesh,
                          engine="wl")
drv.debug_batches = True
eng = drv.eng
print(f"tiers={eng.tiers} wcarry={eng.wcarry} ccap={eng.wl_ccap} "
      f"fring={eng.fring} e_top={eng.e_top}", flush=True)
drv.seed()
for st in drv.run(4):
    last = st
jax.block_until_ready(drv.p)

# 1. full slide
t0 = time.perf_counter()
k = 0
for st in drv.run(4):
    k += 1
jax.block_until_ready(drv.p)
full_ms = (time.perf_counter() - t0) / k * 1e3
print(f"full slide: {full_ms:.1f} ms (last rounds={st['rounds']}, "
      f"wl={st['wl_rounds']}, host={drv.last_host_ms:.1f} ms)", flush=True)


def timeit(f, *a, reps=8, **kw):
    out = f(*a, **kw)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*a, **kw)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    return (time.perf_counter() - t0) / reps * 1e3


smap = functools.partial(shard_map, mesh=mesh, check_vma=False)
spec_state, spec_row, rep = eng.state_spec, eng.row_spec, P()
n_pad, n_local, K = eng.n_pad, eng.n_local, eng.n_rows
dtype = eng.dtype

# 2. rebuild
ms = timeit(eng._rebuild, drv.egl, drv.eog, drv.eva, reps=4)
print(f"rebuild: {ms:.1f} ms (amortized /8 slides = {ms/8:.1f})", flush=True)

bt = drv._batches
A = drv._rows_array
batches = {kk: A(v) for kk, v in bt.items()}


# 3. corrections, current (unsorted acc scatter) vs sorted variant
@jax.jit
@functools.partial(
    smap, in_specs=(spec_state, spec_state, spec_row) + (spec_row,) * 6,
    out_specs=(spec_state, spec_state, spec_row),
)
def corr_unsorted(p, r, deg, du, dw, dv, iu, iw, iv):
    p, r, acc, deg2 = forward_corrections(
        p, r, deg, du, dw, dv, iu, iw, iv, cfg.alpha, dtype, n_pad)
    delta = jax.lax.psum_scatter(acc, "rows", scatter_dimension=0, tiled=True)
    return p, r + delta, deg2


@jax.jit
@functools.partial(
    smap, in_specs=(spec_state, spec_state, spec_row) + (spec_row,) * 6,
    out_specs=(spec_state, spec_state, spec_row),
)
def corr_sorted(p, r, deg, du, dw, dv, iu, iw, iv):
    p, r, ids, vals, deg2 = forward_corrections_pairs(
        p, r, deg, du, dw, dv, iu, iw, iv, cfg.alpha, dtype, n_pad)
    L = ids.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    ids_s, order = jax.lax.sort((ids, lane), num_keys=1, is_stable=True)
    acc = jnp.zeros((n_pad, p.shape[1]), dtype).at[
        jnp.clip(ids_s, 0, n_pad - 1)
    ].add(vals[order] * (ids_s < n_pad).astype(dtype)[:, None],
          indices_are_sorted=True)
    delta = jax.lax.psum_scatter(acc, "rows", scatter_dimension=0, tiled=True)
    return p, r + delta, deg2


args = (drv.p, drv.r, drv.deg, batches["del_u"], batches["del_w"],
        batches["del_v"], batches["ins_u"], batches["ins_w"], batches["ins_v"])
print(f"corrections unsorted: {timeit(corr_unsorted, *args):.1f} ms", flush=True)
print(f"corrections sorted:   {timeit(corr_sorted, *args):.1f} ms", flush=True)

# 4. mutate_graph replica (the per-slide fresh-ring sorts)
snap = drv.snap
RS = eng.fring + 1


@jax.jit
@functools.partial(
    smap,
    in_specs=({kk: spec_row for kk in snap.keys()},) + (spec_row,) * 3,
    out_specs={kk: spec_row for kk in snap.keys()},
)
def mutate_replica(snap, clear_slots, gat, sca):
    snbr2 = snap["snbr"].at[snap["spos"][clear_slots]].set(n_pad)
    d_gat2 = snap["d_gat"].at[snap["d_pos"][clear_slots]].set(n_local)
    fcnt0 = snap["fcnt"][0]
    bk = gat.shape[0]
    pos = jnp.where(
        jnp.ones_like(gat) > 0,
        fcnt0 + jax.lax.broadcasted_iota(jnp.int32, (bk,), 0), eng.fring)
    fr_gat2 = snap["fr_gat"].at[pos].set(gat).at[eng.fring].set(n_local)
    fr_sca2 = snap["fr_sca"].at[pos].set(sca).at[eng.fring].set(n_pad)
    f_len2 = snap["f_len"].at[jnp.clip(gat, 0, n_local - 1)].add(1)
    _, f_nbr2 = jax.lax.sort_key_val(fr_gat2, fr_sca2, is_stable=True)
    f_off2 = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(f_len2, dtype=jnp.int32)])
    iota_rs = jax.lax.broadcasted_iota(jnp.int32, (RS,), 0)
    fd_sca2, _, fd_gat2 = jax.lax.sort(
        (fr_sca2, iota_rs, fr_gat2), num_keys=1, is_stable=True)
    return {
        **snap, "snbr": snbr2, "d_gat": d_gat2, "fd_gat": fd_gat2,
        "fd_sca": fd_sca2, "fr_gat": fr_gat2, "fr_sca": fr_sca2, "f_off": f_off2,
        "f_nbr": f_nbr2, "f_len": f_len2,
        "fcnt": jnp.reshape(fcnt0 + bk, (1,)),
    }


ms = timeit(mutate_replica, snap, batches["clear_slots"], batches["ins_u"],
            batches["ins_w"], reps=4)
print(f"mutate_graph replica (fring={eng.fring}): {ms:.1f} ms", flush=True)

# 5. push floor on converged state (push_wl donates p/r: fresh copies per
# call; the copy cost is inside the bracket, fine for a floor)
ms = timeit(
    lambda: eng.push_wl(jnp.array(drv.p, copy=True),
                        jnp.array(drv.r, copy=True),
                        drv.deg, drv.snap),
    reps=4,
)
print(f"push_wl on converged state: {ms:.1f} ms", flush=True)


# 6. one dense-flush round replica (carry=0)
@jax.jit
@functools.partial(
    smap,
    in_specs=(spec_state, spec_state, spec_row,
              {kk: spec_row for kk in snap.keys()}),
    out_specs=(spec_state, spec_state, rep),
)
def dense_round_replica(p, r, deg, snap):
    alpha = jnp.asarray(cfg.alpha, dtype)
    inv_deg = (1.0 / jnp.maximum(deg, 1).astype(dtype))[:, None]
    dangling = (deg == 0)[:, None]
    th = cfg.eps * jnp.maximum(deg, 1).astype(dtype)
    act = jnp.abs(r) > th[:, None]
    mass = jnp.where(act, r, jnp.zeros((), dtype))
    p = p + jnp.where(dangling, mass, alpha * mass)
    r = r - mass
    moving = (1.0 - alpha) * mass * inv_deg
    moving_ext = jnp.concatenate([moving, jnp.zeros((1, mass.shape[1]), dtype)])
    acc = jnp.zeros((n_pad, mass.shape[1]), dtype).at[
        jnp.clip(snap["d_sca"], 0, n_pad - 1)].add(moving_ext[snap["d_gat"]])
    acc = acc.at[jnp.clip(snap["fd_sca"], 0, n_pad - 1)].add(
        moving_ext[snap["fd_gat"]])
    delta = jax.lax.psum_scatter(acc, "rows", scatter_dimension=0, tiled=True)
    r = r + delta
    # exact rescan reseed
    act2 = jnp.abs(r) > th[:, None]
    any2 = jnp.any(act2, axis=1)
    cn2 = jnp.sum(any2, dtype=jnp.int32)
    (idx2,) = jnp.nonzero(any2, size=eng.wcarry, fill_value=n_local)
    fed2 = jnp.sum(jnp.where(any2, snap["srl"], 0), dtype=jnp.int32)
    return p, r, jax.lax.psum(
        (cn2 + fed2 + idx2[0]).astype(jnp.float32), ("rows", "srcs"))


ms = timeit(dense_round_replica, drv.p, drv.r, drv.deg, drv.snap, reps=4)
print(f"dense-flush round replica (incl. rescan): {ms:.1f} ms", flush=True)


# 7. the rescan alone
@jax.jit
@functools.partial(
    smap, in_specs=(spec_state, spec_row, spec_row),
    out_specs=rep,
)
def rescan_replica(r, deg, srl):
    th = cfg.eps * jnp.maximum(deg, 1).astype(dtype)
    act2 = jnp.abs(r) > th[:, None]
    any2 = jnp.any(act2, axis=1)
    cn2 = jnp.sum(any2, dtype=jnp.int32)
    (idx2,) = jnp.nonzero(any2, size=eng.wcarry, fill_value=n_local)
    fed2 = jnp.sum(jnp.where(any2, srl, 0), dtype=jnp.int32)
    return jax.lax.psum((cn2 + fed2 + idx2[0]).astype(jnp.float32),
                        ("rows", "srcs"))


ms = timeit(rescan_replica, drv.r, drv.deg, drv.snap["srl"])
print(f"rescan alone (wcarry={eng.wcarry}): {ms:.2f} ms", flush=True)


# 8. compact-round replicas at each tier (synthetic cand of the tier's
# size; real snapshot/state, real expansions + sorted_bucket + a2a)
from pprx.dist.wl import SORT_BUCKET_MIN, sorted_bucket
from pprx.engine.wl2 import rld_expand

snapd = drv.snap
for ti, (w_i, e_i, g_i) in enumerate(eng.tiers):
    ccap_i = eng.ccaps[ti]

    @jax.jit
    @functools.partial(
        smap,
        in_specs=(spec_state, spec_state, spec_row,
                  {kk: spec_row for kk in snapd.keys()}, spec_row),
        out_specs=(spec_state, rep),
    )
    def compact_replica(p, r, deg, snap, cand_sh, _wi=w_i, _ei=e_i,
                        _gi=g_i, _cc=ccap_i):
        alpha = jnp.asarray(cfg.alpha, dtype)
        soff, snbr, srl = snap["soff"], snap["snbr"], snap["srl"]
        f_off, f_nbr, f_len = snap["f_off"], snap["f_nbr"], snap["f_len"]
        candw = cand_sh[:_wi]
        cc = jnp.clip(candw, 0, n_local - 1)
        live = candw < n_local
        r_c = jnp.where(live[:, None], r[cc], jnp.zeros((), dtype))
        deg_c = deg[cc]
        th = cfg.eps * jnp.maximum(deg_c, 1).astype(dtype)
        act = jnp.logical_and(jnp.abs(r_c) > th[:, None], live[:, None])
        mass = jnp.where(act, r_c, jnp.zeros((), dtype))
        p = p.at[cc].add(alpha * mass, indices_are_sorted=True)
        r = r.at[cc].add(-mass, indices_are_sorted=True)
        inv_c = 1.0 / jnp.maximum(deg_c, 1).astype(dtype)
        moving = (1.0 - alpha) * mass * inv_c[:, None]
        anyact = jnp.any(act, axis=1)
        len1 = jnp.where(anyact, srl[cc], 0)
        t1, pos1, val1 = rld_expand(soff[cc], len1, _ei)
        g1 = jnp.where(val1, snbr[jnp.clip(pos1, 0, eng.sstride - 1)], n_pad)
        c1 = moving[t1] * (g1 < n_pad).astype(dtype)[:, None]
        len2 = jnp.where(anyact, f_len[cc], 0)
        t2, pos2, val2 = rld_expand(f_off[cc], len2, _gi)
        g2 = jnp.where(val2, f_nbr[jnp.clip(pos2, 0, eng.fring)], n_pad)
        c2 = moving[t2] * (g2 < n_pad).astype(dtype)[:, None]
        ids = jnp.concatenate([g1, g2])
        vals = jnp.concatenate([c1, c2])
        L = _ei + _gi
        if L >= SORT_BUCKET_MIN:
            send_ids, send_mass, cids, cmass, pend2 = sorted_bucket(
                ids, vals, K, n_local, n_pad, _cc, min(L, n_pad), dtype)
        else:
            send_ids = jnp.full(K * _cc, n_local, jnp.int32)
            send_mass = jnp.zeros((K * _cc, mass.shape[1]), dtype)
        recv_ids = jax.lax.all_to_all(
            send_ids.reshape(K, _cc), "rows",
            split_axis=0, concat_axis=0, tiled=True).reshape(-1)
        recv_mass = jax.lax.all_to_all(
            send_mass.reshape(K, _cc, mass.shape[1]), "rows",
            split_axis=0, concat_axis=0, tiled=True
        ).reshape(-1, mass.shape[1])
        M = K * _cc
        lane_r = jax.lax.broadcasted_iota(jnp.int32, (M,), 0)
        rid_s, order_r = jax.lax.sort((recv_ids, lane_r), num_keys=1,
                                      is_stable=True)
        rm_s = recv_mass[order_r] * (rid_s < n_local).astype(dtype)[:, None]
        rcs = jnp.clip(rid_s, 0, n_local - 1)
        r = r.at[rcs].add(rm_s, indices_are_sorted=True)
        lane2 = jax.lax.broadcasted_iota(jnp.int32, (M,), 0)
        scr2 = jnp.zeros(n_local + 1, jnp.int32).at[recv_ids].set(lane2)
        win2 = jnp.logical_and(scr2[recv_ids] == lane2, recv_ids < n_local)
        cn2 = jnp.sum(win2, dtype=jnp.int32)
        (cp2,) = jnp.nonzero(win2, size=min(M, eng.wcarry), fill_value=0)
        fed2 = jnp.sum(jnp.where(win2, srl[jnp.clip(recv_ids, 0, n_local - 1)], 0), dtype=jnp.int32)
        return r, jax.lax.psum(
            (cn2 + fed2 + cp2[0]).astype(jnp.float32), ("rows", "srcs"))

    rng = np.random.default_rng(ti)
    cand_host = np.full(eng.wcarry, n_local, np.int32)
    cand_host[:w_i] = np.sort(
        rng.choice(n_local, size=w_i, replace=False)
    ).astype(np.int32)
    cand_sh = drv._rows_array(cand_host)
    ms = timeit(compact_replica, drv.p, drv.r, drv.deg, drv.snap, cand_sh,
                reps=4)
    print(f"compact round tier {ti} (w={w_i}, e={e_i}, g={g_i}, "
          f"ccap={ccap_i}): {ms:.1f} ms", flush=True)
