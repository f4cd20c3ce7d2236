"""Dense push engine: one COO round + push-to-convergence driver.

Reference counterpart (SURVEY.md §2.1 "Forward/Reverse-push kernel",
"Convergence controller"; §3.1 hot loop). The reference's GPU realization is
frontier compaction + load-balanced expansion + atomicAdd; this dense
path instead processes the whole window per round as gather + scatter-add
over the COO buffer with a per-(vertex, query) activity mask:

- the scatter-add is XLA's (on the GPU it adds with atomics, so the
  summation order, and the last bits of the result, can vary from run to
  run);
- the whole convergence loop runs on-device inside ``lax.while_loop`` —
  the reference pays a host sync per round (SURVEY.md §3.1), we pay none;
- signed residuals (deletions) are handled by |r| thresholds throughout
  (SURVEY.md §2.2).

Push rules and the closed-form dangling handling are specified in
pprx/ref/push.py (the oracle this module is tested against).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pprx.config import PprConfig
from pprx.engine.state import FORWARD, PprState, PushStats
from pprx.graph.dynamic import WindowGraph


def _active_mask(state: PprState, graph: WindowGraph, cfg: PprConfig) -> jnp.ndarray:
    """[N+1, S] bool — which (vertex, query) pairs exceed the push threshold.

    Forward: |r[v]| > eps * max(d_out(v), 1); reverse: |r[v]| > eps.
    The phantom row N never activates because its residual is always zero.
    """
    absr = jnp.abs(state.r)
    if state.mode == FORWARD:
        thresh = cfg.eps * jnp.maximum(graph.deg, 1).astype(state.r.dtype)
        return absr > thresh[:, None]
    return absr > jnp.asarray(cfg.eps, state.r.dtype)


def push_round(
    state: PprState, graph: WindowGraph, cfg: PprConfig
) -> tuple[PprState, jnp.ndarray, jnp.ndarray]:
    """One dense push round over every active (vertex, query) pair.

    Returns (new_state, n_active_pairs, n_edge_pushes).
    """
    act = _active_mask(state, graph, cfg)
    return push_round_given_act(state, act, graph, cfg)


def push_round_given_act(
    state: PprState, act: jnp.ndarray, graph: WindowGraph, cfg: PprConfig
) -> tuple[PprState, jnp.ndarray, jnp.ndarray]:
    """Dense round with the activity mask supplied by the caller (lets the
    adaptive dense/sparse switch compute it exactly once per round)."""
    dtype = state.r.dtype
    alpha = jnp.asarray(cfg.alpha, dtype)
    mass = jnp.where(act, state.r, jnp.zeros((), dtype))  # [N+1,S]
    deg = graph.deg
    dangling = (deg == 0)[:, None]  # [N+1,1]
    inv_deg = (1.0 / jnp.maximum(deg, 1).astype(dtype))[:, None]

    # reserve absorbs alpha*mass (all of it at dangling vertices: closed form)
    p_new = state.p + jnp.where(dangling, mass, alpha * mass)
    r_new = state.r - mass

    if state.mode == FORWARD:
        # edge (u,w): r[w] += (1-alpha) * mass[u] / d_out(u)
        scale = (1.0 - alpha) * mass * inv_deg  # [N+1,S]; dangling rows have no edges
        r_new = r_new.at[graph.dst].add(scale[graph.src])
        edge_pushes = jnp.sum(act * deg[:, None], dtype=jnp.float32)
    else:
        # reverse: edge (u,w): r[u] += outmass[w] / d_out(u)
        # outmass leaves w scaled (1-alpha); dangling w uses the closed-form
        # beta = (1-alpha)/alpha factor (see pprx/ref/push.py docstring).
        beta = (1.0 - alpha) / alpha
        outmass = jnp.where(dangling, beta * mass, (1.0 - alpha) * mass)
        contrib = outmass[graph.dst] * inv_deg[graph.src]
        r_new = r_new.at[graph.src].add(contrib)
        # edge pushes in reverse = in-degree work; count via gather of act
        edge_pushes = jnp.sum(act[graph.dst], dtype=jnp.float32)

    # keep the phantom row identically zero
    p_new = p_new.at[-1].set(0.0)
    r_new = r_new.at[-1].set(0.0)
    n_active = jnp.sum(act, dtype=jnp.float32)
    return state.replace(p=p_new, r=r_new), n_active, edge_pushes


def push_to_convergence(
    state: PprState, graph: WindowGraph, cfg: PprConfig
) -> tuple[PprState, PushStats]:
    """Iterate push rounds on-device until no (vertex, query) pair is active
    or ``cfg.max_rounds`` is hit. The loop predicate is carried, so there is
    no host round-trip per round (contrast SURVEY.md §3.1's per-round sync)."""

    def cond(carry):
        _, stats, n_active = carry
        return jnp.logical_and(n_active > 0, stats.rounds < cfg.max_rounds)

    def body(carry):
        st, stats, _ = carry
        st2, n_active, edge_pushes = push_round(st, graph, cfg)
        stats2 = PushStats(
            rounds=stats.rounds + 1,
            pushes=stats.pushes + n_active,
            edge_pushes=stats.edge_pushes + edge_pushes,
            wl_rounds=stats.wl_rounds,
        )
        return st2, stats2, n_active

    # prime the predicate with the true activity count
    n0 = jnp.sum(_active_mask(state, graph, cfg), dtype=jnp.float32)
    state, stats, _ = jax.lax.while_loop(cond, body, (state, PushStats.zero(), n0))
    return state, stats
