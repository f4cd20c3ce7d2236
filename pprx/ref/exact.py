"""Exact PPR oracle (ground truth for every accuracy test).

Reference counterpart (SURVEY.md §2.1 "Exact-PPR oracle", §4): the paper
measures accuracy as error vs exact PPR computed by power iteration. Here:
dense linear solve for small graphs (machine precision — used by the
invariant property tests) and sparse power iteration for larger ones.

Definitions. With row-stochastic transition matrix P (uniform over
out-edges; dangling rows behave as a self-loop — the convention shared
by every engine, see pprx.ref.push) and
teleport alpha:

    pi_s = alpha * e_s + (1 - alpha) * pi_s @ P
    pi_s = alpha * e_s @ (I - (1-alpha) P)^{-1}

``M := alpha * (I - (1-alpha) P)^{-1}`` has rows M[v, :] = pi_v, the PPR
vector personalized at v. The push invariants in SURVEY.md §2.2 are stated
in terms of M and are what the property tests check verbatim.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def transition_matrix(src: np.ndarray, dst: np.ndarray, n: int) -> sp.csr_matrix:
    """Row-stochastic P from a COO multi-edge list; dangling rows = self-loop."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    deg = np.bincount(src, minlength=n).astype(np.float64)
    dangling = np.flatnonzero(deg == 0)
    data = 1.0 / deg[src]
    rows = np.concatenate([src, dangling])
    cols = np.concatenate([dst, dangling])
    vals = np.concatenate([data, np.ones(dangling.size)])
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def exact_ppr_matrix(src: np.ndarray, dst: np.ndarray, n: int, alpha: float) -> np.ndarray:
    """Dense M = alpha (I - (1-alpha)P)^{-1}; rows are pi_v. Small n only."""
    P = transition_matrix(src, dst, n).toarray()
    A = np.eye(n) - (1.0 - alpha) * P
    return alpha * np.linalg.inv(A)


def exact_ppr(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    source: int,
    alpha: float,
    tol: float = 1e-12,
    max_iter: int = 100_000,
) -> np.ndarray:
    """pi_source by sparse power iteration to L1 tolerance ``tol``."""
    P = transition_matrix(src, dst, n)
    pi = np.zeros(n)
    pi[source] = 1.0
    e_s = pi.copy()
    for _ in range(max_iter):
        nxt = alpha * e_s + (1.0 - alpha) * (pi @ P)
        if np.abs(nxt - pi).sum() < tol:
            return nxt
        pi = nxt
    return pi


def exact_ppr_many(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    sources,
    alpha: float,
    tol: float = 1e-12,
    max_iter: int = 100_000,
) -> np.ndarray:
    """exact_ppr for several sources at once: [len(sources), n], iterated
    until every row's L1 change is below ``tol``."""
    P = transition_matrix(src, dst, n)
    e = np.zeros((len(sources), n))
    e[np.arange(len(sources)), np.asarray(sources)] = 1.0
    pi = e.copy()
    for _ in range(max_iter):
        nxt = alpha * e + (1.0 - alpha) * (P.T @ pi.T).T
        if np.abs(nxt - pi).sum(axis=1).max() < tol:
            return nxt
        pi = nxt
    return pi


def exact_contribution(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    target: int,
    alpha: float,
    tol: float = 1e-12,
    max_iter: int = 100_000,
) -> np.ndarray:
    """Column ``target`` of M — pi_v(target) for every v, the vector that
    reverse push maintains — by power iteration x <- alpha e_t +
    (1 - alpha) P x to L1 tolerance ``tol``. For graphs too large for
    exact_ppr_matrix."""
    P = transition_matrix(src, dst, n)
    e_t = np.zeros(n)
    e_t[target] = 1.0
    x = alpha * e_t
    for _ in range(max_iter):
        nxt = alpha * e_t + (1.0 - alpha) * (P @ x)
        if np.abs(nxt - x).sum() < tol:
            return nxt
        x = nxt
    return x
