"""Sequential NumPy push oracle — the accuracy/semantics reference.

Reference counterpart (SURVEY.md §2.1 "CPU parallel baseline" + §2.2/§2.3):
the reference's CPU push implementation plays the role of validation
baseline; here a deliberately simple sequential implementation is the oracle
every vectorized device path is tested against, and the dynamic-correction
rules are locked to the invariant by property tests (tests/test_invariant.py).

Invariants maintained at ALL times (SURVEY.md §2.2, with
M := alpha (I - (1-alpha)P)^{-1}, rows M[v] = pi_v):

  forward (source s):  pi_s(t) = p(t) + sum_v r(v) * pi_v(t)   for all t
  reverse (target t):  pi_s(t) = p(s) + sum_v pi_s(v) * r(v)   for all s

Push rules (dangling convention: an out-degree-0 vertex behaves as if it
had a single self-loop — its personalized walk never leaves it, so
pi_v = e_v; the oracle, engines and correction rules all share it):

  forward push at v, d = out-degree:
      rho = r[v]; r[v] = 0
      d>0:  p[v] += alpha*rho; r[w] += (1-alpha)*rho/d  for each out-neighbor
      d==0: p[v] += rho        (closed form of the self-loop geometric series:
                                pi_v = e_v, so the whole mass settles at v)
  reverse push at v:
      rho = r[v]; r[v] = 0
      d_out(v)>0:  p[v] += alpha*rho;  r[u] += (1-alpha)*rho/d_out(u)
                   for each in-neighbor u
      d_out(v)==0: p[v] += rho;  r[u] += ((1-alpha)/alpha)*rho/d_out(u)
                   (closed form: M e_v = e_v + beta * sum_{u->v} M e_u / d_out(u))

Dynamic correction rules — DERIVED from the invariant via the resolvent
identity M' - M = M ((1-alpha)/alpha) (P'-P) M' and an O(1) "compensating
push" at u; they restore the invariant EXACTLY (verified to machine
precision by tests/test_invariant.py). NOTE: these corrected coefficients
use the OLD degree d (SURVEY.md §2.3's recalled d+1 variant does not satisfy
the invariant and was discarded — see the derivation in the repo docs).

  forward, insert (u,w), d = old out-degree of u, beta = (1-alpha)/alpha:
      d>0:  D = p[u]/d;  p[u] += D;  r[u] -= D/alpha;  r[w] += beta*D
      d==0:              r[u] -= beta*p[u];            r[w] += beta*p[u]
  forward, delete (u,w), d = old out-degree (>=1, w in N(u)):
      d>1:  D = p[u]/d;  p[u] -= D;  r[u] += D/alpha;  r[w] -= beta*D
      d==1:              r[u] += beta*p[u];            r[w] -= beta*p[u]
  reverse, any change to row u of P:
      r[u] += beta * ((P' p)(u) - (P p)(u)),   p unchanged
      where (P p)(u) = mean of p over out-neighbors (or p(u) if dangling).
"""

from __future__ import annotations

import dataclasses

import numpy as np


class OracleGraph:
    """Tiny dynamic directed multigraph with out- and in-adjacency lists."""

    def __init__(self, n: int, src=None, dst=None):
        self.n = n
        self.out: list[list[int]] = [[] for _ in range(n)]
        self.inn: list[list[int]] = [[] for _ in range(n)]
        if src is not None:
            for u, w in zip(np.asarray(src).tolist(), np.asarray(dst).tolist()):
                self.add_edge(u, w)

    def add_edge(self, u: int, w: int) -> None:
        self.out[u].append(w)
        self.inn[w].append(u)

    def remove_edge(self, u: int, w: int) -> None:
        self.out[u].remove(w)
        self.inn[w].remove(u)

    def dout(self, u: int) -> int:
        return len(self.out[u])

    def coo(self) -> tuple[np.ndarray, np.ndarray]:
        src = [u for u in range(self.n) for _ in self.out[u]]
        dst = [w for u in range(self.n) for w in self.out[u]]
        return np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64)


@dataclasses.dataclass
class PushState:
    """Reserve/residual pair for one query (forward: source s; reverse: target t)."""

    p: np.ndarray
    r: np.ndarray
    mode: str  # "forward" | "reverse"
    query: int

    @staticmethod
    def init(n: int, query: int, mode: str) -> "PushState":
        r = np.zeros(n)
        r[query] = 1.0
        return PushState(p=np.zeros(n), r=r, mode=mode, query=query)


def _active_forward(g: OracleGraph, st: PushState, eps: float) -> list[int]:
    return [v for v in range(g.n) if abs(st.r[v]) > eps * max(g.dout(v), 1)]


def _active_reverse(g: OracleGraph, st: PushState, eps: float) -> list[int]:
    return [v for v in range(g.n) if abs(st.r[v]) > eps]


def forward_push(
    g: OracleGraph, st: PushState, alpha: float, eps: float, max_pushes: int = 10_000_000
) -> int:
    """Run forward push to convergence in place; returns number of pushes."""
    pushes = 0
    while True:
        frontier = _active_forward(g, st, eps)
        if not frontier or pushes >= max_pushes:
            return pushes
        for v in frontier:
            rho = st.r[v]
            if abs(rho) <= eps * max(g.dout(v), 1):
                continue
            st.r[v] = 0.0
            d = g.dout(v)
            if d == 0:
                st.p[v] += rho
            else:
                st.p[v] += alpha * rho
                share = (1.0 - alpha) * rho / d
                for w in g.out[v]:
                    st.r[w] += share
            pushes += 1


def reverse_push(
    g: OracleGraph, st: PushState, alpha: float, eps: float, max_pushes: int = 10_000_000
) -> int:
    """Run reverse push to convergence in place; returns number of pushes."""
    pushes = 0
    while True:
        frontier = _active_reverse(g, st, eps)
        if not frontier or pushes >= max_pushes:
            return pushes
        for v in frontier:
            rho = st.r[v]
            if abs(rho) <= eps:
                continue
            st.r[v] = 0.0
            if g.dout(v) == 0:
                st.p[v] += rho
                scale = (1.0 - alpha) / alpha * rho
            else:
                st.p[v] += alpha * rho
                scale = (1.0 - alpha) * rho
            for u in g.inn[v]:
                st.r[u] += scale / g.dout(u)
            pushes += 1


def _row_mean_p(g: OracleGraph, p: np.ndarray, u: int) -> float:
    """(P p)(u) under the self-loop-for-dangling convention."""
    d = g.dout(u)
    if d == 0:
        return float(p[u])
    return float(sum(p[w] for w in g.out[u]) / d)


def apply_edge_event(
    g: OracleGraph, st: PushState, u: int, w: int, insert: bool, alpha: float
) -> None:
    """Apply one edge insertion/deletion AND the exact O(1)/O(d) correction.

    Mutates both the graph and the state; the push invariant holds exactly
    afterwards (w.r.t. the NEW graph). Forward corrections are O(1); reverse
    corrections are O(d_out(u)) (they need the mean of p over u's final
    out-row — SURVEY.md §2.3 batched form).
    """
    beta = (1.0 - alpha) / alpha
    if st.mode == "forward":
        d = g.dout(u)
        pu = st.p[u]
        if insert:
            if d == 0:
                st.r[u] -= beta * pu
                st.r[w] += beta * pu
            else:
                delta = pu / d
                st.p[u] += delta
                st.r[u] -= delta / alpha
                st.r[w] += beta * delta
            g.add_edge(u, w)
        else:
            if d == 1:
                st.r[u] += beta * pu
                st.r[w] -= beta * pu
            else:
                delta = pu / d
                st.p[u] -= delta
                st.r[u] += delta / alpha
                st.r[w] -= beta * delta
            g.remove_edge(u, w)
    elif st.mode == "reverse":
        before = _row_mean_p(g, st.p, u)
        if insert:
            g.add_edge(u, w)
        else:
            g.remove_edge(u, w)
        after = _row_mean_p(g, st.p, u)
        st.r[u] += beta * (after - before)
    else:
        raise ValueError(f"unknown mode {st.mode}")
