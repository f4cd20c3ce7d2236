"""Edge-stream IO: text parsing, packing, synthetic generators.

Reference counterpart (SURVEY.md §2.1 "Graph converter / loader"): a C++ tool
parsing timestamped edge-list text, renumbering vertices, and emitting a
binary CSR + stream array. Here: text/SNAP parsing with deterministic
first-seen renumbering, a packed ``.npz`` format, and synthetic power-law
stream generators standing in for the paper's datasets (wiki-Vote,
soc-LiveJournal, Twitter-2010, Friendster), which are unreachable offline.

A native C++ fast path for bulk text parsing lives in ``native/`` and is used
automatically when its shared library has been built (see
``pprx.graph.native_io``); this module is the always-available pure-Python
path and the correctness oracle for it.
"""

from __future__ import annotations

import numpy as np


def load_edge_list(
    path: str, comments: str = "#%", use_native: bool | None = None
) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse a whitespace-separated edge-list text file.

    Lines are ``src dst [timestamp ...]``; lines starting with any character
    in ``comments`` are skipped. Vertices are renumbered densely by first
    appearance (deterministic). If a third column exists, edges are sorted by
    it (stable) to form the stream order; otherwise file order is stream
    order.

    ``use_native=None`` auto-selects the C++ parser (native/edgeio.cpp) when
    its library can be built; True forces it; False forces pure Python.

    Returns ``(src, dst, n)`` with int32 arrays in stream order.
    """
    if use_native is not False:
        from pprx.graph import native_io

        if native_io.available():
            src, dst, ts, has_ts = native_io.parse_edgelist_raw(path)
            if has_ts and not _nondecreasing(ts):
                order = np.argsort(ts, kind="stable")
                src, dst = src[order], dst[order]
            return renumber(src, dst)
        if use_native:
            raise RuntimeError("native edge IO requested but unavailable (make -C native)")
    srcs: list[int] = []
    dsts: list[int] = []
    ts: list[float] = []
    has_ts = False
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line[0] in comments:
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                s, d = int(parts[0]), int(parts[1])
            except ValueError:
                continue  # malformed line (same policy as the native parser)
            t = 0.0
            if len(parts) >= 3:
                try:
                    t = float(parts[2])
                    has_ts = True
                except ValueError:
                    pass
            srcs.append(s)
            dsts.append(d)
            ts.append(t)
    src = np.asarray(srcs, dtype=np.int64)
    dst = np.asarray(dsts, dtype=np.int64)
    if has_ts and not _nondecreasing(np.asarray(ts)):
        order = np.argsort(np.asarray(ts), kind="stable")
        src, dst = src[order], dst[order]
    return renumber(src, dst)


def _nondecreasing(ts: np.ndarray) -> bool:
    """Timestamped real streams usually arrive already time-ordered; a
    single O(M) check skips a 100M-element stable argsort (which dominated
    a 100M-edge load)."""
    return ts.size < 2 or bool(np.all(ts[1:] >= ts[:-1]))


def renumber(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Densely renumber vertex ids by first appearance in (src,dst)
    interleave (deterministic).

    When the raw id space is not much larger than the edge count, the
    first-seen map is built with O(M) scatters instead of sorting the 2M-id
    interleave (np.unique sorts; at 100M edges that sort dominated the
    whole load): a reverse-order fancy assignment
    leaves each id's FIRST position as the final write, and ranking the
    (small) present-id set by that position gives the same mapping as the
    unique-based path (property-tested equal in tests/test_native_io.py).
    """
    inter = np.empty(src.size * 2, dtype=np.int64)
    inter[0::2] = src
    inter[1::2] = dst
    max_id = int(inter.max()) if inter.size else -1
    min_id = int(inter.min()) if inter.size else 0
    if 0 <= min_id and 0 <= max_id and max_id + 1 <= max(2 * inter.size, 1 << 20):
        first_pos = np.full(max_id + 1, np.iinfo(np.int64).max, np.int64)
        first_pos[inter[::-1]] = np.arange(inter.size - 1, -1, -1)
        present = np.flatnonzero(first_pos != np.iinfo(np.int64).max)
        order = np.argsort(first_pos[present], kind="stable")
        rank = np.empty(max_id + 1, dtype=np.int32)
        rank[present[order]] = np.arange(present.size, dtype=np.int32)
        mapped = rank[inter]
        return mapped[0::2].copy(), mapped[1::2].copy(), int(present.size)
    uniq, first_pos, inverse = np.unique(inter, return_index=True, return_inverse=True)
    # rank unique ids by first appearance for determinism (fully vectorized)
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty(order.size, dtype=np.int32)
    rank[order] = np.arange(order.size, dtype=np.int32)
    mapped = rank[inverse]
    return mapped[0::2].copy(), mapped[1::2].copy(), int(uniq.size)


def save_packed(path: str, src: np.ndarray, dst: np.ndarray, n: int) -> None:
    """Pack a renumbered edge stream to ``.npz`` (the build's binary format)."""
    np.savez_compressed(
        path,
        src=np.asarray(src, dtype=np.int32),
        dst=np.asarray(dst, dtype=np.int32),
        n=np.int64(n),
    )


def load_packed(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    z = np.load(path)
    return z["src"], z["dst"], int(z["n"])


def synthetic_powerlaw_stream(
    n: int, m: int, seed: int = 0, exponent: float = 0.8
) -> tuple[np.ndarray, np.ndarray, int]:
    """Timestamped edge stream with power-law-skewed endpoints.

    Endpoint popularity follows a Zipf-like distribution (rank^-exponent),
    reproducing the degree skew that motivates the reference's load-balanced
    expansion (SURVEY.md §2.1). Self-loops are filtered (redrawn edges may
    remain as parallel edges, as in real streams).
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-exponent)
    probs /= probs.sum()
    perm = rng.permutation(n)
    src = perm[rng.choice(n, size=m, p=probs)]
    dst = perm[rng.choice(n, size=m, p=probs)]
    bad = src == dst
    while bad.any():
        dst[bad] = perm[rng.choice(n, size=int(bad.sum()), p=probs)]
        bad = src == dst
    return src.astype(np.int32), dst.astype(np.int32), n


def synthetic_erdos_stream(n: int, m: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
    """Uniform random edge stream (Erdos-Renyi-style, with parallel edges)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    bad = src == dst
    while bad.any():
        dst[bad] = rng.integers(0, n, size=int(bad.sum()))
        bad = src == dst
    return src.astype(np.int32), dst.astype(np.int32), n
