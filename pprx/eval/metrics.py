"""Accuracy metrics vs exact PPR (SURVEY.md §2.1 "Eval / metrics", L8).

The reference methodology: L1 error of the maintained reserve vector vs
exact PPR (power iteration), and top-k precision. [BASELINE] names
"top-100 PPR precision vs exact" as a primary tracked metric.
"""

from __future__ import annotations

import numpy as np


def l1_error(approx: np.ndarray, exact: np.ndarray) -> float:
    return float(np.abs(np.asarray(approx) - np.asarray(exact)).sum())


def max_error(approx: np.ndarray, exact: np.ndarray) -> float:
    return float(np.abs(np.asarray(approx) - np.asarray(exact)).max())


def precision_at_k(pred_ids: np.ndarray, exact_scores: np.ndarray, k: int) -> float:
    """|top-k(pred) ∩ top-k(exact)| / k.

    pred_ids: [k] (or longer) predicted candidate ids, best first.
    exact_scores: [N] exact PPR vector to rank against.
    Ties in the exact ranking at the k-boundary are resolved in the
    prediction's favor (any vertex with score >= the k-th exact score counts),
    so a perfect approximation always scores 1.0.
    """
    pred = np.asarray(pred_ids)[:k]
    exact_scores = np.asarray(exact_scores)
    kth = np.sort(exact_scores)[-k]
    hits = np.sum(exact_scores[pred] >= kth)
    return float(hits) / k


def recall_at_k_ties(pred_ids: np.ndarray, exact_scores: np.ndarray, k: int) -> float:
    """Rigorous tie-aware recall@k: strictly-above-boundary hits count
    fully; hits AT the k-th score count only up to the number of boundary
    slots (k minus the strictly-above count), so backfilling with tied
    vertices can never mask a missed strictly-better vertex. Equals plain
    set recall when the exact k-boundary is tie-free; on power-law PPR
    tails (where thousands of vertices can share the k-th score at config-4
    shapes) it is the correct form of "any tie-equivalent answer is interchangeable"."""
    pred = np.asarray(pred_ids)[:k]
    exact_scores = np.asarray(exact_scores)
    kth = np.sort(exact_scores)[-k]
    above = int(np.sum(exact_scores > kth))
    sc = exact_scores[pred]
    hit_above = int(np.sum(sc > kth))
    hit_tie = int(np.sum(sc == kth))
    return (hit_above + min(hit_tie, k - above)) / k
