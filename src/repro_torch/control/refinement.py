"""The port's copy of ``repro.control.refinement``, whole (framework-free).

Adaptive range refinement (paper §4.3).

Each instance periodically re-derives its downstream boundary from live
request lengths: merge its own active lengths with the *average* successor
set (union of successor requests divided evenly by successor count, the
same sorted every-n-th division as §4.2), scan all split points of the
sorted merged list for

    b = argmin_i  Q^{R[:i]} + Q^{R[i:]}

and take R[b] as the new boundary. Stability optimizations reproduced:
EMA smoothing, low-traffic freeze (< ``min_requests``), planner-seeded
initial boundary.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.qoe import NUM_FEATURES, QoEModel


def divide_evenly(sorted_vals: np.ndarray, n: int) -> np.ndarray:
    """Footnote-1 set division S/n: starting from the n/2-th element,
    pick every n-th — a representative subset of |S|/n elements."""
    if n <= 1:
        return sorted_vals
    return sorted_vals[n // 2::n]


def _prefix_features(I: np.ndarray, L: np.ndarray) -> np.ndarray:
    """cumF[i] = features of R[:i]; rows [nb+1, 5]."""
    n = len(I)
    cum = np.zeros((n + 1, NUM_FEATURES))
    cum[1:, 1] = np.arange(1, n + 1)
    cum[1:, 2] = np.cumsum(I)
    cum[1:, 3] = np.cumsum(I * I)
    cum[1:, 4] = np.cumsum(L)
    cum[:, 0] = 1.0
    return cum


def optimal_split(requests: Sequence[Tuple[float, float]],
                  qoe: QoEModel) -> Tuple[int, float]:
    """requests: (input_len, current_len) pairs. Returns (split index b,
    boundary length R[b]) minimizing Q^{R[:i]} + Q^{R[i:]} over the
    length-sorted list."""
    arr = np.asarray(requests, np.float64)
    order = np.argsort(arr[:, 1], kind="stable")
    I = arr[order, 0]
    L = arr[order, 1]
    n = len(I)
    cum = _prefix_features(I, L)
    total = cum[n]
    best_q, best_i = np.inf, 0
    for i in range(n + 1):
        left = cum[i]
        right = total - cum[i]
        right[0] = 1.0
        q = qoe.batch_q_from_F(left) + qoe.batch_q_from_F(right)
        if q < best_q:
            best_q, best_i = q, i
    boundary = L[min(best_i, n - 1)] if n else 0.0
    return best_i, float(boundary)


@dataclasses.dataclass
class BoundaryRefiner:
    """Per-instance boundary state machine (one per stage boundary)."""
    qoe: QoEModel
    boundary: float                  # seeded from the offline plan (§4.3)
    ema: float = 0.3                 # smoothing weight for the new sample
    min_requests: int = 5            # low-traffic freeze threshold
    history: List[float] = dataclasses.field(default_factory=list)

    def refine(self, own: Sequence[Tuple[float, float]],
               successors: Sequence[Sequence[Tuple[float, float]]]) -> float:
        """own: this instance's (I, L) pairs; successors: one list per
        successor instance. Returns the (possibly unchanged) boundary."""
        merged = list(own)
        if successors:
            # union of successor requests divided evenly by successor count
            all_succ = sorted((tuple(r) for s in successors for r in s),
                              key=lambda r: r[1])
            share = divide_evenly(np.asarray(all_succ, np.float64).reshape(
                -1, 2) if all_succ else np.zeros((0, 2)), len(successors))
            merged.extend((float(a), float(b)) for a, b in share)
        if len(merged) < self.min_requests:      # freeze under low traffic
            self.history.append(self.boundary)
            return self.boundary
        _, raw = optimal_split(merged, self.qoe)
        self.boundary = (1 - self.ema) * self.boundary + self.ema * raw
        self.history.append(self.boundary)
        return self.boundary


# --- naïve baselines for the Fig.-15 ablation -----------------------------
def quantity_based_split(requests: Sequence[Tuple[float, float]]) -> float:
    """Balance the *number* of requests per side."""
    L = np.sort(np.asarray([r[1] for r in requests], np.float64))
    if not len(L):
        return 0.0
    return float(L[len(L) // 2])


def memory_based_split(requests: Sequence[Tuple[float, float]]) -> float:
    """Balance per-side memory (Σ current length ≈ KV bytes)."""
    L = np.sort(np.asarray([r[1] for r in requests], np.float64))
    if not len(L):
        return 0.0
    cum = np.cumsum(L)
    i = int(np.searchsorted(cum, cum[-1] / 2))
    return float(L[min(i, len(L) - 1)])
