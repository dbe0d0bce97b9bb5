"""The port's copy of ``repro.core.workload_stats``, whole
(framework-free).

Bucketed workload statistics for pipeline planning (paper §4.2).

Sequence-length space is cut into exponentially growing tiers (the paper's
first DP optimization — O(log L) candidate cut points). Each request
(input I, output O) sweeps lengths [I, I+O) during decode; it contributes
to every bucket its trajectory crosses, weighted by residency fraction, so
bucket-range QoE features F = [1, n, ΣI, ΣI², ΣL] come from O(1) prefix
sums.

``cross[j]`` counts requests whose trajectory straddles edge j — the
volume behind the inter-stage migration cost c_{l'}.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.qoe import NUM_FEATURES


def exp_bucket_edges(max_len: int, first: int = 128,
                     growth: float = 2.0) -> np.ndarray:
    """[0, first, first·g, …, ≥ max_len] — O(log L) edges."""
    edges = [0.0, float(first)]
    while edges[-1] < max_len:
        edges.append(edges[-1] * growth)
    return np.asarray(edges)


@dataclasses.dataclass
class WorkloadStats:
    edges: np.ndarray          # [nb+1] bucket boundaries (lengths)
    acc: np.ndarray            # [nb, 5] per-bucket feature accumulators
    cross: np.ndarray          # [nb+1] trajectory crossings per edge
    num_requests: int

    @property
    def nb(self) -> int:
        return len(self.edges) - 1

    # cumulative feature table: cum[j] = Σ acc[:j]
    def __post_init__(self):
        self._cum = np.concatenate(
            [np.zeros((1, NUM_FEATURES)), np.cumsum(self.acc, axis=0)], axis=0)

    def range_features(self, j_lo: int, j_hi: int) -> np.ndarray:
        """F for bucket range [j_lo, j_hi) (edge indices)."""
        F = self._cum[j_hi] - self._cum[j_lo]
        F[0] = 1.0
        return F

    def edge_crossings(self, j: int) -> float:
        return float(self.cross[j])


def build_stats(requests: Sequence[Tuple[int, int]],
                edges: np.ndarray) -> WorkloadStats:
    """requests: iterable of (input_len I, output_len O)."""
    edges = np.asarray(edges, np.float64)
    nb = len(edges) - 1
    acc = np.zeros((nb, NUM_FEATURES))
    cross = np.zeros(nb + 1)
    for I, O in requests:
        I = float(I)
        O = max(float(O), 1.0)
        f = I + O
        lo = np.searchsorted(edges, I, side="right") - 1
        hi = np.searchsorted(edges, f, side="left")
        for j in range(max(lo, 0), min(hi, nb)):
            a, b = edges[j], edges[j + 1]
            seg_lo, seg_hi = max(I, a), min(f, b)
            overlap = seg_hi - seg_lo
            if overlap <= 0:
                continue
            w = overlap / O                      # residency fraction
            l_rep = 0.5 * (seg_lo + seg_hi)      # mean length in bucket
            acc[j] += [0.0, w, w * I, w * I * I, w * l_rep]
        # edge crossings: I < edge < I+O
        j1 = np.searchsorted(edges, I, side="right")
        j2 = np.searchsorted(edges, f, side="left")
        cross[j1:j2 + 1] += (edges[j1:j2 + 1] > I) & (edges[j1:j2 + 1] < f)
    return WorkloadStats(edges=edges, acc=acc, cross=cross,
                         num_requests=len(requests))
