"""The port's copy of ``repro.core.partition`` (framework-free), without
the §6.5 cost-estimate helper.

Length-aware stage partition (paper §4.2).

DP over (stages s, instances e, cut point l):

    f[s,e,l] = min_{e',l'}  f[s-1,e',l'] + (e-e')·Q^{n_{l',l}/(e-e')} + c_{l'}

Three solvers:
  * ``full_dp``       — the exact recursion over exponential buckets,
                        O(E² · S · nb²) with O(1) prefix-sum features.
  * ``two_phase``     — the paper's optimized heuristic: a 1-instance-per-
                        stage chain DP (O(E·nb²)), then greedy adjacent-stage
                        merges by max positive merge gain.

Even division of a request set among m instances scales every extensive
feature by 1/m (the paper's sorted every-m-th-element division — footnote 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch.core.qoe import QoEModel
from repro_torch.core.workload_stats import WorkloadStats

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Stage:
    lo: float              # serving range [lo, hi)
    hi: float
    num_instances: int


@dataclasses.dataclass
class PipelinePlan:
    stages: List[Stage]
    quality: float

    def stage_for_length(self, length: float) -> int:
        """Earliest stage whose range covers ``length`` (§3.2 routing)."""
        for i, st in enumerate(self.stages):
            if length < st.hi:
                return i
        return len(self.stages) - 1

    @property
    def num_instances(self) -> int:
        return sum(s.num_instances for s in self.stages)

    def boundaries(self) -> List[float]:
        return [s.hi for s in self.stages[:-1]]


def _stage_q(stats: WorkloadStats, qoe: QoEModel, j_lo: int, j_hi: int,
             m: int) -> float:
    """(e−e')·Q^{n/(e−e')}: m instances evenly sharing bucket range."""
    F = stats.range_features(j_lo, j_hi)
    if F[1] <= 0:
        return 0.0
    return m * qoe.batch_q_from_F(F / m)


def _cut_cost(stats: WorkloadStats, j: int, kv_bytes_per_token: float,
              bandwidth: float, weight: float = 1.0) -> float:
    """c_{l'}: volume of sequence fragments straddling the cut / bandwidth."""
    if j == 0 or j >= len(stats.edges):
        return 0.0
    tokens = stats.edge_crossings(j) * stats.edges[j]
    return weight * tokens * kv_bytes_per_token / bandwidth


def full_dp(stats: WorkloadStats, E: int, qoe: QoEModel, *,
            kv_bytes_per_token: float = 2e5, bandwidth: float = 25e9,
            max_stages: Optional[int] = None) -> PipelinePlan:
    nb = stats.nb
    S = min(max_stages or E, E)
    # f[s][e][l]: best quality, s stages, e instances, covering buckets [0, l)
    f = np.full((S + 1, E + 1, nb + 1), INF)
    arg = np.full((S + 1, E + 1, nb + 1, 2), -1, dtype=np.int64)
    f[0, 0, 0] = 0.0
    for s in range(1, S + 1):
        for e in range(s, E + 1):
            for l in range(s, nb + 1):
                best, be, bl = INF, -1, -1
                for e_prev in range(s - 1, e):
                    m = e - e_prev
                    for l_prev in range(s - 1, l):
                        prev = f[s - 1, e_prev, l_prev]
                        if prev == INF:
                            continue
                        q = _stage_q(stats, qoe, l_prev, l, m)
                        c = _cut_cost(stats, l_prev, kv_bytes_per_token,
                                      bandwidth)
                        val = prev + q + c
                        if val < best:
                            best, be, bl = val, e_prev, l_prev
                f[s, e, l] = best
                arg[s, e, l] = (be, bl)
    # best over all stage counts with all E instances, full length coverage
    s_best = int(np.argmin(f[1:, E, nb])) + 1
    quality = float(f[s_best, E, nb])
    # backtrack
    stages: List[Stage] = []
    s, e, l = s_best, E, nb
    while s > 0:
        e_prev, l_prev = arg[s, e, l]
        stages.append(Stage(lo=float(stats.edges[l_prev]),
                            hi=float(stats.edges[l]) if l < nb else INF,
                            num_instances=e - e_prev))
        s, e, l = s - 1, int(e_prev), int(l_prev)
    stages.reverse()
    stages[-1] = dataclasses.replace(stages[-1], hi=INF)
    return PipelinePlan(stages=stages, quality=quality)


def _chain_dp(stats: WorkloadStats, E: int, qoe: QoEModel,
              kv_bytes_per_token: float, bandwidth: float) -> List[Stage]:
    """Phase 1: exactly one instance per stage, E stages."""
    nb = stats.nb
    f = np.full((E + 1, nb + 1), INF)
    arg = np.full((E + 1, nb + 1), -1, dtype=np.int64)
    f[0, 0] = 0.0
    for s in range(1, E + 1):
        for l in range(s, nb + 1):
            best, bl = INF, -1
            for l_prev in range(s - 1, l):
                prev = f[s - 1, l_prev]
                if prev == INF:
                    continue
                val = (prev + _stage_q(stats, qoe, l_prev, l, 1)
                       + _cut_cost(stats, l_prev, kv_bytes_per_token,
                                   bandwidth))
                if val < best:
                    best, bl = val, l_prev
            f[s, l] = best
            arg[s, l] = bl
    stages: List[Stage] = []
    s, l = E, nb
    while s > 0:
        l_prev = int(arg[s, l])
        stages.append(Stage(float(stats.edges[l_prev]),
                            float(stats.edges[l]) if l < nb else INF, 1))
        s, l = s - 1, l_prev
    stages.reverse()
    return stages


def two_phase(stats: WorkloadStats, E: int, qoe: QoEModel, *,
              kv_bytes_per_token: float = 2e5,
              bandwidth: float = 25e9) -> PipelinePlan:
    """Paper's optimized solver: chain DP + greedy adjacent merges."""
    stages = _chain_dp(stats, E, qoe, kv_bytes_per_token, bandwidth)
    edges = list(stats.edges)

    def jdx(x: float) -> int:
        if x == INF:
            return stats.nb
        return int(np.searchsorted(stats.edges, x))

    def stage_cost(st: Stage) -> float:
        return _stage_q(stats, qoe, jdx(st.lo), jdx(st.hi), st.num_instances)

    def boundary_cost(st: Stage) -> float:
        return _cut_cost(stats, jdx(st.lo), kv_bytes_per_token, bandwidth)

    while len(stages) > 1:
        # merge gain for each adjacent pair (naive O(E) scan per §4.2)
        best_gain, best_i = 0.0, -1
        for i in range(len(stages) - 1):
            a, b = stages[i], stages[i + 1]
            before = stage_cost(a) + stage_cost(b) + boundary_cost(b)
            merged = Stage(a.lo, b.hi, a.num_instances + b.num_instances)
            gain = before - stage_cost(merged)
            if gain > best_gain:
                best_gain, best_i = gain, i
        if best_i < 0:
            break
        a, b = stages[best_i], stages[best_i + 1]
        stages[best_i:best_i + 2] = [
            Stage(a.lo, b.hi, a.num_instances + b.num_instances)]

    total = sum(stage_cost(s) for s in stages)
    total += sum(boundary_cost(s) for s in stages[1:])
    return PipelinePlan(stages=stages, quality=total)
