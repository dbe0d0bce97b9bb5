"""The port's copy of the model part of ``repro.core.qoe``
(framework-free); the profiling fit and its error reports are not
copied: the port's server takes a fitted model.

QoE model (paper §4.1).

Per-request quality under a steady batch:
    Q = Σ_k D_k F_k,  F = [1, n, ΣI_i, ΣI_i², ΣL_i]
(normalized latency — end-to-end latency / output length). Batch QoE is
Q^B = n · Q₁ (Eq. 1).

Fitting follows §4.1: profile (length-bucket × batch-size) runs keeping B
requests in flight, extract each request's normalized latency and its
average batch loads F_k, then least-squares D against F. The profiling
*source* in this repo is the discrete-event simulator (whose ground-truth
cost function includes the kernel-derived heterogeneity tax the QoE model
deliberately does NOT know about — same model/reality separation as the
paper's fitted model vs. the real GPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np

NUM_FEATURES = 5


@dataclasses.dataclass
class QoEModel:
    D: np.ndarray  # [5]

    def batch_q_from_F(self, F: np.ndarray) -> float:
        """Q^B = n · (D · F) of a request set with features F; empty -> 0."""
        n = F[1]
        if n <= 0:
            return 0.0
        return n * float(self.D @ F)
