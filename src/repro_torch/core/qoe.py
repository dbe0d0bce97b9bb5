"""The port's copy of ``repro.core.qoe``, whole (framework-free).

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
from typing import Iterable, Sequence

import numpy as np

NUM_FEATURES = 5


def batch_features(inputs: Sequence[float], lengths: Sequence[float],
                   weights: Sequence[float] | None = None) -> np.ndarray:
    """F = [1, n, ΣI, ΣI², ΣL] for a request set (optionally weighted —
    weights are residency fractions when sets are built from trajectories)."""
    I = np.asarray(inputs, np.float64)
    L = np.asarray(lengths, np.float64)
    w = np.ones_like(I) if weights is None else np.asarray(weights, np.float64)
    return np.array([1.0, w.sum(), (w * I).sum(), (w * I * I).sum(),
                     (w * L).sum()])


@dataclasses.dataclass
class QoEModel:
    D: np.ndarray  # [5]

    def request_q(self, F: np.ndarray) -> float:
        """Normalized latency of one request under batch loads F."""
        return float(self.D @ F)

    def batch_q(self, inputs, lengths, weights=None) -> float:
        """Q^B = n · Q₁ (Eq. 1). Empty set -> 0."""
        F = batch_features(inputs, lengths, weights)
        n = F[1]
        if n <= 0:
            return 0.0
        return n * self.request_q(F)

    def batch_q_from_F(self, F: np.ndarray) -> float:
        n = F[1]
        if n <= 0:
            return 0.0
        return n * float(self.D @ F)

    def save(self, path: str) -> None:
        np.save(path, self.D)

    @classmethod
    def load(cls, path: str) -> "QoEModel":
        return cls(np.load(path))


def fit_qoe(F_samples: np.ndarray, Q_samples: np.ndarray,
            ridge: float = 1e-8, nonneg: bool = True) -> QoEModel:
    """Least-squares fit of D (§4.1):  argmin Σ_j (Q^(j) − Σ_k D_k F_k^(j))².

    F_samples [N, 5]; Q_samples [N]. A whisper of ridge keeps the normal
    equations well-posed when a profiling sweep leaves features collinear
    (e.g. fixed batch size makes F1 constant). With ``nonneg`` the fit is
    projected onto D ≥ 0 via an active-set loop — all five coefficients are
    physically nonnegative costs, and collinear ΣI/ΣL columns otherwise
    trade sign freely.
    """
    F = np.asarray(F_samples, np.float64)
    Q = np.asarray(Q_samples, np.float64)
    # column scaling for conditioning (I² reaches 1e10 at 100k lengths)
    scale = np.maximum(np.abs(F).max(axis=0), 1e-12)
    Fs = F / scale
    k = F.shape[1]
    active = np.ones(k, bool)
    for _ in range(k + 1):
        A = Fs[:, active].T @ Fs[:, active] + ridge * np.eye(active.sum())
        b = Fs[:, active].T @ Q
        sol = np.linalg.solve(A, b)
        if not nonneg or (sol >= 0).all():
            break
        idx = np.flatnonzero(active)
        active[idx[sol < 0]] = False
        if not active.any():
            sol = np.zeros(0)
            break
    D = np.zeros(k)
    D[active] = sol
    if nonneg:
        D = np.maximum(D, 0.0)
    return QoEModel(D / scale)


def relative_errors(model: QoEModel, F_samples: np.ndarray,
                    Q_samples: np.ndarray) -> np.ndarray:
    """Per-request relative prediction error (paper Fig. 13 metric)."""
    pred = np.asarray(F_samples, np.float64) @ model.D
    Q = np.asarray(Q_samples, np.float64)
    return (pred - Q) / np.maximum(np.abs(Q), 1e-12)


def static_baseline_errors(F_samples: np.ndarray,
                           Q_samples: np.ndarray) -> np.ndarray:
    """The paper's Fig.-13 baseline: always predict the global mean."""
    Q = np.asarray(Q_samples, np.float64)
    return (Q.mean() - Q) / np.maximum(np.abs(Q), 1e-12)
