"""QoE-model profiling (paper §4.1 fitting procedure) — the port's copy
of ``repro.sim.profiler``, whole.

Partition lengths into exponential buckets, and for each (bucket, batch
size B) keep exactly B requests in flight on one instance for a fixed
horizon — whenever one completes, another is enqueued. From the trace,
each request yields its normalized latency Q and its average batch loads
F_k over its lifetime; least squares on (F, Q) gives D.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.qoe import QoEModel, fit_qoe
from repro_torch.sim.costmodel import HardwareProfile
from repro_torch.sim.events import EventQueue
from repro_torch.sim.instance import Instance, SimRequest
from repro_torch.sim.workload import Request


def profile_point(profile: HardwareProfile, length_range: Tuple[int, int],
                  batch_size: int, *,
                  output_len: Tuple[int, int] = (128, 320),
                  horizon_s: float = 60.0, capacity: float = 2e6,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Keep ``batch_size`` in flight with inputs from ``length_range``.
    Output lengths vary across ``output_len`` so ΣL decorrelates from ΣI
    (identifiability of D4 vs D2); the floor follows the paper's
    "discarding those that are too short" (§4.1) — tiny outputs divide
    fixed waits by a small O and blow up normalized-latency variance.
    Returns (F [N,5], Q [N])."""
    rng = np.random.default_rng(seed)
    events = EventQueue()
    inst = Instance(0, profile, capacity, events)
    counter = [0]
    done: List[SimRequest] = []

    def new_request(t: float) -> SimRequest:
        I = int(rng.integers(length_range[0], max(length_range[1],
                                                  length_range[0] + 1)))
        O = int(rng.integers(output_len[0], output_len[1]))
        counter[0] += 1
        return SimRequest(req=Request(counter[0], t, I, O), length=I)

    def on_done(_inst, sr, t):
        done.append(sr)
        if t < horizon_s:
            _inst.enqueue(new_request(t), t)   # keep B in flight

    inst.on_request_done = on_done
    for _ in range(batch_size):
        inst.enqueue(new_request(0.0), 0.0)
    events.run_until(horizon_s * 2)
    while inst.running or inst.waiting:
        if not len(events):
            break
        events.run_until(events.now + horizon_s)

    F = np.asarray([np.asarray(r.feat_sum) / max(r.feat_iters, 1)
                    for r in done])
    Q = np.asarray([r.normalized_latency for r in done])
    return F.reshape(-1, 5), Q


def profile_and_fit(profile: HardwareProfile, *,
                    buckets: Sequence[Tuple[int, int]] = (
                        (128, 256), (256, 512), (512, 1024), (1024, 2048),
                        (2048, 4096), (4096, 8192), (8192, 16384),
                        (16384, 32768)),
                    batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                    horizon_s: float = 20.0,
                    seed: int = 0,
                    return_samples: bool = False):
    """Full §4.1 sweep -> fitted QoEModel (optionally with samples)."""
    Fs, Qs = [], []
    for bi, bucket in enumerate(buckets):
        for B in batch_sizes:
            F, Q = profile_point(profile, bucket, B, horizon_s=horizon_s,
                                 seed=seed + 997 * bi + B)
            if len(Q):
                Fs.append(F)
                Qs.append(Q)
    F_all = np.concatenate(Fs, axis=0)
    Q_all = np.concatenate(Qs, axis=0)
    model = fit_qoe(F_all, Q_all)
    if return_samples:
        return model, F_all, Q_all
    return model
