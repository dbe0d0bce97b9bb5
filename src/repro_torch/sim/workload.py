"""Workload generation: ShareGPT-shaped length distributions + Poisson
arrivals (paper §6.1).

The real ShareGPT trace is offline-unavailable here; the generator
reproduces its documented shape — a log-normal body of short/medium
dialogue turns with a Pareto long-context tail (paper Fig. 1 skew),
truncated at the 128K context window.

The port's copy of the part of ``repro.sim.workload`` its launcher and
server replay (framework-free): the ShareGPT-shaped spec and its long-tail
variant. The shared-prefix, SLO-mix and trace-file generators are not
copied yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

MAX_CONTEXT = 131_072


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    arrival: float
    input_len: int
    output_len: int
    # shared-prefix identity (DESIGN.md §Prefix cache): requests with the
    # same non-negative ``prefix_group`` share their first ``prefix_len``
    # prompt tokens (a system prompt / earlier conversation turns). -1 =
    # no shared prefix. The simulator's group-granular cache model and the
    # server replay (literal shared tokens) both key on these.
    prefix_group: int = -1
    prefix_len: int = 0
    # SLO service class (repro_torch.sched.slo.SLO_CLASSES): drives queue
    # ordering and preemption eligibility in both sim and real engines.
    slo_class: str = "standard"

    @property
    def final_len(self) -> int:
        return self.input_len + self.output_len


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    rate: float                    # Poisson arrivals/s
    duration: float                # seconds of arrivals
    seed: int = 0
    # log-normal body (ShareGPT-ish medians ~ 700 in / 250 out)
    in_mu: float = 6.3
    in_sigma: float = 1.3
    out_mu: float = 5.3
    out_sigma: float = 1.0
    # Pareto long-context tail
    tail_frac: float = 0.06
    tail_alpha: float = 1.1
    tail_scale: float = 8000.0
    # distribution drift (paper §4.3 motivation): in_mu shifts by drift_mu
    # over the run -> the offline plan goes stale, refinement must adapt
    drift_mu: float = 0.0
    max_context: int = MAX_CONTEXT


def sample_lengths(spec: WorkloadSpec, n: int,
                   rng: np.random.Generator,
                   phase: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    mu = spec.in_mu + (spec.drift_mu * phase if phase is not None else 0.0)
    ins = rng.lognormal(mu, spec.in_sigma, n)
    tail = rng.random(n) < spec.tail_frac
    pareto = spec.tail_scale * (1 + rng.pareto(spec.tail_alpha, n))
    ins = np.where(tail, pareto, ins)
    outs = rng.lognormal(spec.out_mu, spec.out_sigma, n)
    ins = np.clip(ins, 16, spec.max_context - 64).astype(np.int64)
    outs = np.clip(outs, 8, None).astype(np.int64)
    outs = np.minimum(outs, spec.max_context - ins)
    return ins, outs


def generate(spec: WorkloadSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    n = max(1, rng.poisson(spec.rate * spec.duration))
    arrivals = np.sort(rng.uniform(0.0, spec.duration, n))
    ins, outs = sample_lengths(spec, n, rng,
                               phase=arrivals / max(spec.duration, 1e-9))
    return [Request(i, float(arrivals[i]), int(ins[i]), int(outs[i]))
            for i in range(n)]


def longtail_spec(rate: float, duration: float, *, seed: int = 0,
                  tail_frac: float = 0.08,
                  max_context: int = MAX_CONTEXT) -> WorkloadSpec:
    """The scenario chunked prefill exists for (paper §2.1 / Fig. 1): a
    log-normal body of ordinary dialogue turns with a heavy 32K–128K
    *prompt* tail — long-context requests whose monolithic prefill would
    freeze a whole instance for seconds. The Pareto tail is scaled so the
    bulk of tail prompts lands in [32K, 128K] (alpha 1.05 ⇒ a 128K-capped
    median around 60K)."""
    return WorkloadSpec(rate=rate, duration=duration, seed=seed,
                        tail_frac=tail_frac, tail_alpha=1.05,
                        tail_scale=32_000.0, max_context=max_context)
