"""End-to-end experiment driver: profile -> fit QoE -> plan pipeline ->
run all policies on the same workload — the port's copy of
``repro.sim.experiment``. Every entry point takes the ``chip`` its
profiles are priced on (default ``kernels.cost.H100``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.partition import PipelinePlan, Stage, full_dp, two_phase
from repro_torch.core.qoe import QoEModel
from repro_torch.core.workload_stats import build_stats, exp_bucket_edges
from repro_torch.kernels.cost import H100, Chip
from repro_torch.sim.cluster import (CascadePolicy, Cluster, ClusterConfig,
                               LlumnixLikePolicy, Policy, RoundRobinPolicy)
from repro_torch.sim.costmodel import HardwareProfile, profile_from_config
from repro_torch.sim.metrics import SimResult
from repro_torch.sim.profiler import profile_and_fit
from repro_torch.sim.workload import (Request, WorkloadSpec, generate,
                                generate_shared_prefix, generate_slo,
                                longtail_spec, sample_lengths,
                                shared_prefix_spec, slo_spec)


@functools.lru_cache(maxsize=8)
def fitted_qoe(arch: str, tp: int = 1, horizon_s: float = 8.0,
               chip: Chip = H100) -> QoEModel:
    """Profile-and-fit, cached per (arch, tp, horizon, chip)
    (deterministic)."""
    prof = profile_from_config(get_config(arch), chip=chip, tp=tp)
    return profile_and_fit(prof, horizon_s=horizon_s)


def plan_pipeline(arch: str, qoe: QoEModel, E: int, *,
                  planning_requests: Optional[Sequence] = None,
                  seed: int = 1, solver: str = "two_phase",
                  bandwidth: float = 25e9,
                  chip: Chip = H100) -> PipelinePlan:
    """Offline pipeline planning from historical workload statistics."""
    cfg = get_config(arch)
    prof = profile_from_config(cfg, chip=chip)
    if planning_requests is None:
        spec = WorkloadSpec(rate=1.0, duration=1.0, seed=seed)
        rng = np.random.default_rng(seed)
        ins, outs = sample_lengths(spec, 2000, rng)
        planning_requests = list(zip(ins.tolist(), outs.tolist()))
    stats = build_stats(planning_requests, exp_bucket_edges(131_072))
    kvb = prof.kv_bytes_per_token or 2e5
    solve = two_phase if solver == "two_phase" else full_dp
    return solve(stats, E, qoe, kv_bytes_per_token=kvb, bandwidth=bandwidth)


def chain_plan(arch: str, qoe: QoEModel, E: int, *,
               seed: int = 1, chip: Chip = H100) -> PipelinePlan:
    """Fig.-14 'chain' ablation: one instance per pipeline stage — the
    paper's phase-1 DP without the merge phase."""
    from repro_torch.core.partition import _chain_dp
    cfg = get_config(arch)
    prof = profile_from_config(cfg, chip=chip)
    spec = WorkloadSpec(rate=1.0, duration=1.0, seed=seed)
    rng = np.random.default_rng(seed)
    ins, outs = sample_lengths(spec, 2000, rng)
    stats = build_stats(list(zip(ins.tolist(), outs.tolist())),
                        exp_bucket_edges(131_072))
    stages = _chain_dp(stats, E, qoe, prof.kv_bytes_per_token or 2e5, 25e9)
    stages[-1] = Stage(stages[-1].lo, float("inf"), 1)
    return PipelinePlan(stages=stages, quality=float("nan"))


def no_pipeline_plan(E: int) -> PipelinePlan:
    """Fig.-14 'no-pipeline' ablation: all instances in one stage."""
    return PipelinePlan(stages=[Stage(0.0, float("inf"), E)],
                        quality=float("nan"))


def make_policy(kind: str, arch: str, E: int, *, qoe=None, plan=None,
                chip: Chip = H100, **kw) -> Policy:
    if kind == "round-robin":
        return RoundRobinPolicy()
    if kind == "llumnix":
        return LlumnixLikePolicy()
    qoe = qoe or fitted_qoe(arch, chip=chip)
    plan = plan or plan_pipeline(arch, qoe, E, chip=chip)
    return CascadePolicy(plan, qoe, **kw)


def run_policy(arch: str, policy: Policy, requests: Sequence[Request],
               duration: float, *, E: int = 16,
               capacity_tokens: float = 400_000.0, seed: int = 0,
               tp: int = 1, ragged_backend: bool = False,
               bandwidth: float = 25e9,
               prefill_token_budget: Optional[int] = None,
               prefix_cache: bool = True,
               preemption: bool = True,
               host_kv_budget: int = 0,
               faults=None,
               migration_timeout_s: Optional[float] = None,
               chip: Chip = H100) -> SimResult:
    prof = profile_from_config(get_config(arch), chip=chip, tp=tp,
                               ragged_backend=ragged_backend)
    cfg = ClusterConfig(num_instances=E, capacity_tokens=capacity_tokens,
                        seed=seed, bandwidth=bandwidth,
                        prefill_token_budget=prefill_token_budget,
                        prefix_cache=prefix_cache,
                        preemption=preemption,
                        host_kv_budget=host_kv_budget, faults=faults,
                        migration_timeout_s=migration_timeout_s)
    cluster = Cluster(prof, policy, cfg)
    return cluster.run(requests, duration)


def compare_policies(arch: str, rate: float, duration: float, *,
                     E: int = 16, seed: int = 0,
                     capacity_tokens: float = 400_000.0,
                     workload: str = "sharegpt",
                     prefill_token_budget: Optional[int] = None,
                     prefix_cache: bool = True,
                     preemption: bool = True,
                     host_kv_budget: int = 0,
                     kinds: Sequence[str] = ("round-robin", "llumnix",
                                             "cascade"),
                     chip: Chip = H100) -> Dict[str, SimResult]:
    """Same workload, all policies — the Fig. 6/7/10 experiment.

    ``workload="longtail"`` swaps in the 32K–128K-prompt-tail trace
    (``sim.workload.longtail_spec``) and ``prefill_token_budget`` runs the
    instances with chunked mixed iterations — the long-context scenario
    chunked prefill targets. ``workload="shared_prefix"`` runs the
    system-prompt/multi-turn trace (``sim.workload.shared_prefix_spec``)
    with the group-granular prefix-cache mirror — the cascade-vs-baseline
    comparison under prefix caching (``prefix_cache=False`` ablates it).
    ``workload="slo"`` runs the open-loop SLO-class mix with diurnal +
    bursty arrivals (``sim.workload.slo_spec``) — the goodput-under-SLO
    experiment (``preemption=False`` ablates the tiered scheduler back
    to FCFS). ``host_kv_budget`` (tokens per instance) turns on the
    multi-tier KV mirror — idle published prefixes pin device capacity
    until pressure demotes them to a bounded host store, and hits on
    demoted groups pay the promote staging price — so shared_prefix runs
    become tiering policy experiments (DESIGN.md §Multi-tier KV)."""
    if workload == "longtail":
        requests = generate(longtail_spec(rate, duration, seed=seed))
    elif workload == "slo":
        requests = generate_slo(slo_spec(rate, duration, seed=seed))
        if prefill_token_budget is None:
            prefill_token_budget = 512
    elif workload == "shared_prefix":
        requests = generate_shared_prefix(
            shared_prefix_spec(rate, duration, seed=seed))
        if prefill_token_budget is None:        # caching needs chunking
            prefill_token_budget = 512
    else:
        requests = generate(WorkloadSpec(rate=rate, duration=duration,
                                         seed=seed))
    out = {}
    for kind in kinds:
        pol = make_policy(kind if kind != "cascade" else "cascade",
                          arch, E, chip=chip)
        out[kind] = run_policy(arch, pol, requests, duration, E=E,
                               capacity_tokens=capacity_tokens, seed=seed,
                               prefill_token_budget=prefill_token_budget,
                               prefix_cache=prefix_cache,
                               preemption=preemption,
                               host_kv_budget=host_kv_budget, chip=chip)
    return out
