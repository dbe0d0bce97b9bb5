"""The port's discrete-event cluster simulator against the JAX package's,
on the CPU: the same workload on the same policy gives the same summary,
the same per-request times and the same control-plane decision log.

Both are priced on the reference's TPU v5e constants: the port's ``Chip``
is built here from ``repro.kernels.cost`` (block 512, the reference
profile's ``t_fixed``). The four workloads of ``compare_policies`` run at
4 instances and a few seconds of traffic — ShareGPT-shaped, long-tail with
a chunk budget, shared-prefix with a host KV tier under tight capacity (so
blocks demote and promote), the SLO mix with preemption (so requests are
preempted and recomputed) — plus a chaos run (a crash, a rejoin, lost
transfers), a tensor-parallel run and a mixed-tp cluster. On the port's
own ``H100`` a cascade run completes every request."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.kernels.cost as jcost  # noqa: E402
import repro.sim.costmodel as jcm  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.control.faults import FaultSpec as JFaultSpec  # noqa: E402
from repro.core.partition import PipelinePlan as JPlan  # noqa: E402
from repro.core.partition import Stage as JStage  # noqa: E402
from repro.sim import cluster as jcluster  # noqa: E402
from repro.sim import experiment as jexp  # noqa: E402
from repro.sim import workload as jwl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.control.faults import FaultSpec  # noqa: E402
from repro_torch.core.partition import PipelinePlan, Stage  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.sim import cluster  # noqa: E402
from repro_torch.sim import costmodel as cm  # noqa: E402
from repro_torch.sim import experiment as exp  # noqa: E402
from repro_torch.sim import workload as wl  # noqa: E402

TPU = cost.Chip(
    name="reference constants", peak_flops=jcost.PEAK_FLOPS,
    hbm_bw=jcost.HBM_BW, link_bw=jcost.ICI_BW,
    launch_overhead_s=jcost.LAUNCH_OVERHEAD_S,
    skip_overhead_s=jcost.SKIP_OVERHEAD_S,
    host_staging_bw=jcost.HOST_STAGING_BW,
    staging_overhead_s=jcost.LAUNCH_OVERHEAD_S,
    attn_block=jcost.AttnSpec(1, 1, 1).block_s,
    t_fixed_s=jcm.HardwareProfile.__dataclass_fields__["t_fixed"].default)
ARCH = "llama3.2-3b"
E = 4

# workload -> (requests of a workload module, duration, run_policy kwargs)
WORKLOADS = {
    "sharegpt": (lambda m: m.generate(m.WorkloadSpec(rate=8.0, duration=5.0,
                                                     seed=1)), 5.0, {}),
    "longtail": (lambda m: m.generate(m.longtail_spec(3.0, 5.0, seed=2)),
                 5.0, dict(prefill_token_budget=512)),
    "shared_prefix": (lambda m: m.generate_shared_prefix(
        m.shared_prefix_spec(8.0, 6.0, seed=3)), 6.0,
        dict(prefill_token_budget=512, host_kv_budget=2048,
             capacity_tokens=3000.0)),
    "slo": (lambda m: m.generate_slo(m.slo_spec(14.0, 6.0, seed=7,
                                                max_context=8192)), 6.0,
            dict(prefill_token_budget=512, capacity_tokens=7000.0,
                 preemption=True)),
}
# what each workload must exercise in the reference run
EXPECT = {"shared_prefix": ("cache_demotions", "cache_promotions"),
          "slo": ("preemptions", "preempt_recomputes")}


@pytest.fixture(scope="module")
def fitted():
    """(reference QoE, port QoE, reference plan, port plan) at E = 4."""
    jq = jexp.fitted_qoe(ARCH)
    tq = exp.fitted_qoe(ARCH, chip=TPU)
    assert np.array_equal(jq.D, tq.D)
    jp = jexp.plan_pipeline(ARCH, jq, E)
    tp = exp.plan_pipeline(ARCH, tq, E, chip=TPU)
    assert [dataclasses.astuple(s) for s in tp.stages] == \
        [dataclasses.astuple(s) for s in jp.stages]
    return jq, tq, jp, tp


def per_request(res):
    return sorted((r.req.req_id, r.first_token_t, r.finish_t, r.generated,
                   r.rejected, r.failed, r.redispatches)
                  for r in res.completed)


def same_result(j, t):
    assert t.summary() == j.summary()
    assert per_request(t) == per_request(j)
    assert t.preemption_stats() == j.preemption_stats()
    assert t.slo_summary() == j.slo_summary()
    assert np.array_equal(t.output_tokens_by_instance(),
                          j.output_tokens_by_instance())
    if j.stage_of_instance is not None:
        assert t.stage_cv() == j.stage_cv()


def policies(kind, fitted):
    jq, tq, jp, tp = fitted
    if kind == "cascade":
        return (jcluster.CascadePolicy(jp, jq), cluster.CascadePolicy(tp, tq))
    return (jexp.make_policy(kind, ARCH, E), exp.make_policy(kind, ARCH, E,
                                                             chip=TPU))


@pytest.mark.parametrize("kind", ("round-robin", "llumnix", "cascade"))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_run_policy_equals_reference(workload, kind, fitted):
    make, duration, kw = WORKLOADS[workload]
    jreqs, treqs = make(jwl), make(wl)
    assert [dataclasses.astuple(r) for r in treqs] == \
        [dataclasses.astuple(r) for r in jreqs]
    jpol, tpol = policies(kind, fitted)
    j = jexp.run_policy(ARCH, jpol, jreqs, duration, E=E, **kw)
    t = exp.run_policy(ARCH, tpol, treqs, duration, E=E, chip=TPU, **kw)
    same_result(j, t)
    if kind == "cascade":
        assert tpol.plane.decisions == jpol.plane.decisions
        assert len(jpol.plane.decisions) > len(jreqs)   # not routes alone
        stats = dict(j.summary(), **j.preemption_stats())
        for key in EXPECT.get(workload, ()):
            assert stats[key] > 0, key


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_compare_policies_equals_reference(workload):
    kw = dict(E=E, seed=5, workload=workload)
    if workload == "shared_prefix":
        kw.update(capacity_tokens=3000.0, host_kv_budget=2048)
    j = jexp.compare_policies(ARCH, 8.0, 4.0, **kw)
    t = exp.compare_policies(ARCH, 8.0, 4.0, chip=TPU, **kw)
    assert list(t) == list(j)
    for kind in j:
        same_result(j[kind], t[kind])


def _chaos(mod_cluster, plan, qoe, spec, reqs, tps=None):
    prof = (cm.profile_from_config(get_config(ARCH), chip=TPU)
            if mod_cluster is cluster
            else jcm.profile_from_config(jax_get_config(ARCH)))
    cfg = mod_cluster.ClusterConfig(num_instances=E, capacity_tokens=60_000.0,
                                    seed=0, faults=spec, tps=tps,
                                    suspect_after_s=1.0, dead_after_s=2.0,
                                    migration_timeout_s=0.5)
    pol = mod_cluster.CascadePolicy(plan, qoe)
    res = mod_cluster.Cluster(prof, pol, cfg).run(reqs, 8.0)
    return pol, res


def test_chaos_run_equals_reference(fitted):
    """A crash with residents, its rejoin and lost transfers: the same
    heartbeat verdicts, redispatches, retries and downtime."""
    jq, tq, _, _ = fitted
    jp = JPlan([JStage(0.0, 1024.0, 2), JStage(1024.0, float("inf"), 2)],
               0.0)
    tp = PipelinePlan([Stage(0.0, 1024.0, 2), Stage(1024.0, float("inf"), 2)],
                      0.0)
    kw = dict(seed=3, crashes=((2, 0.8),), rejoins=((2, 5.0),),
              transfer_loss_p=0.3)
    jreqs = jwl.generate(jwl.WorkloadSpec(rate=6.0, duration=4.0, seed=4))
    treqs = wl.generate(wl.WorkloadSpec(rate=6.0, duration=4.0, seed=4))
    jpol, j = _chaos(jcluster, jp, jq, JFaultSpec(**kw), jreqs)
    tpol, t = _chaos(cluster, tp, tq, FaultSpec(**kw), treqs)
    same_result(j, t)
    assert tpol.plane.decisions == jpol.plane.decisions
    log = jpol.plane.decisions
    assert ("dead", 2) in log and ("rejoin", 2) in log
    assert j.summary()["redispatched"] > 0 and j.retries > 0


def test_faulty_run_policy_equals_reference(fitted):
    _, _, jp, tp = fitted
    kw = dict(seed=0, crashes=((1, 1.0),), rejoins=((1, 6.0),),
              transfer_loss_p=0.3)
    jreqs = jwl.generate(jwl.WorkloadSpec(rate=8.0, duration=10.0, seed=5))
    treqs = wl.generate(wl.WorkloadSpec(rate=8.0, duration=10.0, seed=5))
    jpol, tpol = policies("cascade", fitted)
    j = jexp.run_policy(ARCH, jpol, jreqs, 10.0, E=E,
                        faults=JFaultSpec(**kw))
    t = exp.run_policy(ARCH, tpol, treqs, 10.0, E=E, faults=FaultSpec(**kw),
                       chip=TPU)
    same_result(j, t)
    assert tpol.plane.decisions == jpol.plane.decisions
    assert j.retries > 0


@pytest.mark.parametrize("tp", (2, 4))
def test_tensor_parallel_run_equals_reference(tp, fitted):
    jreqs = jwl.generate(jwl.WorkloadSpec(rate=8.0, duration=5.0, seed=6))
    treqs = wl.generate(wl.WorkloadSpec(rate=8.0, duration=5.0, seed=6))
    jpol, tpol = policies("cascade", fitted)
    j = jexp.run_policy(ARCH, jpol, jreqs, 5.0, E=E, tp=tp,
                        prefill_token_budget=512)
    t = exp.run_policy(ARCH, tpol, treqs, 5.0, E=E, tp=tp, chip=TPU,
                       prefill_token_budget=512)
    same_result(j, t)
    assert tpol.plane.decisions == jpol.plane.decisions


def test_mixed_tp_cluster_equals_reference(fitted):
    jq, tq, jp, tp = fitted
    jreqs = jwl.generate(jwl.WorkloadSpec(rate=8.0, duration=4.0, seed=8))
    treqs = wl.generate(wl.WorkloadSpec(rate=8.0, duration=4.0, seed=8))
    jpol, j = _chaos(jcluster, jp, jq, None, jreqs, tps=(1, 2, 1, 2))
    tpol, t = _chaos(cluster, tp, tq, None, treqs, tps=(1, 2, 1, 2))
    same_result(j, t)
    assert tpol.plane.decisions == jpol.plane.decisions


@pytest.mark.parametrize("workload", ("sharegpt", "longtail"))
def test_h100_cascade_completes_every_request(workload):
    make, duration, kw = WORKLOADS[workload]
    reqs = make(wl)
    pol = exp.make_policy("cascade", ARCH, E)
    res = exp.run_policy(ARCH, pol, reqs, duration, E=E, **kw)
    s = res.summary()
    assert s["completed"] == s["submitted"] == len(reqs)
    assert s["rejected"] == s["failed"] == 0
    assert np.isfinite([s["ttft_mean"], s["tpot_mean"]]).all()
    # the H100's faster steps serve the same trace no slower than the
    # reference's chip does
    jres = jexp.run_policy(ARCH, jexp.make_policy("cascade", ARCH, E), make(jwl),
                           duration, E=E, **kw)
    assert s["tpot_mean"] < jres.summary()["tpot_mean"]
