"""The port's QoE profiling and experiment driver against the JAX
package's, on the CPU: ``profile_point`` samples, the fitted ``D`` of
``profile_and_fit`` on a cut sweep, the pipeline plans and the policies
``make_policy`` builds, all priced on the reference's TPU v5e constants
(the port's ``Chip`` built here from ``repro.kernels.cost``); and the
port's own H100 profile: ``fitted_qoe`` caches per chip, its fit is a
different model, and ``tools/simulate_cluster_torch.py`` runs."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.kernels.cost as jcost  # noqa: E402
import repro.sim.costmodel as jcm  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.sim import experiment as jexp  # noqa: E402
from repro.sim import instance as jinst  # noqa: E402
from repro.sim import profiler as jprof  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.sim import costmodel as cm  # noqa: E402
from repro_torch.sim import experiment as exp  # noqa: E402
from repro_torch.sim import instance as inst  # noqa: E402
from repro_torch.sim import profiler as prof  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
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
# a cut of the §4.1 sweep: three buckets, three batch sizes
BUCKETS = ((128, 256), (1024, 2048), (8192, 16384))
BATCHES = (1, 4, 16)


def profiles(arch=ARCH, **kw):
    return (jcm.profile_from_config(jax_get_config(arch), **kw),
            cm.profile_from_config(get_config(arch), chip=TPU, **kw))


@pytest.mark.parametrize("bucket", BUCKETS, ids=str)
@pytest.mark.parametrize("batch", BATCHES)
def test_profile_point_equals_reference(bucket, batch):
    j, t = profiles()
    jF, jQ = jprof.profile_point(j, bucket, batch, horizon_s=4.0, seed=batch)
    tF, tQ = prof.profile_point(t, bucket, batch, horizon_s=4.0, seed=batch)
    assert len(tQ) > 0
    assert np.array_equal(tF, jF) and np.array_equal(tQ, jQ)


@pytest.mark.parametrize("arch,kw", [
    (ARCH, {}), (ARCH, dict(fused_backend=True)),
    (ARCH, dict(ragged_backend=True, kv_dtype="int8")),
    ("qwen2.5-14b", dict(tp=2)), ("zamba2-2.7b", {})],
    ids=["llama", "llama-fused", "llama-ragged-int8", "qwen-tp2", "zamba"])
def test_profile_and_fit_equals_reference(arch, kw):
    j, t = profiles(arch, **kw)
    jm, jF, jQ = jprof.profile_and_fit(j, buckets=BUCKETS,
                                       batch_sizes=BATCHES, horizon_s=4.0,
                                       return_samples=True)
    tm, tF, tQ = prof.profile_and_fit(t, buckets=BUCKETS,
                                      batch_sizes=BATCHES, horizon_s=4.0,
                                      return_samples=True)
    assert np.array_equal(tF, jF) and np.array_equal(tQ, jQ)
    np.testing.assert_allclose(tm.D, jm.D, rtol=1e-12, atol=0.0)


def test_fitted_qoe_and_plans_equal_reference():
    jq = jexp.fitted_qoe(ARCH)
    tq = exp.fitted_qoe(ARCH, chip=TPU)
    np.testing.assert_allclose(tq.D, jq.D, rtol=1e-12, atol=0.0)
    assert exp.fitted_qoe(ARCH, chip=TPU) is tq          # cached per chip
    for E in (2, 4, 8):
        for solver in ("two_phase", "full_dp"):
            jp = jexp.plan_pipeline(ARCH, jq, E, solver=solver)
            tp = exp.plan_pipeline(ARCH, tq, E, solver=solver, chip=TPU)
            assert [dataclasses.astuple(s) for s in tp.stages] == \
                [dataclasses.astuple(s) for s in jp.stages]
            assert tp.quality == jp.quality
        jc, tc = jexp.chain_plan(ARCH, jq, E), exp.chain_plan(ARCH, tq, E,
                                                               chip=TPU)
        assert [dataclasses.astuple(s) for s in tc.stages] == \
            [dataclasses.astuple(s) for s in jc.stages]
        assert [dataclasses.astuple(s) for s in
                exp.no_pipeline_plan(E).stages] == \
            [dataclasses.astuple(s) for s in jexp.no_pipeline_plan(E).stages]


@pytest.mark.parametrize("kind", ("round-robin", "llumnix", "cascade"))
def test_make_policy_equals_reference(kind):
    j = jexp.make_policy(kind, ARCH, 4)
    t = exp.make_policy(kind, ARCH, 4, chip=TPU)
    assert t.name == j.name
    if kind == "cascade":
        assert np.array_equal(t.qoe.D, j.qoe.D)
        assert [dataclasses.astuple(s) for s in t.plan.stages] == \
            [dataclasses.astuple(s) for s in j.plan.stages]


def test_instance_constants_equal_reference():
    assert (inst.BATCH_CAP, inst.KV_BLOCK_SIZE) == \
        (jinst.BATCH_CAP, jinst.KV_BLOCK_SIZE)


def test_h100_fit_is_its_own():
    h = exp.fitted_qoe(ARCH)
    assert exp.fitted_qoe(ARCH, chip=cost.H100) is not None
    assert np.all(np.isfinite(h.D)) and h.D[0] > 0
    assert not np.array_equal(h.D, exp.fitted_qoe(ARCH, chip=TPU).D)


def test_simulate_cluster_tool_runs():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "simulate_cluster_torch.py"),
         "--rate", "6", "--duration", "4", "--instances", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert f"simulated on {cost.H100.name}" in out.stdout
    for kind in ("round-robin", "llumnix", "cascade"):
        assert kind in out.stdout
    assert "cascade vs round-robin" in out.stdout
