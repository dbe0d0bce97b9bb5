"""The port's MILSServer over torch engines (``flat`` backend, CPU) vs the
JAX MILSServer (``dense`` backend: the same two-call step; both with
preemption off and no host KV tier) on one fixed open-loop trace and the
same weights: identical control-plane decision logs and greedy token streams,
migrations > 0, every engine drained clean. Also the per-step contracts
of the port's engines inside the cluster (at most one d2h and two
attention-bearing forwards per engine step), the summary's keys, and the
launcher on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro_torch.serving.engine as engine_mod  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.partition import PipelinePlan as JaxPlan  # noqa: E402
from repro.core.partition import Stage as JaxStage  # noqa: E402
from repro.core.qoe import QoEModel as JaxQoE  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.request import ServeRequest as JaxRequest  # noqa: E402
from repro.serving.server import MILSServer as JaxServer  # noqa: E402
from repro.serving.server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import PipelinePlan, Stage  # noqa: E402
from repro_torch.core.qoe import QoEModel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.request import ServeRequest  # noqa: E402
from repro_torch.serving.server import MILSServer, ServerConfig  # noqa: E402

QOE = np.array([1e-3, 1e-4, 1e-6, 0.0, 1e-6])
# (prompt tokens, new tokens, arrival step): short prompts that decode
# across the 48-token stage boundary, one that starts above it, and a
# 70-token prompt that is still chunking when the plane looks
TRACE = [(20, 34, 0), (35, 20, 0), (12, 40, 1), (44, 10, 2), (28, 26, 3),
         (9, 30, 4), (70, 12, 5), (30, 24, 6)]
KW = dict(max_slots=3, max_seq=128, prefill_token_budget=16)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("smollm-360m").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _, _ in TRACE]
    return jmodel, jparams, cfg, build_model(cfg), params, prompts


def _plan(mod_plan, mod_stage, E=4, boundary=48.0):
    lo = E // 2
    return mod_plan([mod_stage(0.0, boundary, E - lo),
                     mod_stage(boundary, float("inf"), lo)], 0.0)


def _torch_server(setup, **cfg_kw):
    _, _, _, model, params, prompts = setup
    srv = MILSServer(model, params, _plan(PipelinePlan, Stage),
                     QoEModel(QOE), ServerConfig(seed=0, **cfg_kw),
                     attn_backend="flat", **KW)
    reqs = [ServeRequest(i, p.copy(), new)
            for i, (p, (_, new, _)) in enumerate(zip(prompts, TRACE))]
    for r, (_, _, at) in zip(reqs, TRACE):
        srv.submit_at(r, at)
    return srv, reqs


def test_decision_log_and_streams_match_jax_server(setup):
    jmodel, jparams, _, _, _, prompts = setup
    jsrv = JaxServer(jmodel, jparams, _plan(JaxPlan, JaxStage), JaxQoE(QOE),
                     JaxConfig(seed=0, preemption=False, host_kv_budget=0),
                     attn_backend="dense", **KW)
    jreqs = [JaxRequest(i, p.copy(), new)
             for i, (p, (_, new, _)) in enumerate(zip(prompts, TRACE))]
    for r, (_, _, at) in zip(jreqs, TRACE):
        jsrv.submit_at(r, at)
    jsrv.run(max_steps=400)
    assert not any(e.fused_mixed for e in jsrv.engines)

    srv, reqs = _torch_server(setup, preemption=False, host_kv_budget=0)
    srv.run(max_steps=400)              # asserts every engine drained
    assert all(e.attn_backend == "flat" for e in srv.engines)
    assert srv.plane.decisions == jsrv.plane.decisions
    assert srv.migrations == jsrv.migrations > 0
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.first_token_step, r.finish_step) for r in reqs] == \
        [(r.first_token_step, r.finish_step) for r in jreqs]
    assert srv.steps == jsrv.steps
    assert srv.stage_bounds == jsrv.stage_bounds
    got, want = srv.summary(), jsrv.summary()
    for key in ("finished", "steps", "migrations", "tokens_out",
                "ttft_steps_p50", "ttft_steps_p99", "e2e_steps_p95",
                "slo_standard_attainment"):
        assert got[key] == want[key], key
    # the preemption, tier and fault counters are the reference's: none
    # of those subsystems is on in this run
    for key in ("preemptions", "resumes", "cache_demotions",
                "cache_promotions", "failed", "redispatched", "retries",
                "rejected", "downtime_total"):
        assert got[key] == want[key] == 0, key


def test_engine_step_contracts_inside_the_cluster(setup, monkeypatch):
    """Each engine step makes at most one device-to-host transfer and at
    most two attention-bearing forwards (chunks, then decodes); steps
    that carry both make exactly two."""
    calls = []
    real = engine_mod.d2h
    monkeypatch.setattr(engine_mod, "d2h",
                        lambda x: calls.append(1) or real(x))
    srv, reqs = _torch_server(setup)
    two_call_steps = 0
    for eng in srv.engines:
        step = eng.step

        def counted(burst=1, _step=step):
            nonlocal two_call_steps
            calls.clear()
            a0 = engine_mod.ATTN_CALLS
            out = _step(burst)
            n = engine_mod.ATTN_CALLS - a0
            assert n <= 2 and len(calls) <= 1, (n, len(calls))
            two_call_steps += n == 2
            return out
        monkeypatch.setattr(eng, "step", counted)
    srv.run(max_steps=400)
    assert len(srv.finished) == len(TRACE)
    assert two_call_steps > 0


def test_fused_backend_cluster_drains(setup):
    """The same trace on the fused backend: every request finishes with
    its token count and the engines drain clean."""
    _, _, _, model, params, prompts = setup
    srv = MILSServer(model, params, _plan(PipelinePlan, Stage),
                     QoEModel(QOE), ServerConfig(seed=0),
                     attn_backend="fused", **KW)
    reqs = [ServeRequest(i, p.copy(), new)
            for i, (p, (_, new, _)) in enumerate(zip(prompts, TRACE))]
    for r, (_, _, at) in zip(reqs, TRACE):
        srv.submit_at(r, at)
    srv.run(max_steps=400)
    assert all(e.fused_mixed for e in srv.engines)
    assert [len(r.generated) for r in reqs] == [n for _, n, _ in TRACE]


def test_launcher_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--engines", "2", "--requests", "6",
                "--max-seq", "96", "--attn-backend", "flat",
                "--slo-class-mix", "interactive:0.5,batch:0.5"])
    out = capsys.readouterr().out
    assert "summary:" in out and "stage bounds:" in out
    plan = serve.default_plan(4, 8192)
    assert [(s.lo, s.hi, s.num_instances) for s in plan.stages] == \
        [(0.0, 2048.0, 2), (2048.0, float("inf"), 2)]
