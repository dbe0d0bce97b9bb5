"""Fault recovery in the port's cluster vs the JAX reference, f32 on the
CPU.

The copied fault model (``FaultSpec``, ``FaultInjector``,
``BackoffPolicy``, ``fault_summary``) gives the reference's draws and
numbers; a mid-decode engine crash whose residents are redispatched
continues bit-identically to a fault-free run (the twin of
``tests/test_faults.py::test_engine_crash_redispatch_is_bit_identical``);
and the torch ``MILSServer`` against the JAX ``MILSServer`` on one fixed
trace with int8 pools, SLO preemption, the host KV tier, a crash with its
rejoin and lost transfers: identical decision logs, greedy streams and
summary counters, every engine drained clean."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.control.faults as jfaults  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.partition import PipelinePlan as JaxPlan  # noqa: E402
from repro.core.partition import Stage as JaxStage  # noqa: E402
from repro.core.qoe import QoEModel as JaxQoE  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import request as jreq_mod  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.server import MILSServer as JaxServer  # noqa: E402
from repro.serving.server import ServerConfig as JaxConfig  # noqa: E402
from repro.sim.metrics import fault_summary as jax_fault_summary  # noqa: E402,E501
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.control import faults  # noqa: E402
from repro_torch.core.partition import PipelinePlan, Stage  # noqa: E402
from repro_torch.core.qoe import QoEModel  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import request as treq_mod  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.server import MILSServer, ServerConfig  # noqa: E402
from repro_torch.sim.metrics import fault_summary  # noqa: E402

QOE = np.array([1e-3, 1e-4, 1e-6, 0.0, 1e-6])


# --------------------------------------------------------------------------
# The copied fault model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,loss,stall", [(0, 0.3, 0.0), (7, 0.5, 0.2),
                                             (123, 0.0, 0.4), (5, 0.0, 0.0)])
def test_fault_injector_draws_equal_reference(seed, loss, stall):
    """The same spec gives the same fate for every (request, attempt), in
    any interleaving of requests, as the reference's injector."""
    kw = dict(seed=seed, crashes=((0, 3.0), (2, 9.0)), rejoins=((0, 7.0),),
              racks=(((1, 3), 11.0),), transfer_loss_p=loss,
              transfer_stall_p=stall, slowdowns=((1, 2.5),))
    mine = faults.FaultInjector(faults.FaultSpec(**kw))
    ref = jfaults.FaultInjector(jfaults.FaultSpec(**kw))
    order = np.random.default_rng(seed).integers(0, 6, 200)
    assert [mine.transfer_event(int(r)) for r in order] == \
        [ref.transfer_event(int(r)) for r in order]
    assert mine.spec.all_crashes == ref.spec.all_crashes
    for iid in range(5):
        assert (mine.crash_time(iid), mine.rejoin_time(iid),
                mine.slowdown(iid)) == (ref.crash_time(iid),
                                        ref.rejoin_time(iid),
                                        ref.slowdown(iid))
    for vals in itertools.product((0, 9), ("xfer", "x"), (1, 17), (0, 3)):
        assert faults._unit_hash(*vals) == jfaults._unit_hash(*vals)
    pol, jpol = faults.BackoffPolicy(), jfaults.BackoffPolicy()
    assert [pol.delay(n) for n in range(9)] == [jpol.delay(n)
                                                for n in range(9)]


def test_fault_summary_formula_equals_reference():
    flags = [(False, False, 0), (True, False, 0), (False, True, 2),
             (False, False, 1)]
    kw = dict(retries=5, downtime={1: 3.5, 3: 1.5})
    assert fault_summary(flags, **kw) == jax_fault_summary(flags, **kw)
    assert fault_summary(flags, **kw)["redispatched"] == 2


# --------------------------------------------------------------------------
# Engines and servers
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("smollm-360m").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return jmodel, jparams, build_model(cfg), params, cfg.vocab_size


def _plan(plan_cls, stage_cls):
    return plan_cls([stage_cls(0.0, 48.0, 2),
                     stage_cls(48.0, float("inf"), 2)], 0.0)


def test_engine_crash_redispatch_is_bit_identical(setup):
    """Kill one engine mid-decode: its residents replay prompt +
    generated-so-far through chunked prefill elsewhere and continue with
    EXACTLY the tokens of a fault-free run; the crashed engine's pool is
    released, and the summary counts the recoveries and the downtime."""
    _, _, model, params, vocab = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, 20).astype(np.int32)
               for _ in range(6)]

    def server(spec):
        return MILSServer(model, params, _plan(PipelinePlan, Stage),
                          QoEModel(QOE), ServerConfig(seed=0, faults=spec),
                          max_slots=3, max_seq=96, attn_backend="flat")

    ref = server(None).run([treq_mod.ServeRequest(i, p.copy(), 40)
                            for i, p in enumerate(prompts)], max_steps=500)
    want = {r.req_id: list(r.generated) for r in ref}
    srv = server(faults.FaultSpec(seed=0, crashes=((0, 12),)))
    carcass = srv.engines[0]
    fin = srv.run([treq_mod.ServeRequest(i, p.copy(), 40)
                   for i, p in enumerate(prompts)], max_steps=800)
    assert len(fin) == len(prompts)
    recovered = [r for r in fin if r.redispatches]
    assert recovered, "engine 0 must have held residents at death"
    for r in fin:
        assert not r.failed
        assert list(r.generated) == want[r.req_id], r.req_id
    s = srv.summary()
    assert s["redispatched"] == len(recovered) and s["downtime_i0"] > 0
    assert ("dead", 0) in srv.plane.decisions
    assert carcass._faulted and carcass.cache is None
    assert srv.engines[0] is not carcass


def _faulty_trace(mod, vocab):
    """(request, arrival step) pairs: a 32-token prefix shared by four
    prompts (three re-admitted after their chain was reclaimed: demote,
    then promote), a class mix that makes interactive arrivals preempt
    batch decodes, and prompts around the 48-token stage boundary that
    hand over while decoding."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 32).astype(np.int32)

    def prompt(n, pre=0):
        p = rng.integers(0, vocab, n).astype(np.int32)
        p[:pre] = shared[:pre]
        return p

    spec = [(prompt(40, 32), 6, 0, "standard"),
            (prompt(36, 32), 30, 0, "batch"), (prompt(20), 34, 0, "batch"),
            (prompt(12), 40, 1, "standard"), (prompt(44), 10, 2, "batch"),
            (prompt(28), 26, 3, "batch"), (prompt(9), 30, 4, "interactive"),
            (prompt(40, 32), 12, 6, "interactive"),
            (prompt(30), 24, 6, "interactive"),
            (prompt(16), 20, 8, "interactive"),
            (prompt(36, 32), 8, 30, "standard"),
            (prompt(24), 20, 14, "interactive"),
            (prompt(38, 32), 10, 40, "standard")]
    out = []
    for i, (p, new, at, cls) in enumerate(spec):
        r = mod.ServeRequest(i, p, new)
        r.slo_class = cls
        out.append((r, at))
    return out


FAULTS = dict(seed=0, crashes=((1, 12),), rejoins=((1, 30),),
              transfer_loss_p=0.3)
ENGINE_KW = dict(max_slots=2, max_seq=96, token_budget=128,
                 prefill_token_budget=16, attn_backend="fused",
                 kv_dtype="int8", host_kv_budget=64, preemption=True,
                 slo_time_scale=8.0)
CFG_KW = dict(seed=0, kv_dtype="int8", host_kv_budget=64, preemption=True,
              slo_time_scale=8.0)


def test_server_matches_jax_server_with_int8_preemption_tier_faults(setup):
    """One trace through the torch and the JAX cluster (4 engines, two
    stages, int8 pools on the fused backend, preemption on, a host tier
    on every engine, engine 1 crashed at step 12 and rejoined at step 30,
    30% of transfers lost): identical decision logs, greedy streams and
    steps, and identical summary counters, with every event this slice
    adds happening at least once."""
    jmodel, jparams, model, params, vocab = setup
    jsrv = JaxServer(jmodel, jparams, _plan(JaxPlan, JaxStage), JaxQoE(QOE),
                     JaxConfig(faults=jfaults.FaultSpec(**FAULTS), **CFG_KW),
                     engine_factory=lambda i: JaxEngine(
                         i, jmodel, jparams, **ENGINE_KW))
    srv = MILSServer(model, params, _plan(PipelinePlan, Stage),
                     QoEModel(QOE),
                     ServerConfig(faults=faults.FaultSpec(**FAULTS),
                                  **CFG_KW),
                     engine_factory=lambda i: Engine(i, model, params,
                                                     **ENGINE_KW))
    runs = {}
    for name, s, mod in (("jax", jsrv, jreq_mod), ("torch", srv, treq_mod)):
        trace = _faulty_trace(mod, vocab)
        for req, at in trace:
            s.submit_at(req, at)
        s.run(max_steps=600)            # asserts live engines drained
        runs[name] = [r for r, _ in trace]
    assert srv.plane.decisions == jsrv.plane.decisions
    assert [r.generated for r in runs["torch"]] == \
        [r.generated for r in runs["jax"]]
    assert [(r.first_token_step, r.finish_step, r.redispatches,
             r.preemptions, r.failed) for r in runs["torch"]] == \
        [(r.first_token_step, r.finish_step, r.redispatches, r.preemptions,
          r.failed) for r in runs["jax"]]
    got, want = srv.summary(), jsrv.summary()
    for key, val in want.items():
        assert got[key] == val, key
    log = srv.plane.decisions
    assert ("dead", 1) in log and ("rejoin", 1) in log
    assert any(d[0] == "redispatch" for d in log)
    assert any(d[0] == "mig_fail" for d in log)
    assert got["retries"] > 0 and got["redispatched"] > 0
    assert got["preemptions"] > got["preempt_recomputes"] > 0   # park too
    assert got["cache_demotions"] > 0 and got["cache_promotions"] > 0
    assert got["finished"] == len(runs["torch"]) and got["failed"] == 0


def test_launcher_fault_and_tier_flags(capsys):
    """The launcher takes the reference's flags and defaults (host tier on
    at 4096 tokens, preemption on, no faults unless asked) and runs the
    int8 / preemption / tier / fault cluster on the CPU to its end."""
    from repro_torch.launch import serve
    args = serve.parse_args([])
    assert (args.kv_dtype, args.host_kv_budget, args.preemption,
            args.migration_timeout_steps, args.dead_after_steps) == \
        ("bf16", 4096, True, 4, 6)
    assert serve.fault_spec(args) is None
    assert serve.parse_args(["--no-kv-tiering"]).host_kv_budget == 0
    assert serve.parse_args(["--no-preemption"]).preemption is False
    argv = ["--device", "cpu", "--engines", "4", "--requests", "10",
            "--kv-dtype", "int8", "--crash", "1:6", "--rejoin", "1:20",
            "--transfer-loss-p", "0.3", "--fault-seed", "2",
            "--slo-class-mix", "interactive:0.5,batch:0.5"]
    spec = serve.fault_spec(serve.parse_args(argv))
    assert spec == faults.FaultSpec(seed=2, crashes=((1, 6.0),),
                                    rejoins=((1, 20.0),),
                                    transfer_loss_p=0.3)
    serve.main(argv)
    out = capsys.readouterr().out
    assert "summary:" in out and "'downtime_i1'" in out
