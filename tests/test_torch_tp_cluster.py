"""Tensor parallelism above and beside the engine, held against the JAX
package on the CPU: every family's weight shards (``launch.shardings``)
equal the slices of the reference's ``serving_param_spec_tree``, and the
pool's spec its ``pool_spec_tree``; reduced MoE engines at tp=2 keep
tp=1's logits within 1e-5 (both dispatches) and reduced VLM engines its
streams; the port's ``MILSServer`` on a heterogeneous ``(2, 1, 1, 1)``
cluster makes the JAX server's routing and migration decisions (the tp=2
engine, weighing 2, claims the short stage alone) with the same streams;
the engine refuses what the reference's refuses, with its messages; the
mesh refuses too few cards and NCCL on a shared card; ``serve --tp 2``
runs on the CPU; an engine's shutdown ends its workers, a dead worker
fails the leader's next step, and a worker outlives no leader. One
two-process mesh serves most of the module's engines."""
import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.partition import PipelinePlan as JaxPlan  # noqa: E402
from repro.core.partition import Stage as JaxStage  # noqa: E402
from repro.launch import shardings as jax_shardings  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import ServeRequest as JaxRequest  # noqa: E402
from repro.serving.server import MILSServer as JaxServer  # noqa: E402
from repro.serving.server import ServerConfig as JaxConfig  # noqa: E402
from repro.sim.cluster import CascadePolicy, Cluster  # noqa: E402
from repro.sim.cluster import ClusterConfig  # noqa: E402
from repro.sim.costmodel import profile_from_config  # noqa: E402
from repro.sim.workload import Request  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import PipelinePlan, Stage  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import make_paged_pool  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest, State  # noqa: E402
from repro_torch.serving.server import EngineView, MILSServer  # noqa: E402
from repro_torch.serving.server import ServerConfig  # noqa: E402

FAMILIES = ["smollm-360m", "qwen3-moe-30b-a3b", "arctic-480b", "qwen2-vl-7b",
            "rwkv6-7b", "zamba2-2.7b", "whisper-large-v3"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The engines here are small: one intra-op thread a rank runs them
    as fast, and keeps both ranks fast beside other test processes on
    the same cores (a worker takes its leader's thread count)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh():
    m = mesh_mod.make_tp_mesh(2, device_type="cpu")
    yield m
    m.close()


def _pair(arch, **over):
    """The JAX model and params of a reduced arch, and the port's model
    and params bridged from them."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return jmodel, jparams, build_model(cfg), params


def _reqs(vocab, shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [ServeRequest(i, rng.integers(0, vocab, p).astype(np.int32), n)
            for i, (p, n) in enumerate(shapes)]


def _drive(eng, reqs, max_steps=400):
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        eng.step()
        if all(r.state is State.FINISHED for r in reqs):
            return [list(r.generated) for r in reqs]
    raise AssertionError("requests did not finish")


# --------------------------------------------------------------------------
# Sharding rules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_params_equal_the_reference_spec_slices(arch):
    """Each rank's shard of every leaf is the slice the reference's
    serving spec gives that rank (a whole leaf where it replicates)."""
    _, jparams, model, params = _pair(arch)
    jspecs = jax_shardings.serving_param_spec_tree(jparams, 2)
    want = {jax_shardings._path_str(p): (tuple(s), np.asarray(a))
            for (p, s), (_, a) in zip(
                jax.tree_util.tree_flatten_with_path(
                    jspecs, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0],
                jax.tree_util.tree_flatten_with_path(jparams)[0])}
    specs = shardings.serving_param_spec_tree(params, 2)
    assert specs.keys() == want.keys()
    shards = [dict(shardings.param_leaves(shardings.shard_params(
        params, 2, r))) for r in range(2)]
    split = 0
    for path, (jspec, full) in want.items():
        assert tuple(specs[path]) == jspec, path
        if not jspec:
            assert all(shards[r][path] is dict(shardings.param_leaves(
                params))[path] for r in range(2)), path
            continue
        d = next(i for i, ax in enumerate(jspec) if ax is not None)
        for r, piece in enumerate(np.split(full.astype(np.float32), 2,
                                           axis=d)):
            np.testing.assert_array_equal(
                shards[r][path].float().numpy(), piece, err_msg=path)
        split += 1
    assert split > 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_pool_spec_equals_the_reference(kv_dtype):
    cfg = get_config("smollm-360m").reduced()
    jmodel = jax_build_model(jax_get_config("smollm-360m").reduced())
    pool = make_paged_pool(cfg, 5, 4, device="cpu", kv_dtype=kv_dtype,
                           layers=2)
    jpool = jmodel.init_paged_cache(5, 4, kv_dtype=kv_dtype)
    assert [tuple(a.shape) for a in pool] == \
        [tuple(a.shape) for a in jax.tree.leaves(jpool)]
    want = [tuple(s) for s in jax.tree.leaves(
        jax_shardings.pool_spec_tree(jpool),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert list(shardings.pool_spec_tree(pool)) == want


# --------------------------------------------------------------------------
# The MoE and VLM families at tp=2
# --------------------------------------------------------------------------
def _spied(eng, seen):
    """Record every mixed step's decode and chunk logits on the leader
    (the forward is the engine's own)."""
    real = eng.model.mixed_step

    def mixed_step(*a, **k):
        out = real(*a, **k)
        seen.append((out[0].clone(), out[1].clone()))
        return out
    eng.model = dataclasses.replace(eng.model, mixed_step=mixed_step)


@pytest.mark.parametrize("impl", ["dense", "gshard"])
def test_moe_tp2_logits_within_1e5_of_tp1(mesh, impl):
    """qwen3-moe reduced (4 / 2 heads -> 2 / 1 a rank, every expert on
    both ranks, F split, the router whole) on fused engines: every mixed
    step's logits at tp=2 lie within 1e-5 of tp=1's, the streams equal."""
    _, _, model, params = _pair("qwen3-moe-30b-a3b", moe_impl=impl)
    shapes = [(12, 6), (30, 5), (7, 6)]
    runs = {}
    for tp in (1, 2):
        eng = Engine(0, model, params, max_slots=4, max_seq=64,
                     prefill_token_budget=16, tp=tp,
                     mesh=mesh if tp > 1 else None)
        seen = []
        _spied(eng, seen)
        runs[tp] = (_drive(eng, _reqs(model.cfg.vocab_size, shapes)), seen)
        eng.shutdown()
    assert runs[2][0] == runs[1][0]
    assert len(runs[2][1]) == len(runs[1][1]) > 0
    for (d1, c1), (d2, c2) in zip(runs[1][1], runs[2][1]):
        torch.testing.assert_close(d2, d1, rtol=0, atol=1e-5)
        torch.testing.assert_close(c2, c1, rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["flat", "dense"])
def test_vlm_tp2_streams_equal_tp1(mesh, backend):
    """qwen2-vl reduced (M-RoPE on every rank's heads) on the non-fused
    backends serves text streams equal to tp=1's."""
    _, _, model, params = _pair("qwen2-vl-7b")
    shapes = [(12, 6), (30, 5), (7, 6)]
    runs = {}
    for tp in (1, 2):
        eng = Engine(0, model, params, max_slots=4, max_seq=64,
                     prefill_token_budget=16, attn_backend=backend, tp=tp,
                     mesh=mesh if tp > 1 else None)
        runs[tp] = _drive(eng, _reqs(model.cfg.vocab_size, shapes))
        eng.shutdown()
    assert runs[2] == runs[1]


# --------------------------------------------------------------------------
# The heterogeneous cluster (test_controlplane.py's tp parity trace)
# --------------------------------------------------------------------------
TPS = (2, 1, 1, 1)
LENS = [(20, 40), (8, 4), (20, 40), (10, 6), (20, 40), (20, 40)]
SRV_KW = dict(max_slots=4, max_seq=128, prefill_token_budget=8)


def test_heterogeneous_tp_server_matches_the_jax_server(mesh):
    """One tp=2 engine beside three tp=1 ones: its capacity weight is its
    tp, so weighted stage claiming gives it the whole short stage; every
    arrival routes there and the boundary-crossers migrate round-robin
    over the other three (tp=2 -> tp=1 pieces), with the JAX server's
    decision log and streams, and the routes and migrations that
    ``test_controlplane.py``'s tp parity test holds its simulator and
    server to."""
    jmodel, jparams, model, params = _pair("smollm-360m")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n, _ in LENS]
    jsrv = JaxServer(jmodel, jparams, JaxPlan(
        [JaxStage(0.0, 32.0, 2), JaxStage(32.0, float("inf"), 2)], 0.0),
        None, JaxConfig(refinement="none", balancing="rr", seed=0,
                        preemption=False, host_kv_budget=0),
        tp=TPS, attn_backend="dense", **SRV_KW)
    jreqs = [JaxRequest(i, p.copy(), n)
             for i, (p, (_, n)) in enumerate(zip(prompts, LENS))]

    def factory(i):
        return Engine(i, model, params, attn_backend="flat",
                      preemption=False, tp=TPS[i],
                      mesh=mesh if TPS[i] > 1 else None, **SRV_KW)
    srv = MILSServer(model, params, PipelinePlan(
        [Stage(0.0, 32.0, 2), Stage(32.0, float("inf"), 2)], 0.0), None,
        ServerConfig(refinement="none", balancing="rr", seed=0,
                     preemption=False), tp=TPS, engine_factory=factory)
    reqs = [ServeRequest(i, p.copy(), n)
            for i, (p, (_, n)) in enumerate(zip(prompts, LENS))]
    for s, rs in ((jsrv, jreqs), (srv, reqs)):
        for i, r in enumerate(rs):
            s.submit_at(r, 8 * i)
        s.run(max_steps=400)
        assert len(s.finished) == len(LENS)
        assert s.plane.stages[0].instance_ids == [0]
        assert s.plane.stages[1].instance_ids == [1, 2, 3]
    assert srv.tps == list(TPS)
    assert [EngineView(e).capacity_weight() for e in srv.engines] == \
        [2.0, 1.0, 1.0, 1.0]
    assert srv.plane.decisions == jsrv.plane.decisions
    policy = CascadePolicy(JaxPlan(
        [JaxStage(0.0, 32.0, 2), JaxStage(32.0, float("inf"), 2)], 0.0),
        None, refinement="none", balancing="rr")
    Cluster(profile_from_config(jax_get_config("llama3.2-3b")), policy,
            ClusterConfig(num_instances=4, seed=0, prefill_token_budget=8,
                          tps=TPS)).run(
        [Request(i, 8.0 * i, il, ol) for i, (il, ol) in enumerate(LENS)],
        duration=60.0)
    for kind in ("route", "migrate"):
        assert [d for d in srv.plane.decisions if d[0] == kind] == \
            [d for d in policy.plane.decisions if d[0] == kind], kind
    routes = [d for d in srv.plane.decisions if d[0] == "route"]
    assert all(d[2] == 0 for d in routes)
    assert srv.migrations == jsrv.migrations > 0
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    srv.close()


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------
REFUSALS = {
    "slab": ("smollm-360m", {}, 2, dict(paged=False)),
    "host loop": ("smollm-360m", {}, 2, dict(device_resident=False)),
    "rwkv6": ("rwkv6-7b", {}, 2, {}),
    "window": ("starcoder2-3b", dict(sliding_window=16), 2, {}),
    "kv heads": ("smollm-360m", {}, 3, {}),
    "vocab": ("smollm-360m", dict(vocab_size=511), 2, {}),
    "d_ff": ("smollm-360m", dict(d_ff=511), 2, {}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_the_reference(case):
    """The engine refuses, before any worker starts, what the reference's
    refuses, with the reference's message."""
    arch, over, tp, kw = REFUSALS[case]
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **over)
    with pytest.raises(AssertionError) as want:
        JaxEngine(0, jax_build_model(jcfg), None, tp=tp, **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    with pytest.raises(ValueError) as got:
        Engine(0, build_model(cfg), None, tp=tp, **kw)
    assert str(got.value) == str(want.value)


def test_mesh_refusals(monkeypatch):
    """No fallback: too few cards without a device list, NCCL with two
    ranks on one card, an unknown backend and a one-rank mesh are
    refused before any process starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh_mod.make_tp_mesh(2)
    assert mesh_mod.default_devices(3, "cpu") == ["cpu"] * 3
    with pytest.raises(ValueError, match="one rank per card"):
        mesh_mod.make_tp_mesh(2, ["cuda:0", "cuda:0"], "nccl")
    with pytest.raises(ValueError, match="backend"):
        mesh_mod.make_tp_mesh(2, ["cpu", "cpu"], "mpi")
    with pytest.raises(ValueError, match=">= 2 ranks"):
        mesh_mod.make_tp_mesh(1)


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------
def test_serve_tp2_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--tp", "2", "--engines", "1",
                "--requests", "4", "--max-seq", "96"])
    out = capsys.readouterr().out
    assert "summary: {'finished': " in out and "tp: [2]" in out
    assert serve.parse_tp("2,1,1,1", 4) == [2, 1, 1, 1]
    assert serve.parse_tp("2", 3) == [2, 2, 2]


# --------------------------------------------------------------------------
# Worker lifetime: no fallback, no orphan
# --------------------------------------------------------------------------
def test_shutdown_ends_the_workers_and_a_dead_worker_fails_the_step():
    """An engine that made its own mesh ends its workers at shutdown; a
    worker that dies makes the leader's next step raise instead of
    hanging or carrying on alone."""
    _, _, model, params = _pair("smollm-360m")
    vocab = model.cfg.vocab_size
    eng = Engine(0, model, params, max_slots=2, max_seq=64, tp=2)
    procs = list(eng.mesh._procs)
    assert len(procs) == 1 and procs[0].poll() is None
    _drive(eng, _reqs(vocab, [(9, 3)]))
    eng.shutdown()
    assert all(p.wait(timeout=30) == 0 for p in procs)

    eng = Engine(0, model, params, max_slots=2, max_seq=64, tp=2)
    eng.submit(_reqs(vocab, [(9, 3)])[0])
    worker = eng.mesh._procs[0]
    worker.kill()
    worker.wait(timeout=30)
    with pytest.raises(RuntimeError, match="exited"):
        eng.step()
    eng.close()


def test_a_worker_exits_when_its_leader_dies(tmp_path):
    """A leader killed without closing anything leaves no worker behind:
    the worker's command pipe closes and it exits."""
    pidfile = tmp_path / "worker.pid"
    code = (
        "import os, sys\n"
        "from repro_torch.launch.mesh import make_tp_mesh\n"
        "m = make_tp_mesh(2, device_type='cpu')\n"
        f"open({str(pidfile)!r}, 'w').write(str(m._procs[0].pid))\n"
        "os.kill(os.getpid(), 9)\n")
    env = dict(os.environ,
               PYTHONPATH=str(Path(mesh_mod.__file__).parents[2]))
    subprocess.run([sys.executable, "-c", code], env=env, timeout=300)
    pid = int(pidfile.read_text())
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.2)
    os.kill(pid, signal.SIGKILL)
    raise AssertionError(f"worker {pid} outlived its leader by 60 s")
