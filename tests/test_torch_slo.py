"""SLO-tiered preemptive scheduling in the port vs the JAX reference, f32
on the CPU.

The copies of ``sched.slo`` and ``sched.policy`` give the reference's
outputs on the same inputs; the port's allocator parks and unparks as the
reference's does; the torch engine and server with preemption on give
the JAX engine's and server's greedy streams and preemption / resume /
recompute / tpot-skip counts on the reference's contention traces
(``tests/test_slo_sched.py``); park and recompute resume bit-identically
to a run without preemption; aging unstarves a recompute-preempted batch
request; a TPOT-hopeless resumed decode cannot preempt. The torch
engines run the ``flat`` backend, the JAX ones ``dense``: the same
two-call step."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.sched.policy as jpolicy  # noqa: E402
import repro.sched.slo as jslo  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.partition import PipelinePlan as JaxPlan  # noqa: E402
from repro.core.partition import Stage as JaxStage  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import request as jreq_mod  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.server import MILSServer as JaxServer  # noqa: E402
from repro.serving.server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch import bridge, sched  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import PipelinePlan, Stage  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sched import policy, slo  # noqa: E402
from repro_torch.serving import request as treq_mod  # noqa: E402
from repro_torch.serving.block_pool import BlockAllocator  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.server import MILSServer, ServerConfig  # noqa: E402

CLASSES = ("interactive", "standard", "batch", "no-such-class")


# --------------------------------------------------------------------------
# The copied pure modules
# --------------------------------------------------------------------------
def test_slo_copy_gives_reference_outputs():
    """queue_key, aging_promotion, tpot_hopeless, priority_of and slo_of
    over a grid of inputs, and insert_sorted over a random stream: the
    port's copy returns what the reference returns."""
    for cls, arrival, size, seq, ts, promote in itertools.product(
            CLASSES, (0.0, 3.5, 100.0), (1.0, 64.0), (0, 7), (1.0, 40.0),
            (0, 1, 9)):
        assert slo.queue_key(cls, arrival, size, seq, time_scale=ts,
                             promote=promote) == jslo.queue_key(
            cls, arrival, size, seq, time_scale=ts, promote=promote)
    for cls, at, now, ts in itertools.product(
            CLASSES, (0.0, 10.0), (0.0, 5.0, 10.5, 41.0, 400.0),
            (0.05, 1.0, 40.0)):
        assert slo.aging_promotion(cls, at, now, time_scale=ts) == \
            jslo.aging_promotion(cls, at, now, time_scale=ts)
        for n in (1, 4, 11, 100):
            assert slo.tpot_hopeless(cls, at, now, n, time_scale=ts) == \
                jslo.tpot_hopeless(cls, at, now, n, time_scale=ts)
    for cls in CLASSES:
        assert slo.priority_of(cls) == jslo.priority_of(cls)
        assert dataclasses.astuple(slo.slo_of(cls)) == \
            dataclasses.astuple(jslo.slo_of(cls))

    @dataclasses.dataclass
    class Item:
        seq: int
        sched_key: tuple = None

    rng = np.random.default_rng(0)
    mine, ref = [], []
    for seq in range(40):
        key = (int(rng.integers(0, 3)), float(rng.integers(0, 5)),
               float(rng.integers(0, 4)), int(rng.integers(0, 3)))
        slo.insert_sorted(mine, Item(seq, key))
        jslo.insert_sorted(ref, Item(seq, key))
    assert [i.seq for i in mine] == [i.seq for i in ref]
    assert slo.parse_class_mix("interactive:2,batch=1") == \
        jslo.parse_class_mix("interactive:2,batch=1")
    assert sched.queue_key is slo.queue_key


def test_policy_copy_as_the_engine_calls_it():
    """park_or_recompute without a cost spec (how both engines call it):
    the reference's choice on every input; with a spec, the port prices
    the recompute on the spec's chip and holds it to one launch of that
    chip, which on a chip of the reference's constants is the
    reference's choice; the module's restore price is the H100's launch
    overhead, not the reference's."""
    from repro_torch.kernels import cost
    import repro.kernels.cost as jcost
    tpu = dataclasses.replace(cost.H100,
                              peak_flops=jcost.PEAK_FLOPS,
                              hbm_bw=jcost.HBM_BW,
                              launch_overhead_s=jcost.LAUNCH_OVERHEAD_S,
                              attn_block=jcost.AttnSpec(1, 1, 1).block_s)
    spec = cost.AttnSpec(24, 8, 128, chip=tpu)
    jspec = jcost.AttnSpec(24, 8, 128)
    for must, kv in itertools.product((-3, 0, 1, 7), (0, 1, 2048)):
        assert policy.park_or_recompute(must_free_blocks=must,
                                        kv_tokens=kv) == \
            jpolicy.park_or_recompute(must_free_blocks=must, kv_tokens=kv)
        assert policy.park_or_recompute(must_free_blocks=must, kv_tokens=kv,
                                        spec=spec) == \
            jpolicy.park_or_recompute(must_free_blocks=must, kv_tokens=kv,
                                      spec=jspec)
    assert policy.PARK_RESTORE_COST_S == cost.H100.launch_overhead_s
    assert policy.PARK_RESTORE_COST_S != jpolicy.PARK_RESTORE_COST_S


# --------------------------------------------------------------------------
# Allocator park / unpark
# --------------------------------------------------------------------------
def test_allocator_park_unpark_invariants():
    alloc = BlockAllocator(num_blocks=8, block_size=16)
    alloc.reserve(4)
    blocks = alloc.allocate(4)
    alloc.park(blocks)
    assert alloc.parked_blocks == 4
    alloc.check_invariants()
    with pytest.raises(AssertionError):     # would strand a parked block
        alloc.release(blocks[:1])
    alloc.check_invariants()
    with pytest.raises(AssertionError):
        alloc.check_drained()               # parked blocks are held
    alloc.unpark(blocks)
    assert alloc.parked_blocks == 0
    alloc.release(blocks)
    alloc.unreserve(4)
    alloc.check_drained()
    assert alloc.free_blocks == 8
    with pytest.raises(AssertionError):
        BlockAllocator(num_blocks=4, block_size=16).park([0])


def test_allocator_shared_block_parked_by_two():
    """A shared prefix block parked by two preempted sharers stays pinned
    until both unpark; headroom counts the reservations, not the park."""
    alloc = BlockAllocator(num_blocks=6, block_size=4)
    alloc.reserve(2)
    a = alloc.allocate(2)
    alloc.publish(a[0], 11, head=True)
    alloc.share(a[:1])
    alloc.park(a)
    alloc.park(a[:1])
    assert alloc.parked_blocks == 2
    h = alloc.headroom_blocks
    with pytest.raises(AssertionError):
        alloc.release(a[:1], owned=False)   # parked by both sharers
    alloc.unpark(a[:1])
    alloc.check_invariants()
    alloc.release(a[:1], owned=False)       # one parker left: allowed
    alloc.unpark(a)
    alloc.release(a, owned=True)
    alloc.unreserve(2)
    assert alloc.headroom_blocks == h + 2
    alloc.check_drained()


# --------------------------------------------------------------------------
# Engines and servers against the reference
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


def _engines(setup, **kw):
    jmodel, jparams, model, params, _ = setup
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", 96)
    return (JaxEngine(0, jmodel, jparams, attn_backend="dense", **kw),
            Engine(0, model, params, attn_backend="flat", **kw))


def _mkreqs(mod, vocab, shapes, classes=None, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, (p, n) in enumerate(shapes):
        r = mod.ServeRequest(i, rng.integers(0, vocab, p).astype(np.int32), n)
        r.arrival_step = i
        if classes:
            r.slo_class = classes[i]
        out.append(r)
    return out


def _drive(eng, reqs, max_steps=400):
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        eng.step()
        eng.allocator.check_invariants()
        if all(r.state.name == "FINISHED" for r in reqs):
            return [list(r.generated) for r in reqs]
    raise AssertionError("engine did not drain")


COUNTERS = ("preemptions", "preempt_recomputes", "resumes", "tpot_skipped")


def _counters(eng):
    return {k: getattr(eng, k) for k in COUNTERS}


def test_engine_natural_seat_preemption_matches_jax(setup):
    """Batch work holding both seats is preempted when an interactive
    request arrives (the reference's natural-preemption trace): the torch
    engine makes the JAX engine's decisions, streams and counts, and
    serves the interactive request long before the batch drain."""
    vocab = setup[4]
    out = {}
    for name, eng in zip(("jax", "torch"),
                         _engines(setup, max_slots=2, preemption=True)):
        mod = jreq_mod if name == "jax" else treq_mod
        batch = _mkreqs(mod, vocab, [(12, 40), (12, 40)],
                        classes=["batch", "batch"], seed=2)
        for r in batch:
            eng.submit(r)
        for _ in range(8):
            eng.step()
        it = mod.ServeRequest(99, np.random.default_rng(2).integers(
            0, vocab, 10).astype(np.int32), 8)
        it.slo_class = "interactive"
        it.arrival_step = 8
        everyone = batch + [it]
        toks = _drive(eng, [it])
        while not all(r.state.name == "FINISHED" for r in everyone):
            eng.step()
            assert eng.steps < 400
        eng.check_drained()
        out[name] = ([list(r.generated) for r in everyone], _counters(eng),
                     [(r.first_token_step, r.finish_step, r.preemptions)
                      for r in everyone])
        assert toks[0] == list(it.generated)
        assert eng.preemptions > 0 and eng.resumes > 0
        assert it.first_token_step - it.arrival_step < 12
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("mode", ["_preempt_park", "_preempt_recompute"])
def test_engine_preempt_resume_bit_identical(setup, mode):
    """The twin of the reference's test: a decode parked (KV kept) or
    recompute-preempted (KV dropped, rebuilt by chunked prefill) resumes
    with exactly the tokens of a run without preemption."""
    _, _, model, params, vocab = setup
    shapes = [(10, 12), (14, 12), (8, 10)]
    ref = _drive(Engine(0, model, params, attn_backend="flat", max_slots=4,
                        max_seq=96), _mkreqs(treq_mod, vocab, shapes))
    eng = Engine(0, model, params, attn_backend="flat", max_slots=4,
                 max_seq=96, preemption=True)
    reqs = _mkreqs(treq_mod, vocab, shapes)
    for r in reqs:
        eng.submit(r)
    for _ in range(6):
        eng.step()
    slot = next(s for s, r in enumerate(eng.slots)
                if r is not None and r.generated and not r.prefilling)
    victim = eng.slots[slot]
    getattr(eng, mode)(slot)
    eng.allocator.check_invariants()
    assert victim.state.name in ("PREEMPTED", "WAITING")
    for _ in range(300):
        eng.step()
        eng.allocator.check_invariants()
        if all(r.state.name == "FINISHED" for r in reqs):
            break
    assert [list(r.generated) for r in reqs] == ref
    assert eng.preemptions == 1 and eng.resumes == 1
    assert victim.preemptions == 1
    eng.check_drained()


def test_engine_uniform_class_is_fcfs(setup):
    """preemption=True with one class and distinct arrivals is the FCFS
    engine, token for token, and never preempts."""
    _, _, model, params, vocab = setup
    shapes = [(int(p), 10) for p in
              np.random.default_rng(1).integers(8, 20, 6)]
    a = _drive(Engine(0, model, params, attn_backend="flat", max_slots=2,
                      max_seq=64), _mkreqs(treq_mod, vocab, shapes, seed=1))
    eng = Engine(0, model, params, attn_backend="flat", max_slots=2,
                 max_seq=64, preemption=True)
    assert _drive(eng, _mkreqs(treq_mod, vocab, shapes, seed=1)) == a
    assert eng.preemptions == 0


def test_engine_aging_unstarves_preempted_batch(setup):
    """The reference's starvation trace on both engines: one block of
    memory, so every interactive admission recompute-preempts the batch
    resident; aging must finish the batch request while the interactive
    stream still arrives. Same streams, counters and finish steps."""
    vocab = setup[4]
    out = {}
    for name, eng in zip(("jax", "torch"), _engines(
            setup, max_slots=1, max_seq=64, token_budget=16,
            preemption=True, slo_time_scale=0.05)):
        mod = jreq_mod if name == "jax" else treq_mod
        rng = np.random.default_rng(11)
        batch = mod.ServeRequest(0, rng.integers(0, vocab, 6)
                                 .astype(np.int32), 8)
        batch.slo_class = "batch"
        eng.submit(batch)
        for _ in range(4):
            eng.step()
        assert batch.generated and batch.state.name == "RUNNING"
        stream = []
        for step in range(150):
            if step % 2 == 0:
                it = mod.ServeRequest(100 + step, rng.integers(
                    0, vocab, 6).astype(np.int32), 2)
                it.slo_class = "interactive"
                it.arrival_step = eng.steps
                eng.submit(it)
                stream.append(it)
            eng.step()
            eng.allocator.check_invariants()
            if batch.state.name == "FINISHED":
                break
        assert batch.state.name == "FINISHED", "aging did not unstarve"
        assert eng.preempt_recomputes > 0 and batch.preemptions > 0
        for _ in range(400):
            if all(r.state.name == "FINISHED" for r in stream):
                break
            eng.step()
        eng.check_drained()
        out[name] = (list(batch.generated), batch.finish_step,
                     [list(r.generated) for r in stream], _counters(eng))
    assert out["torch"] == out["jax"]


def test_age_waiting_promotes_recompute_victims(setup):
    """``_age_waiting`` (which the reference runs on its whole-prompt
    admission path only) on both engines: a recompute-preempted batch
    request that has waited more than two TTFT budgets climbs two classes
    and moves ahead of a later interactive arrival; the queues end in the
    same order with the same keys."""
    vocab = setup[4]
    out = {}
    for name, eng in zip(("jax", "torch"), _engines(
            setup, max_slots=1, preemption=True, slo_time_scale=0.05)):
        mod = jreq_mod if name == "jax" else treq_mod
        rng = np.random.default_rng(13)
        batch = mod.ServeRequest(0, rng.integers(0, vocab, 10)
                                 .astype(np.int32), 30)
        batch.slo_class = "batch"
        eng.submit(batch)
        for _ in range(4):
            eng.step()
        eng._preempt_recompute(batch.slot)
        assert batch.preempted_step == eng.steps
        late = mod.ServeRequest(1, rng.integers(0, vocab, 6)
                                .astype(np.int32), 4)
        late.slo_class = "interactive"
        late.arrival_step = eng.steps + 2
        eng.submit(late)
        assert [r.req_id for r in eng.waiting] == [1, 0]
        eng.steps += 4              # > 2 batch TTFT budgets at this scale
        eng._age_waiting()
        out[name] = ([r.req_id for r in eng.waiting],
                     [r.sched_key for r in eng.waiting])
        assert out[name][0] == [0, 1]
        assert batch.sched_key[0] == 0
        for _ in range(200):
            eng.step()
            if batch.state.name == late.state.name == "FINISHED":
                break
        eng.check_drained()
    assert out["torch"] == out["jax"]


def test_engine_tpot_hopeless_cannot_preempt(setup):
    """A resumed decode already past its TPOT deadline is refused as a
    preemptor (counted once in tpot_skipped); a healthy arrival still
    preempts the batch resident."""
    _, _, model, params, vocab = setup
    rng = np.random.default_rng(12)
    eng = Engine(0, model, params, attn_backend="flat", max_slots=1,
                 max_seq=96, preemption=True, slo_time_scale=0.05)
    batch = treq_mod.ServeRequest(0, rng.integers(0, vocab, 10)
                                  .astype(np.int32), 30)
    batch.slo_class = "batch"
    eng.submit(batch)
    for _ in range(6):
        eng.step()
    hopeless = treq_mod.ServeRequest(1, rng.integers(0, vocab, 6)
                                     .astype(np.int32), 4)
    hopeless.slo_class = "interactive"
    hopeless.generated = [1, 2]
    hopeless.first_token_step = 0
    assert not eng._preempt_for(hopeless)
    assert not eng._preempt_for(hopeless)
    assert eng.tpot_skipped == 1 and eng.preemptions == 0
    healthy = treq_mod.ServeRequest(2, rng.integers(0, vocab, 6)
                                    .astype(np.int32), 4)
    healthy.slo_class = "interactive"
    assert eng._preempt_for(healthy)
    assert eng.preemptions == 1
    eng.allocator.check_invariants()
    for _ in range(200):
        eng.step()
        if batch.state.name == "FINISHED":
            break
    assert batch.state.name == "FINISHED"
    eng.check_drained()


def _contention_trace(mod, vocab):
    """The reference's server contention trace: two long batch decodes
    at step 0, two interactive requests at step 10."""
    rng = np.random.default_rng(3)
    trace = []
    for i in range(2):
        r = mod.ServeRequest(i, rng.integers(0, vocab, 16).astype(np.int32),
                             70)
        r.slo_class = "batch"
        trace.append((r, 0))
    for i in range(2):
        r = mod.ServeRequest(10 + i, rng.integers(0, vocab, 12)
                             .astype(np.int32), 8)
        r.slo_class = "interactive"
        trace.append((r, 10))
    return trace


@pytest.mark.parametrize("preemption", [False, True])
def test_server_contention_trace_matches_jax(setup, preemption):
    """One engine, two seats, the reference's contention trace: the torch
    server's decision log, streams and summary counters (preemptions,
    resumes, recomputes, tpot skips, per-class attainment and goodput)
    equal the JAX server's; with preemption the interactive class does
    better than without (the reference's claim)."""
    jmodel, jparams, model, params, vocab = setup
    kw = dict(policy="cascade", refinement="none", balancing="inter-stage",
              preemption=preemption, slo_time_scale=40.0)
    jsrv = JaxServer(jmodel, jparams, JaxPlan([JaxStage(0.0, float("inf"),
                                                        1)], 0.0), None,
                     JaxConfig(**kw), max_slots=2, max_seq=128,
                     attn_backend="dense")
    srv = MILSServer(model, params, PipelinePlan([Stage(0.0, float("inf"),
                                                        1)], 0.0), None,
                     ServerConfig(**kw), max_slots=2, max_seq=128,
                     attn_backend="flat")
    for s, mod in ((jsrv, jreq_mod), (srv, treq_mod)):
        for req, step in _contention_trace(mod, vocab):
            s.submit_at(req, step)
        s.run(max_steps=600)
    assert srv.plane.decisions == jsrv.plane.decisions
    got, want = srv.summary(), jsrv.summary()
    keys = [k for k in want if k.startswith("slo_")] + list(COUNTERS)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert sorted((r.req_id, r.generated) for r in srv.finished) == \
        sorted((r.req_id, r.generated) for r in jsrv.finished)
    assert (got["preemptions"] > 0) == preemption
