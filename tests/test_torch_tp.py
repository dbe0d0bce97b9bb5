"""Tensor-parallel serving in the port (``Engine(tp=2)``), f32 on the CPU,
held against the port's tp=1 engine and the JAX package's tp=2 engine
(conftest gives JAX two virtual devices) on the same weights: the twins
of ``tests/test_tp_engine.py``. Two processes run each tp=2 engine: this
one (the leader, rank 0) and one ``launch.tp_worker`` over a gloo group,
one mesh for the whole module.

Greedy streams on the four paged backends equal tp=1's and the JAX tp=2
engine's; resident KV doubles at equal per-rank budget while a rank's
pool leaf holds half the heads (int8 scales too); a mixed step makes one
d2h (on the leader; none on the worker), one attention-bearing forward
on each rank and one attention call per layer; the prefix cache, park
and recompute preemption, the host KV tier, whole-prompt prefill and
decode bursts match tp=1; migration tp=1 -> tp=2 -> tp=1 and JAX tp=2 ->
port tp=2 continue like the unmigrated run."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import request as jreq_mod  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_tp_mesh  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import request as treq_mod  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest, State  # noqa: E402

SHAPES = [(9, 10), (21, 10), (13, 8), (6, 10)]
KW = dict(max_slots=4, max_seq=96, token_budget=256)


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
    m = make_tp_mesh(2, device_type="cpu")
    yield m
    m.close()


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("smollm-360m").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    # the reference's tp=2 engine on SHAPES (its dense oracle path)
    jeng = JaxEngine(0, jmodel, jparams, tp=2, attn_backend="dense", **KW)
    jstreams = _drive(jeng, _mkreqs(jreq_mod, cfg.vocab_size, SHAPES))
    return jmodel, jparams, build_model(cfg), params, jstreams


def _engine(model, params, tp, mesh=None, **kw):
    kw = {**KW, "attn_backend": "dense", **kw}
    if tp > 1:
        kw["mesh"] = mesh
    return Engine(tp, model, params, tp=tp, **kw)


def _mkreqs(mod, vocab, shapes, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, (p, n) in enumerate(shapes):
        r = mod.ServeRequest(i, rng.integers(0, vocab, p).astype(np.int32), n)
        r.arrival_step = i
        out.append(r)
    return out


def _drive(eng, reqs, max_steps=400, burst=1):
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        eng.step(burst)
        if all(r.state.name == "FINISHED" for r in reqs):
            break
    assert all(r.state.name == "FINISHED" for r in reqs)
    return [list(r.generated) for r in reqs]


def _finish(eng, reqs, max_steps=400):
    for _ in range(max_steps):
        eng.step()
        if all(r.state is State.FINISHED for r in reqs):
            return
    raise AssertionError("requests did not finish")


# --------------------------------------------------------------------------
# Greedy parity and capacity
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["dense", "fused", "flat", "grid"])
def test_tp2_streams_equal_tp1_and_jax_tp2(setup, mesh, backend):
    _, _, model, params, jstreams = setup
    vocab = model.cfg.vocab_size
    ref = _drive(_engine(model, params, 1, attn_backend=backend),
                 _mkreqs(treq_mod, vocab, SHAPES))
    eng = _engine(model, params, 2, mesh, attn_backend=backend)
    got = _drive(eng, _mkreqs(treq_mod, vocab, SHAPES))
    assert got == ref == jstreams
    eng.shutdown()


def test_tp2_doubles_resident_kv_at_equal_per_rank_budget(setup, mesh):
    """``token_budget`` counts per rank: each rank holds Hkv / 2 heads of
    every block, so the tp=2 engine owns twice the blocks (and free
    tokens) at the same bytes a rank, on the leader and the worker;
    an int8 pool's scales split on their head axis too."""
    _, _, model, params, _ = setup
    cfg = model.cfg
    for kv in ("bf16", "int8"):
        back = "fused"
        e1 = _engine(model, params, 1, attn_backend=back, kv_dtype=kv)
        e2 = _engine(model, params, 2, mesh, attn_backend=back, kv_dtype=kv)
        assert e2.num_blocks == 2 * e1.num_blocks
        assert e2.token_budget == 2 * e1.token_budget
        assert e2.free_tokens() == 2 * e1.free_tokens()
        want = [tuple(a.shape[:3]) + (cfg.num_kv_heads // 2,)
                + tuple(a.shape[4:]) for a in e1.cache]
        want = [(s[0], e2.num_blocks + 1) + s[2:] for s in want]
        assert [tuple(a.shape) for a in e2.cache] == want
        worker = mesh.worker_stats()[0]["engines"][e2._tp_key]
        assert [tuple(s) for s in worker["pool_shapes"]] == want
        b1 = sum(a.numel() * a.element_size() for a in e1.cache)
        b2 = sum(a.numel() * a.element_size() for a in e2.cache)
        # the +1 garbage block is per engine: equal per-rank bytes for
        # the num_blocks real blocks
        per_block = b1 / (e1.num_blocks + 1)
        assert b2 == pytest.approx(per_block * (e2.num_blocks + 1) / 2)
        assert worker["pool_bytes"] == b2
        # the engine's KV accounting counts the bytes on all ranks
        assert e2._bytes_per_block == pytest.approx(e1._bytes_per_block)
        e1.shutdown()
        e2.shutdown()


def test_tp2_one_attn_call_one_d2h_per_mixed_step(setup, mesh,
                                                  monkeypatch):
    """A fused tp=2 mixed step (a long prompt chunking beside live
    decodes) makes one d2h on the leader and none on the worker, one
    attention-bearing forward on each rank, and one fused attention call
    per layer."""
    _, _, model, params, _ = setup
    L = model.cfg.num_layers
    d2h_calls = []
    real = engine_mod.d2h
    monkeypatch.setattr(engine_mod, "d2h",
                        lambda x: d2h_calls.append(1) or real(x))
    kernel_calls = []
    real_kernel = attn_mod.paged_mixed_attention
    monkeypatch.setattr(attn_mod, "paged_mixed_attention",
                        lambda *a, **k: kernel_calls.append(1)
                        or real_kernel(*a, **k))
    eng = _engine(model, params, 2, mesh, attn_backend="fused",
                  prefill_token_budget=8)
    vocab = model.cfg.vocab_size
    short = _mkreqs(treq_mod, vocab, [(5, 10), (11, 10)], seed=3)
    for r in short:
        eng.submit(r)
    while any(r.prefilling or r.state is State.WAITING for r in short):
        eng.step()
    rng = np.random.default_rng(4)
    long_req = ServeRequest(9, rng.integers(0, vocab, 24).astype(np.int32),
                            2)
    eng.submit(long_req)
    mesh.zero_worker_stats()
    a_start = engine_mod.ATTN_CALLS
    attn, sync, per_layer = [], [], []
    while long_req.prefilling or long_req.first_token_step is None:
        d2h_calls.clear()
        kernel_calls.clear()
        c0 = engine_mod.ATTN_CALLS
        eng.step()
        attn.append(engine_mod.ATTN_CALLS - c0)
        sync.append(len(d2h_calls))
        per_layer.append(len(kernel_calls))
    assert attn and max(attn) == 1 and min(attn) == 1, attn
    assert all(s == 1 for s in sync), sync
    assert all(n == L for n in per_layer), per_layer
    worker = mesh.worker_stats()[0]
    assert worker["attn_calls"] == engine_mod.ATTN_CALLS - a_start
    assert worker["d2h"] == 0
    # one all-gather a forward beside the embedding's and each layer's
    # all-reduces (two per half of a mixed step)
    assert worker["coll_calls"] > 0
    _finish(eng, short + [long_req])
    eng.shutdown()


# --------------------------------------------------------------------------
# Prefix cache, preemption, the host tier, whole-prompt prefill, bursts
# --------------------------------------------------------------------------
def test_tp2_prefix_cache_sharing_parity(setup, mesh):
    _, _, model, params, _ = setup
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, 32).astype(np.int32)
    tails = [rng.integers(0, vocab, t).astype(np.int32) for t in (7, 5)]
    outs, hits = {}, {}
    for tp in (1, 2):
        eng = _engine(model, params, tp, mesh, prefill_token_budget=16)
        reqs = [ServeRequest(i, np.concatenate([prefix, t]), 8)
                for i, t in enumerate(tails)]
        eng.submit(reqs[0])
        _finish(eng, reqs[:1])
        eng.submit(reqs[1])
        _finish(eng, reqs[1:])
        outs[tp] = [list(r.generated) for r in reqs]
        hits[tp] = reqs[1].cached_tokens
        eng.allocator.check_invariants()
        eng.shutdown()
    assert outs[2] == outs[1]
    assert hits[2] == hits[1] > 0, "warm request must share the prefix"


@pytest.mark.parametrize("mode", ["_preempt_park", "_preempt_recompute"])
def test_tp2_preempt_resume_equal(setup, mesh, mode):
    _, _, model, params, _ = setup
    vocab = model.cfg.vocab_size
    shapes = SHAPES[:3]
    ref = _drive(_engine(model, params, 1, preemption=False),
                 _mkreqs(treq_mod, vocab, shapes))
    eng = _engine(model, params, 2, mesh, preemption=True)
    reqs = _mkreqs(treq_mod, vocab, shapes)
    for r in reqs:
        eng.submit(r)
    for _ in range(6):
        eng.step()
    slot = next(s for s, r in enumerate(eng.slots)
                if r is not None and r.generated and not r.prefilling)
    getattr(eng, mode)(slot)
    eng.allocator.check_invariants()
    _finish(eng, reqs)
    assert [list(r.generated) for r in reqs] == ref
    assert eng.preemptions == 1 and eng.resumes == 1
    eng.shutdown()


# the host tier's trace (tests/test_torch_kv_tier.py): the pressure
# prompt evicts the cold chain, which demotes and later promotes. The
# tp=2 engine's per-rank budget gives it the tp=1 engine's 23 blocks.
TIER_KW = dict(max_slots=2, max_seq=512, block_size=16,
               prefill_token_budget=64, host_kv_budget=512)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tp2_host_tier_demote_promote_equal(setup, mesh, kv_dtype):
    _, _, model, params, _ = setup
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, vocab, 256).astype(np.int32)
    pressure = rng.integers(0, vocab, 320).astype(np.int32)
    runs = {}
    for tp, budget in ((1, 23 * 16), (2, 23 * 8)):
        eng = _engine(model, params, tp, mesh, attn_backend="fused",
                      kv_dtype=kv_dtype, token_budget=budget, **TIER_KW)
        assert eng.num_blocks == 23
        reqs = [ServeRequest(i, p.copy(), 6)
                for i, p in enumerate((prompt, pressure, prompt))]
        for r in reqs:
            eng.submit(r)
            _finish(eng, [r])
        assert eng.cache_demotions > 0 and eng.cache_promotions > 0
        assert reqs[2].generated == reqs[0].generated
        runs[tp] = ([r.generated for r in reqs], reqs[2].cached_tokens,
                    eng.cache_demotions, eng.cache_drops,
                    eng.cache_promotions, eng.promoted_blocks_total)
        eng.shutdown()
    assert runs[2] == runs[1]


def test_tp2_whole_prompt_prefill_and_bursts_equal(setup, mesh):
    """The whole-prompt path (the bucketed prefill on every rank) and
    decode bursts of up to 4 iterations a transfer."""
    _, _, model, params, _ = setup
    vocab = model.cfg.vocab_size
    for kw, burst in ((dict(chunked_prefill=False), 1),
                      (dict(attn_backend="fused"), 4)):
        ref = _drive(_engine(model, params, 1, **kw),
                     _mkreqs(treq_mod, vocab, SHAPES), burst=burst)
        eng = _engine(model, params, 2, mesh, **kw)
        got = _drive(eng, _mkreqs(treq_mod, vocab, SHAPES), burst=burst)
        assert got == ref, kw
        eng.shutdown()


# --------------------------------------------------------------------------
# Migration across tp and across the frameworks
# --------------------------------------------------------------------------
def test_migration_round_trip_between_different_tp(setup, mesh):
    """tp=1 -> tp=2 -> tp=1: the wire is the unsharded piece (the tp=2
    engine scatters its heads on import and gathers them on export), and
    the decode continues like the unmigrated run."""
    _, _, model, params, _ = setup
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, model.cfg.vocab_size, 13).astype(np.int32)
    r = ServeRequest(0, prompt.copy(), 14)
    ref = ServeRequest(9, prompt.copy(), 14)
    a = _engine(model, params, 1, max_slots=2)
    b = _engine(model, params, 2, mesh, max_slots=2)
    ref_eng = _engine(model, params, 1, max_slots=2)
    a.submit(r)
    ref_eng.submit(ref)
    for _ in range(4):
        a.step()
        ref_eng.step()
    src_slot = r.slot
    req, piece, nbytes = a.export_slot(src_slot)
    assert nbytes > 0
    assert b.import_request(req, piece)            # tp=1 piece -> tp=2 pool
    a.evict_slot(src_slot)
    a.allocator.check_invariants()
    for _ in range(4):
        b.step()
        ref_eng.step()
    src_slot = r.slot
    req, piece, nbytes2 = b.export_slot(src_slot)  # tp=2 piece -> tp=1 pool
    assert piece.k.shape[3] == model.cfg.num_kv_heads
    assert nbytes2 > nbytes
    assert a.import_request(req, piece)
    b.evict_slot(src_slot)
    b.allocator.check_invariants()
    _finish(a, [r])
    _finish(ref_eng, [ref])
    assert r.generated == ref.generated
    assert set(r.tokens_by_engine) >= {a.id, b.id}
    b.shutdown()


def test_jax_tp2_piece_continues_on_port_tp2(setup, mesh):
    """A request exported mid-decode from the JAX tp=2 engine (its piece
    gathered from both virtual devices), carried through numpy, continues
    on the port's tp=2 engine like the unmigrated run."""
    jmodel, jparams, model, params, jstreams = setup
    vocab = model.cfg.vocab_size
    src = JaxEngine(0, jmodel, jparams, tp=2, attn_backend="dense", **KW)
    jreq = _mkreqs(jreq_mod, vocab, SHAPES)[1]
    src.submit(jreq)
    while len(jreq.generated) < 4:
        src.step()
    slot = jreq.slot
    _, piece, _ = src.export_slot(slot)
    tpiece = bridge.pool_from_numpy(jax.tree.map(np.asarray, piece),
                                    device="cpu")
    moved = ServeRequest(jreq.req_id, jreq.prompt.copy(),
                         jreq.max_new_tokens)
    moved.generated = list(jreq.generated)
    moved.ctx_done = jreq.ctx_done
    moved.first_token_step = jreq.first_token_step
    moved.state = State.RUNNING
    src.evict_slot(slot)
    dst = _engine(model, params, 2, mesh, attn_backend="fused")
    assert dst.import_request(moved, tpiece)
    _finish(dst, [moved])
    assert moved.generated == jstreams[1]
    dst.shutdown()


def test_worker_loads_no_jax_and_no_repro(mesh):
    """The worker process imports neither JAX nor the JAX package."""
    assert mesh.worker_stats()[0]["forbidden_modules"] == []
