"""The port's engine modes beyond the default paged, device-resident,
chunked one — the monolithic KV slab (``paged=False``), the host loop
(``device_resident=False``), whole-prompt prefill
(``chunked_prefill=False``) and ``prefix_cache=False`` — vs the JAX
package, f32 on the CPU, on reduced smollm-360m with the JAX weights
bridged over.

The model functions under them (``attention_prefill``,
``attention_decode`` on a slab, ``forward_full`` with ``last_index``,
``forward_decode``, ``Model.prefill`` and ``prefill_bucketed``) hold the
reference's values at ``LOGIT_TOL``/``POOL_TOL``
(``tests/test_torch_models.py``). Each engine mode gives the greedy
streams, step counts and counters (``prefill_tokens_done``,
``prefill_work_blocks``, ``peak_kv_bytes``, ``reserved_tokens()`` after
every step) of the JAX engine built with the same kwargs (the JAX side
runs its Pallas kernels in interpret mode), makes one device-to-host
transfer a step and the forwards its mode says, drains clean and rejects
prompts that never fit. Migration between slab and paged engines, and
between torch and JAX slab engines, gives bit-identical next logits; a
whole-prompt engine refuses a partial prefill; with preemption on, a
whole-prompt engine makes the reference's decisions (parks, refused
recomputes, keys aged on admission). ``MILSServer`` and the launcher take
the mode flags. The ``gpu``-marked test runs the four modes at 2 layers,
f32, on the card and on the CPU: equal streams and counters.

JAX is imported inside fixtures, so the ``gpu`` test runs where JAX is
not installed."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.serving.engine as engine_mod  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import PipelinePlan, Stage  # noqa: E402
from repro_torch.core.qoe import QoEModel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.sched.slo import priority_of  # noqa: E402
from repro_torch.serving import request as treq_mod  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.server import MILSServer, ServerConfig  # noqa: E402

LOGIT_TOL, POOL_TOL = 1e-4, 1e-5
# the engine trace: 4 requests over 3 slots (one waits), chunk budget 8,
# and a resubmit of the 23-token prompt (a prefix hit where the cache is on)
PROMPTS = (5, 23, 12, 40, 23)
NEW = 6
KW = dict(max_slots=3, max_seq=64, prefill_token_budget=8)
MODES = {
    "slab": dict(paged=False),
    "host-dense": dict(device_resident=False, attn_backend="dense"),
    "host-grid": dict(device_resident=False, attn_backend="grid"),
    "host-flat": dict(device_resident=False, attn_backend="flat"),
    "host-fused": dict(device_resident=False, attn_backend="fused"),
    "whole-prompt-fused": dict(chunked_prefill=False, attn_backend="fused"),
    "whole-prompt-flat": dict(chunked_prefill=False, attn_backend="flat"),
    "no-prefix-cache": dict(prefix_cache=False, attn_backend="fused"),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: modules, the reduced smollm-360m model and its
    weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import attention as jattn
    from repro.models import build_model as jbuild_model
    from repro.models import transformer as jtr
    from repro.serving import engine as jengine
    from repro.serving import request as jreq
    from repro.serving import server as jserver
    from repro.core import partition as jpartition
    from repro.core import qoe as jqoe
    jcfg = jget_config("smollm-360m").reduced()
    jmodel = jbuild_model(jcfg)
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, attn=jattn, tr=jtr, engine=jengine, req=jreq,
        server=jserver, partition=jpartition, qoe=jqoe, cfg=jcfg,
        model=jmodel, params=jmodel.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def setup(jx):
    """(port cfg, model, params on the CPU, the trace's prompts)."""
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(
        jx.jax.tree.map(np.asarray, jx.params), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS[:4]]
    prompts.append(prompts[1].copy())
    return cfg, build_model(cfg), params, prompts


@pytest.fixture
def engines():
    """Torch engines made by a test, each checked for a clean drain."""
    made = []
    yield made
    for eng in made:
        eng.check_drained()


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _layer0(jx, params):
    return (jx.jax.tree.map(lambda a: a[0], jx.params["layers"])["attn"],
            layer_params(params["layers"], 0)["attn"])


# --------------------------------------------------------------------------
# Model functions
# --------------------------------------------------------------------------
@pytest.mark.parametrize("T", [1, 37, 64])
def test_attention_prefill_matches_reference(jx, setup, T):
    """Whole-prompt attention (the contiguous prefill kernel's plain
    version here) and the prompt's K/V rows after RoPE."""
    cfg, _, params, _ = setup
    jp, tp = _layer0(jx, params)
    x = np.random.default_rng(T).normal(0, 1, (2, T, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(T), (2, T))
    jout, (jk, jv) = jx.attn.attention_prefill(jp, jx.cfg, jx.jnp.asarray(x),
                                               jx.jnp.asarray(pos))
    out, (k, v) = tattn.attention_prefill(tp, cfg, t(x), t(pos))
    _close(out, jout, LOGIT_TOL)
    _close(k, jk, POOL_TOL)
    _close(v, jv, POOL_TOL)


@pytest.mark.parametrize("rows", [False, True], ids=["own-slab", "rows"])
def test_attention_decode_matches_reference(jx, setup, rows):
    """One token against a slab layer: the K/V row written in place at
    ``min(pos, S - 1)`` and the padded contiguous decode over keys
    ``<= pos``; with ``rows`` the three requests sit in rows 4, 0 and 2
    of a five-row slab and only those rows change."""
    cfg, _, params, _ = setup
    jp, tp = _layer0(jx, params)
    rng = np.random.default_rng(5)
    S, B = 40, 3
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    k = rng.normal(0, 1, shape).astype(np.float32)
    v = rng.normal(0, 1, shape).astype(np.float32)
    x = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray([0, 17, S - 1], np.int32)
    jout, jcache = jx.attn.attention_decode(
        jp, jx.cfg, jx.jnp.asarray(x), jx.attn.KVCache(
            jx.jnp.asarray(k), jx.jnp.asarray(v)), jx.jnp.asarray(pos))
    if rows:
        at = np.asarray([4, 0, 2])
        slab_k = rng.normal(0, 1, (5,) + shape[1:]).astype(np.float32)
        slab_v = rng.normal(0, 1, (5,) + shape[1:]).astype(np.float32)
        slab_k[at], slab_v[at] = k, v
        cache = KVCache(t(slab_k.copy()), t(slab_v.copy()))
        out, cache = tattn.attention_decode(tp, cfg, t(x), cache, t(pos),
                                            rows=t(at.astype(np.int32)))
        others = [1, 3]
        np.testing.assert_array_equal(cache.k[others].numpy(),
                                      slab_k[others])
        got_k, got_v = cache.k[at], cache.v[at]
    else:
        out, cache = tattn.attention_decode(tp, cfg, t(x),
                                            KVCache(t(k), t(v)), t(pos))
        got_k, got_v = cache.k, cache.v
    _close(out, jout, LOGIT_TOL)
    _close(got_k, jcache.k, POOL_TOL)
    _close(got_v, jcache.v, POOL_TOL)


@pytest.mark.parametrize("mode", ["all", "last_only", "last_index"])
def test_forward_full_matches_reference(jx, setup, mode):
    """The prompt pass: every position's logits, the last one's, or the
    true last one of a pow2-padded prompt (``last_index``), and the
    stacked cache [L, B, T, Hkv, Dh]."""
    cfg, _, params, _ = setup
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    kw = {"all": {}, "last_only": {"last_only": True},
          "last_index": {"last_index": 10}}[mode]
    jkw = dict(kw)
    if mode == "last_index":
        jkw["last_index"] = jx.jnp.int32(10)
    jlogits, jcache, _ = jx.tr.forward_full(
        jx.params, jx.cfg, jx.jnp.asarray(tokens), return_cache=True, **jkw)
    logits, cache, _ = ttr.forward_full(params, cfg, t(tokens),
                                        return_cache=True, **kw)
    _close(logits, jlogits, LOGIT_TOL)
    _close(cache.k, jcache.k, POOL_TOL)
    _close(cache.v, jcache.v, POOL_TOL)
    if mode == "last_index":        # a 0-d tensor index gives the same
        again, none, _ = ttr.forward_full(params, cfg, t(tokens),
                                          last_index=torch.tensor(10))
        assert none is None
        torch.testing.assert_close(again, logits, rtol=0, atol=0)


def test_forward_decode_matches_reference(jx, setup):
    """One decode step through the stack against a random slab
    [L, B, S, Hkv, Dh]: logits and the updated slab."""
    cfg, _, params, _ = setup
    rng = np.random.default_rng(4)
    shape = (cfg.num_layers, 3, 32, cfg.num_kv_heads, cfg.head_dim)
    k = rng.normal(0, 1, shape).astype(np.float32)
    v = rng.normal(0, 1, shape).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    pos = np.asarray([3, 31, 12], np.int32)
    jlogits, jcache = jx.tr.forward_decode(
        jx.params, jx.cfg, jx.jnp.asarray(tok),
        jx.attn.KVCache(jx.jnp.asarray(k), jx.jnp.asarray(v)),
        jx.jnp.asarray(pos))
    logits, cache = ttr.forward_decode(params, cfg, t(tok),
                                       KVCache(t(k), t(v)), t(pos))
    _close(logits, jlogits, LOGIT_TOL)
    _close(cache.k, jcache.k, POOL_TOL)
    _close(cache.v, jcache.v, POOL_TOL)


def test_model_prefill_and_bucketed_prefill_match_reference(jx, setup):
    """``Model.prefill`` relays the prompt into a zeroed ``cache_len``
    slab; ``prefill_bucketed`` of a 13-token prompt padded to 16 gives
    the true last token's logits and rows 0..12 of the unpadded pass."""
    cfg, model, params, _ = setup
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 13)).astype(np.int32)
    jlogits, jcache = jx.model.prefill(
        jx.params, {"tokens": jx.jnp.asarray(tokens)}, cache_len=48)
    logits, cache = model.prefill(params, t(tokens), 48)
    assert tuple(cache.k.shape) == tuple(jcache.k.shape)
    _close(logits, jlogits, LOGIT_TOL)
    _close(cache.k, jcache.k, POOL_TOL)
    _close(cache.v, jcache.v, POOL_TOL)
    padded = np.zeros((1, 16), np.int32)
    padded[:, :13] = tokens
    jlogits, jpiece = jx.model.prefill_bucketed(
        jx.params, {"tokens": jx.jnp.asarray(padded)}, jx.jnp.int32(13))
    logits, piece = model.prefill_bucketed(params, t(padded), 13)
    _close(logits, jlogits, LOGIT_TOL)
    _close(piece.k, jpiece.k, POOL_TOL)
    _close(piece.k[:, :, :13], cache.k[:, :, :13], POOL_TOL)
    assert model.supports_paged


# --------------------------------------------------------------------------
# Engines in every mode, against the JAX engine with the same kwargs
# --------------------------------------------------------------------------
def _serve(eng, reqs, max_steps=300):
    """Submit, step to the end; returns reserved_tokens() after each
    step."""
    for r in reqs:
        eng.submit(r)
    reserved = []
    while not all(r.state.name == "FINISHED" for r in reqs):
        assert eng.steps < max_steps, "engine did not drain"
        eng.step()
        reserved.append(eng.reserved_tokens())
    return reserved


COUNTERS = ("steps", "prefill_tokens_done", "prefill_work_blocks",
            "peak_kv_bytes", "cached_prompt_tokens_total", "tokens_out")


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_streams_and_counters_match_jax_engine(jx, setup, engines,
                                                    mode):
    cfg, model, params, prompts = setup
    kw = dict(KW, **MODES[mode])
    jeng = jx.engine.Engine(0, jx.model, jx.params, **kw)
    jreqs = [jx.req.ServeRequest(i, p.copy(), NEW)
             for i, p in enumerate(prompts)]
    jreserved = _serve(jeng, jreqs)
    eng = Engine(0, model, params, **kw)
    engines.append(eng)
    for a in ("paged", "device_resident", "chunked_prefill", "prefix_cache",
              "fused_mixed"):
        assert getattr(eng, a) == getattr(jeng, a), a
    reqs = [treq_mod.ServeRequest(i, p.copy(), NEW)
            for i, p in enumerate(prompts)]
    reserved = _serve(eng, reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.first_token_step, r.finish_step) for r in reqs] == \
        [(r.first_token_step, r.finish_step) for r in jreqs]
    assert reserved == jreserved
    for c in COUNTERS:
        assert getattr(eng, c) == getattr(jeng, c), c
    assert eng.peak_kv_bytes > 0
    if not eng.prefix_cache:
        assert eng.cached_prompt_tokens_total == 0
        assert eng.prefix_digests() == frozenset()


def _expected_forwards(eng, reqs, step, gen0, chunk_tokens):
    """Attention-bearing forwards the step at engine step ``step`` should
    have made: the fused chunked loop one when it has chunks or decodes;
    otherwise one per whole prompt prefilled (or one for the step's
    chunks) plus one decode forward when a request decoded."""
    firsts = sum(r.first_token_step == step for r in reqs
                 if not r.rejected)
    decoded = sum(len(r.generated) for r in reqs) - gen0 - firsts > 0
    prompt = (chunk_tokens > 0) if eng.chunked_prefill else firsts
    if eng.fused_mixed:
        return int(prompt or decoded)
    return int(prompt) + int(decoded)


@pytest.mark.parametrize("mode", list(MODES))
def test_one_d2h_and_the_mode_forwards_per_step(setup, engines, monkeypatch,
                                                mode):
    cfg, model, params, prompts = setup
    calls = []
    real = engine_mod.d2h
    monkeypatch.setattr(engine_mod, "d2h",
                        lambda x: calls.append(1) or real(x))
    eng = Engine(0, model, params, **KW, **MODES[mode])
    engines.append(eng)
    reqs = [treq_mod.ServeRequest(i, p.copy(), NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    while not all(r.state.name == "FINISHED" for r in reqs):
        assert eng.steps < 300
        calls.clear()
        a0 = engine_mod.ATTN_CALLS
        gen0 = sum(len(r.generated) for r in reqs)
        p0 = eng.prefill_tokens_done
        eng.step()
        grew = sum(len(r.generated) for r in reqs) > gen0
        assert len(calls) == int(grew), (eng.steps, len(calls))
        assert engine_mod.ATTN_CALLS - a0 == _expected_forwards(
            eng, reqs, eng.steps, gen0, eng.prefill_tokens_done - p0)


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_rejects_prompts_that_never_fit(setup, engines, mode):
    cfg, model, params, prompts = setup
    eng = Engine(0, model, params, max_slots=2, max_seq=16,
                 prefill_token_budget=8, **MODES[mode])
    engines.append(eng)
    big = treq_mod.ServeRequest(0, prompts[1].copy(), 4)     # 23 + 1 > 16
    ok = treq_mod.ServeRequest(1, prompts[0].copy(), 4)
    _serve(eng, [big, ok])
    assert big.rejected and not big.generated
    assert len(ok.generated) == 4 and not ok.rejected
    assert eng.reserved_tokens() == 0 and eng.used_tokens() == 0


def test_slab_rejects_int8_and_chunking(setup):
    _, model, params, _ = setup
    with pytest.raises(ValueError, match="paged"):
        Engine(0, model, params, paged=False, kv_dtype="int8")
    with pytest.raises(ValueError, match="paged"):
        Engine(0, model, params, paged=False, chunked_prefill=True)
    eng = Engine(0, model, params, paged=False, device_resident=True,
                 prefix_cache=True, **KW)
    assert not (eng.device_resident or eng.chunked_prefill
                or eng.prefix_cache)
    assert eng.kv_bytes_pinned() == 0 == eng.block_size


# --------------------------------------------------------------------------
# Migration
# --------------------------------------------------------------------------
def _next_logits(model, params, eng, req):
    """The next-token logits of a running request, computed from the
    engine's exported wire piece in a fresh one-row slab."""
    _, piece, _ = eng.export_slot(req.slot)
    cache = model.init_cache(1, eng.max_seq, device="cpu")
    for a, p in zip(cache, piece):
        a[:, :, :p.shape[2]] = p
    logits, _ = model.decode_step(
        params, cache, torch.tensor([req.generated[-1]], dtype=torch.int32),
        torch.tensor([req.length - 1], dtype=torch.int32))
    return logits[0].numpy()


def _carry(req, dst_mod):
    """The request's state as the destination package's ServeRequest."""
    out = dst_mod.ServeRequest(req.req_id, req.prompt.copy(),
                               req.max_new_tokens)
    out.generated = list(req.generated)
    out.ctx_done = req.ctx_done
    out.first_token_step = req.first_token_step
    out.state = dst_mod.State.RUNNING
    return out


def _to_finish(eng, req, limit=200):
    while req.state.name != "FINISHED":
        assert eng.steps < limit
        eng.step()


@pytest.mark.parametrize("src_paged,dst_paged",
                         [(False, True), (True, False), (False, False)],
                         ids=["slab-to-paged", "paged-to-slab",
                              "slab-to-slab"])
def test_slab_paged_round_trip_bit_identical_logits(setup, engines,
                                                    src_paged, dst_paged):
    """export_slot -> import_request -> evict_slot between layouts: the
    receiver's next-token logits are bit-identical to those of a twin of
    the sender that never migrated, and the stream continues as the
    twin's (after ``tests/test_paged.py``'s reference test)."""
    cfg, model, params, prompts = setup
    mk = lambda i, paged: Engine(i, model, params, max_slots=2, max_seq=64,
                                 paged=paged)
    src, dst, twin = mk(0, src_paged), mk(1, dst_paged), mk(2, src_paged)
    engines.extend([src, dst, twin])
    r = treq_mod.ServeRequest(0, prompts[2].copy(), 12)
    ref = treq_mod.ServeRequest(9, prompts[2].copy(), 12)
    src.submit(r)
    twin.submit(ref)
    for _ in range(4):
        src.step()
        twin.step()
    slot = r.slot
    req, piece, nbytes = src.export_slot(slot)
    assert piece.k.shape[2] == r.length - 1
    assert dst.import_request(req, piece)
    src.evict_slot(slot)
    assert dst.slots[r.slot] is r and dst.id in r.tokens_by_engine
    np.testing.assert_array_equal(_next_logits(model, params, dst, r),
                                  _next_logits(model, params, twin, ref))
    _to_finish(dst, r)
    _to_finish(twin, ref)
    assert r.generated == ref.generated


@pytest.mark.parametrize("first", ["torch", "jax"])
def test_torch_jax_slab_round_trip_bit_identical_logits(jx, setup, engines,
                                                        first):
    """A slab request carried out and back through the other framework's
    slab engine (numpy on the wire): its rows come home bit for bit, so
    the home engine's next logits equal those of a twin that never
    migrated."""
    cfg, model, params, prompts = setup
    kw = dict(max_slots=2, max_seq=64, paged=False)
    tmk = lambda i: Engine(i, model, params, **kw)
    jmk = lambda i: jx.engine.Engine(i, jx.model, jx.params, **kw)
    home_mk, away_mk = (tmk, jmk) if first == "torch" else (jmk, tmk)
    home_mod = treq_mod if first == "torch" else jx.req
    away_mod = jx.req if first == "torch" else treq_mod
    src, twin, back = home_mk(0), home_mk(2), home_mk(3)
    away = away_mk(1)
    r = home_mod.ServeRequest(0, prompts[2].copy(), 12)
    ref = home_mod.ServeRequest(9, prompts[2].copy(), 12)
    src.submit(r)
    twin.submit(ref)
    for _ in range(4):
        src.step()
        twin.step()

    def wire(piece, to):
        k, v = (bridge.pool_to_numpy(piece) if isinstance(piece, KVCache)
                else jx.jax.tree.map(np.asarray, piece))
        if to == "torch":
            return bridge.pool_from_numpy((k, v), device="cpu")
        return jx.attn.KVCache(jx.jnp.asarray(k), jx.jnp.asarray(v))

    there, here = (("jax", "torch") if first == "torch"
                   else ("torch", "jax"))
    _, piece, _ = src.export_slot(r.slot)
    moved = _carry(r, away_mod)
    src.evict_slot(r.slot)
    assert away.import_request(moved, wire(piece, there))
    _, piece, _ = away.export_slot(moved.slot)
    home = _carry(moved, home_mod)
    away.evict_slot(moved.slot)
    assert back.import_request(home, wire(piece, here))
    if first == "torch":
        engines.extend([src, twin, back])
        got = _next_logits(model, params, back, home)
        want = _next_logits(model, params, twin, ref)
    else:
        engines.append(away)
        got, want = (_jax_next_logits(jx, e, q)
                     for e, q in ((back, home), (twin, ref)))
    np.testing.assert_array_equal(got, want)
    _to_finish(back, home)
    _to_finish(twin, ref)
    assert home.generated == ref.generated


def _jax_next_logits(jx, eng, req):
    _, piece, _ = eng.export_slot(req.slot)
    cache = jx.model.init_cache(1, eng.max_seq)
    cache = jx.jax.tree.map(
        lambda a, p: a.at[:, :, :p.shape[2]].set(p.astype(a.dtype)),
        cache, piece)
    logits, _ = jx.model.decode_step(
        eng.params, cache, jx.jnp.asarray([req.generated[-1]], jx.jnp.int32),
        jx.jnp.asarray([req.length - 1], jx.jnp.int32))
    return np.asarray(logits[0])


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
def test_whole_prompt_engine_refuses_a_partial_prefill(setup, engines,
                                                       paged):
    """A request exported mid-prefill by a chunking engine has nowhere to
    resume its prompt on a whole-prompt engine: refused, nothing held."""
    cfg, model, params, prompts = setup
    src = Engine(0, model, params, **KW)
    dst = Engine(1, model, params, chunked_prefill=False, paged=paged, **KW)
    engines.extend([src, dst])
    r = treq_mod.ServeRequest(0, prompts[3].copy(), NEW)
    src.submit(r)
    src.step()
    assert r.prefilling and r.ctx_done == 8
    req, piece, _ = src.export_slot(r.slot)
    assert not dst.import_request(req, piece)
    assert dst.reserved_tokens() == 0 and dst.used_tokens() == 0
    assert r.engine_id == 0
    _to_finish(src, r)


# --------------------------------------------------------------------------
# SLO decisions on a whole-prompt engine
# --------------------------------------------------------------------------
# (prompt, new tokens, class, arrival step): two batch requests fill the
# slots; an interactive arrival parks one (a slot shortage); a large
# interactive one is short of memory, whose recompute the whole-prompt
# engine refuses; a batch request marked recompute-preempted at step 0
# ages while it waits
SLO_TRACE = ((12, 40, "batch", 0), (10, 20, "batch", 0),
             (8, 10, "interactive", 3), (20, 30, "interactive", 6),
             (8, 8, "batch", 1))
SLO_KW = dict(max_slots=2, max_seq=64, token_budget=128, preemption=True,
              chunked_prefill=False, attn_backend="dense",
              slo_time_scale=0.05)


def _slo_log(eng, mod, vocab, monkeypatch, engine_module):
    modes = []
    real = engine_module.park_or_recompute

    def logged(**kw):
        mode = real(**kw)
        modes.append((eng.steps, mode))
        return mode
    monkeypatch.setattr(engine_module, "park_or_recompute", logged)
    rng = np.random.default_rng(12)
    reqs = []
    for i, (n, new, cls, _) in enumerate(SLO_TRACE):
        r = mod.ServeRequest(i, rng.integers(0, vocab, n).astype(np.int32),
                             new)
        r.slo_class = cls
        r.arrival_step = SLO_TRACE[i][3]
        reqs.append(r)
    log = []
    while not all(r.state.name == "FINISHED" for r in reqs):
        assert eng.steps < 300
        for r, (_, _, _, at) in zip(reqs, SLO_TRACE):
            if at == eng.steps and r.state.name == "WAITING" \
                    and r.sched_key is None:
                eng.submit(r)
                if r.req_id == 4:       # an earlier recompute victim
                    r.preempted_step = eng.steps
        eng.step()
        log.append((eng.steps, eng.preemptions, eng.preempt_recomputes,
                    eng.resumes, eng.tpot_skipped,
                    [(r.req_id, r.sched_key) for r in eng.waiting],
                    sorted(p.req.req_id for p in eng.parked),
                    [None if r is None else r.req_id for r in eng.slots]))
    eng.check_drained()
    return log, modes, [list(r.generated) for r in reqs]


def test_whole_prompt_slo_decisions_match_jax(jx, setup, monkeypatch):
    """The decision log of a whole-prompt engine with preemption on —
    each step's counters, waiting keys, parked and slotted requests, and
    every park-or-recompute choice — equals the reference's: a park, a
    recompute refused (no chunked path to rebuild the KV), and a key
    aged on admission (the reference ages only there)."""
    cfg, model, params, _ = setup
    jlog, jmodes, jstreams = _slo_log(
        jx.engine.Engine(0, jx.model, jx.params, **SLO_KW), jx.req,
        cfg.vocab_size, monkeypatch, jx.engine)
    log, modes, streams = _slo_log(Engine(0, model, params, **SLO_KW),
                                   treq_mod, cfg.vocab_size, monkeypatch,
                                   engine_mod)
    assert log == jlog
    assert modes == jmodes
    assert streams == jstreams
    assert any(m == "park" for _, m in modes) and log[-1][1] > 0
    assert any(m == "recompute" for _, m in modes) and log[-1][2] == 0
    aged = [k for entry in log for rid, k in entry[5]
            if k[0] < priority_of(SLO_TRACE[rid][2])]
    assert aged


# --------------------------------------------------------------------------
# Server and launcher
# --------------------------------------------------------------------------
SERVER_TRACE = ((20, 30, 0), (35, 16, 0), (12, 34, 1), (44, 10, 2),
                (9, 24, 3), (30, 20, 4))


@pytest.mark.parametrize("mode", ["slab", "whole-prompt-flat"])
def test_server_mode_matches_jax_server(jx, setup, mode):
    """``MILSServer`` passes the mode kwargs to every engine: the cluster
    (4 engines, two stages split at 32 tokens) makes the reference
    server's decisions and streams, migrations included."""
    cfg, model, params, _ = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _, _ in SERVER_TRACE]
    kw = dict(max_slots=3, max_seq=128, **MODES[mode])
    runs = {}
    for name, mod, srv_mod, part, qoe, m, p in (
            ("jax", jx.req, jx.server, jx.partition, jx.qoe, jx.model,
             jx.params),
            ("torch", treq_mod, types.SimpleNamespace(
                MILSServer=MILSServer, ServerConfig=ServerConfig),
             types.SimpleNamespace(PipelinePlan=PipelinePlan, Stage=Stage),
             types.SimpleNamespace(QoEModel=QoEModel), model, params)):
        plan = part.PipelinePlan([part.Stage(0.0, 32.0, 2),
                                  part.Stage(32.0, float("inf"), 2)], 0.0)
        srv = srv_mod.MILSServer(
            m, p, plan, qoe.QoEModel(np.array([1e-3, 1e-4, 1e-6, 0.0, 1e-6])),
            srv_mod.ServerConfig(seed=0, preemption=False, host_kv_budget=0),
            **kw)
        reqs = [mod.ServeRequest(i, pr.copy(), new)
                for i, (pr, (_, new, _)) in enumerate(zip(prompts,
                                                          SERVER_TRACE))]
        for r, (_, _, at) in zip(reqs, SERVER_TRACE):
            srv.submit_at(r, at)
        srv.run(max_steps=400)
        runs[name] = (srv, reqs)
    (jsrv, jreqs), (srv, reqs) = runs["jax"], runs["torch"]
    for e, je in zip(srv.engines, jsrv.engines):
        assert (e.paged, e.chunked_prefill) == (je.paged, je.chunked_prefill)
    assert srv.plane.decisions == jsrv.plane.decisions
    assert srv.migrations == jsrv.migrations > 0
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert srv.steps == jsrv.steps


@pytest.mark.parametrize("flags", [["--no-chunked-prefill"], ["--host-loop"],
                                   ["--no-prefix-cache"]])
def test_launcher_mode_flags_on_the_cpu(capsys, flags):
    args = serve.parse_args(["--device", "cpu", *flags])
    srv = serve.build_server(args)
    eng = srv.engines[0]
    assert eng.chunked_prefill == ("--no-chunked-prefill" not in flags)
    assert eng.device_resident == ("--host-loop" not in flags)
    assert eng.prefix_cache == ("--no-prefix-cache" not in flags
                                and eng.chunked_prefill)
    assert eng.host_kv_budget == (0 if "--no-prefix-cache" in flags
                                  else 4096)
    serve.main(["--device", "cpu", "--engines", "2", "--requests", "6",
                *flags])
    out = capsys.readouterr().out
    assert "summary:" in out and "stage bounds:" in out


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
GPU_MODES = {"whole-prompt": dict(chunked_prefill=False),
             "slab": dict(paged=False),
             "host-loop": dict(device_resident=False),
             "no-prefix-cache": dict(prefix_cache=False)}


@pytest.fixture
def cuda():
    """The card, decided here (never at import or collection time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(GPU_MODES))
def test_cuda_mode_matches_cpu(cuda, mode):
    """Each mode at 2 layers of full-width llama3.2-3b, f32, on the card
    (the contiguous prefill and decode kernels, the fused kernel) and on
    the CPU (their plain versions), same weights: equal greedy streams and
    counters."""
    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=2,
                              dtype=torch.float32)
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        params = cpu_params if dev == "cpu" else _to(cpu_params, cuda)
        eng = Engine(0, model, params, max_slots=3, max_seq=512,
                     prefill_token_budget=64, **GPU_MODES[mode])
        rng = np.random.default_rng(1)
        reqs = [treq_mod.ServeRequest(
            i, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
            for i, n in enumerate((40, 130, 17, 300))]
        _serve(eng, reqs)
        eng.check_drained()
        runs[dev] = ([r.generated for r in reqs],
                     [getattr(eng, c) for c in COUNTERS])
    assert runs["cuda"] == runs["cpu"]


def _to(tree, device):
    return {k: (_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}
