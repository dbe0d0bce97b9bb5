"""The port's rwkv6 vs the JAX reference, f32 on the CPU, on reduced
rwkv6-7b (2 layers, d_model 256: 8 heads of 32) with the JAX weights
bridged over: every function of ``models/rwkv6.py``, the reference's two
structure properties (``tests/test_rwkv_structure.py``), the chunked WKV
against the sequential one, the bridge, the slab engine, state migration
between engines and across the frameworks, and a 2-engine ``MILSServer``
that migrates.

Tolerances: functions within ``OP_TOL`` = 1e-5 of the largest magnitude
of the reference's output (where that exceeds 1), logits within 1e-4 as
in ``tests/test_torch_models.py``; the chunked WKV within ``WKV_RTOL`` =
1e-5 of the sequential one's largest magnitude, on the outputs and the
final state. Engines and servers: identical streams and decision logs."""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import migration as jmigration  # noqa: E402
from repro.core.partition import PipelinePlan as JaxPlan  # noqa: E402
from repro.core.partition import Stage as JaxStage  # noqa: E402
from repro.core.qoe import QoEModel as JaxQoE  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.request import ServeRequest as JaxRequest  # noqa: E402
from repro.serving.request import State as JaxState  # noqa: E402
from repro.serving.server import MILSServer as JaxServer  # noqa: E402
from repro.serving.server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.migration import kv_bytes  # noqa: E402
from repro_torch.core.partition import PipelinePlan, Stage  # noqa: E402
from repro_torch.core.qoe import QoEModel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest, State  # noqa: E402
from repro_torch.serving.server import MILSServer, ServerConfig  # noqa: E402

ARCH = "rwkv6-7b"
OP_TOL, LOGIT_TOL, WKV_RTOL = 1e-5, 1e-4, 1e-5
STATE_KEYS = ("S", "att_prev", "ffn_prev")


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, port params) on the same weights."""
    jcfg = jax_get_config(ARCH).reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return jcfg, jparams, cfg, params


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=OP_TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * scale)


def _layer0(pair):
    jcfg, jparams, cfg, params = pair
    return (jax.tree.map(lambda a: a[0], jparams["layers"]),
            trwkv.layer_params(params["layers"], 0))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# --------------------------------------------------------------------------
# Functions
# --------------------------------------------------------------------------
FUNCTIONS = ("_decay", "_group_norm", "_shift", "time_mix_step",
             "time_mix_seq", "time_mix_seq_state", "channel_mix",
             "layer_seq")


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_function_matches_reference(pair, fn):
    jcfg, _, cfg, _ = pair
    jl, tl = _layer0(pair)
    H, K = trwkv._heads(cfg)
    assert (H, K) == jrwkv._heads(jcfg)
    B, T, D = 2, 9, cfg.d_model
    x, xp = _rand(1, B, T, D), _rand(2, B, T, D)
    if fn == "_decay":
        _close(trwkv._decay(tl, t(x)), jrwkv._decay(jl, jnp.asarray(x)))
    elif fn == "_group_norm":
        _close(trwkv._group_norm(t(x), tl["ln_x"], H, K),
               jrwkv._group_norm(jnp.asarray(x), jl["ln_x"], H, K))
    elif fn == "_shift":
        _close(trwkv._shift(t(x)), jrwkv._shift(jnp.asarray(x)), 0)
    elif fn == "time_mix_step":
        S = _rand(3, B, H, K, K)
        y, S1 = trwkv.time_mix_step(tl, cfg, t(x[:, 0]), t(xp[:, 0]), t(S))
        jy, jS1 = jrwkv.time_mix_step(jl, jcfg, jnp.asarray(x[:, 0]),
                                      jnp.asarray(xp[:, 0]), jnp.asarray(S))
        _close(y, jy)
        _close(S1, jS1)
    elif fn == "time_mix_seq":
        _close(trwkv.time_mix_seq(tl, cfg, t(x)),
               jrwkv.time_mix_seq(jl, jcfg, jnp.asarray(x)))
    elif fn == "time_mix_seq_state":
        # continuing from a decode state, the state returned
        S0 = _rand(4, B, H, K, K)
        y, S, last = trwkv.time_mix_seq(tl, cfg, t(x), S0=t(S0),
                                        x_prev0=t(xp[:, 0]),
                                        return_state=True)
        jy, jS, jlast = jrwkv.time_mix_seq(
            jl, jcfg, jnp.asarray(x), S0=jnp.asarray(S0),
            x_prev0=jnp.asarray(xp[:, 0]), return_state=True)
        for a, b in ((y, jy), (S, jS), (last, jlast)):
            _close(a, b)
    elif fn == "channel_mix":
        _close(trwkv.channel_mix(tl, cfg, t(x), t(xp)),
               jrwkv.channel_mix(jl, jcfg, jnp.asarray(x), jnp.asarray(xp)))
    else:
        _close(trwkv.layer_seq(tl, cfg, t(x)),
               jrwkv.layer_seq(jl, jcfg, jnp.asarray(x)))


def _tokens(cfg, B, T, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("chunk", [None, 4])
def test_forward_full_matches_reference(pair, chunk, monkeypatch):
    """The whole forward, on the CPU's sequential WKV and on the chunked
    one (forced here; the card's choice)."""
    jcfg, jparams, cfg, params = pair
    if chunk:
        monkeypatch.setattr(trwkv, "time_mix_seq", functools.partial(
            trwkv.time_mix_seq, chunk=chunk))
    toks = _tokens(cfg, 2, 13)
    want, _, _ = jrwkv.forward_full(jparams, jcfg, jnp.asarray(toks))
    _close(trwkv.forward_full(params, cfg, t(toks)), want, LOGIT_TOL)


def test_prefill_and_decode_match_reference(pair):
    """``prefill`` (its state leaves in the reference's dtypes), then
    ``forward_decode`` of two tokens, in place, and through ``rows`` on a
    wider state."""
    jcfg, jparams, cfg, params = pair
    toks = _tokens(cfg, 2, 11)
    jlog, jst = jrwkv.prefill(jparams, jcfg, jnp.asarray(toks))
    log, st = trwkv.prefill(params, cfg, t(toks), cache_len=999)
    _close(log, jlog, LOGIT_TOL)
    for k in STATE_KEYS:
        assert st[k].dtype == torch.float32 and tuple(st[k].shape) == \
            jst[k].shape
        _close(st[k], jst[k])
    init = trwkv.init_state(cfg, 3, device="cpu")
    jinit = jrwkv.init_state(jcfg, 3)
    for k in STATE_KEYS:
        assert tuple(init[k].shape) == jinit[k].shape and not init[k].any()
    wide = trwkv.init_state(cfg, 5, device="cpu")
    rows = torch.tensor([4, 1])
    for k in STATE_KEYS:
        wide[k][:, rows] = st[k]
    for step, tok in enumerate((7, 3)):
        nxt = np.full(2, tok, np.int32)
        jlog, jst = jrwkv.forward_decode(jparams, jcfg, jnp.asarray(nxt),
                                         jst)
        log, same = trwkv.forward_decode(params, cfg, t(nxt), st)
        wlog, _ = trwkv.forward_decode(params, cfg, t(nxt), wide, rows=rows)
        assert same is st
        _close(log, jlog, LOGIT_TOL)
        np.testing.assert_array_equal(wlog.numpy(), log.numpy())
        for k in STATE_KEYS:
            _close(st[k], jst[k])
            np.testing.assert_array_equal(wide[k][:, rows].numpy(),
                                          st[k].numpy())
    assert not wide["S"][:, [0, 2, 3]].any()     # other rows untouched


# --------------------------------------------------------------------------
# The reference's structure properties, on the port
# --------------------------------------------------------------------------
def test_seq_equals_stepwise(pair):
    _, _, cfg, _ = pair
    _, tl = _layer0(pair)
    H, K = trwkv._heads(cfg)
    B, T, D = 2, 9, cfg.d_model
    x = t(_rand(1, B, T, D))
    S = torch.zeros((B, H, K, K))
    prev = torch.zeros((B, D))
    ys = []
    for i in range(T):
        y, S = trwkv.time_mix_step(tl, cfg, x[:, i], prev, S)
        prev = x[:, i]
        ys.append(y)
    for chunk in (0, 4):
        torch.testing.assert_close(
            trwkv.time_mix_seq(tl, cfg, x, chunk=chunk),
            torch.stack(ys, 1), atol=2e-5, rtol=2e-4)


def test_prefill_state_continues_decode(pair):
    _, _, cfg, params = pair
    toks = t(_tokens(cfg, 2, 8, seed=2))
    logits_pre, state = trwkv.prefill(params, cfg, toks)
    nxt = torch.argmax(logits_pre, -1).to(torch.int32)
    logits_dec, _ = trwkv.forward_decode(params, cfg, nxt, state)
    full = trwkv.forward_full(params, cfg, torch.cat([toks, nxt[:, None]],
                                                     1))
    torch.testing.assert_close(logits_dec, full[:, -1], atol=5e-5,
                               rtol=5e-4)


# --------------------------------------------------------------------------
# The chunked WKV
# --------------------------------------------------------------------------
@pytest.mark.parametrize("T,chunk,decay", [
    (64, 16, 1.0), (100, 16, 1.0), (37, 64, 1.0), (1, 8, 1.0),
    (100, 16, 0.005), (100, 32, 30.0)],
    ids=["whole-chunks", "ragged-tail", "under-one-chunk", "one-token",
         "slow-decay", "fast-decay"])
def test_chunked_wkv_equals_sequential(T, chunk, decay):
    """Chunked == sequential on outputs and the final state, with a
    nonzero S0 and T not always a multiple of the chunk. ``fast-decay``
    puts log w down to -30 a token: products over a chunk underflow to 0,
    which a form dividing by cumulative products would turn into inf."""
    g = torch.Generator().manual_seed(T + chunk)
    B, H, K = 2, 3, 8
    r, k, v = (torch.randn(B, T, H, K, generator=g) for _ in range(3))
    lw = -torch.rand(B, T, H, K, generator=g) * decay
    u = torch.randn(H, K, generator=g)
    S0 = torch.randn(B, H, K, K, generator=g)
    y1, S1 = trwkv.wkv_sequential(r, k, v, torch.exp(lw), u, S0)
    y2, S2 = trwkv.wkv_chunked(r, k, v, lw, u, S0, chunk)
    for a, b in ((y2, y1), (S2, S1)):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= WKV_RTOL * b.abs().max()


def test_chunked_wkv_groups_of_chunks(monkeypatch):
    """The pairwise tensors built a chunk at a time give the same
    result as all chunks at once."""
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 70, 2, 4, generator=g) for _ in range(3))
    lw = -torch.rand(1, 70, 2, 4, generator=g)
    u, S0 = torch.randn(2, 4, generator=g), torch.zeros(1, 2, 4, 4)
    whole = trwkv.wkv_chunked(r, k, v, lw, u, S0, 8)
    monkeypatch.setattr(trwkv, "WKV_PAIR_ELEMS", 1)
    one = trwkv.wkv_chunked(r, k, v, lw, u, S0, 8)
    for a, b in zip(one, whole):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# --------------------------------------------------------------------------
# Bridge, init, kv_bytes
# --------------------------------------------------------------------------
def test_bridge_round_trip(pair):
    jcfg, jparams, cfg, params = pair
    assert set(params["layers"]) == bridge.RWKV_LAYER_KEYS
    assert len(bridge.RWKV_LAYER_KEYS) == 22
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = params
        for key in path:
            node = node[key.key]
        assert node.dtype == cfg.dtype
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bad = jax.tree.map(np.asarray, jparams)
    del bad["layers"]["bonus_u"]
    with pytest.raises(KeyError):
        bridge.params_from_numpy(bad, cfg, device="cpu")
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["w_r"] = bad["layers"]["w_r"][:1]
    with pytest.raises(ValueError):
        bridge.params_from_numpy(bad, cfg, device="cpu")


def test_init_is_seeded_stacked_and_shaped_as_reference(pair):
    jcfg, jparams, cfg, _ = pair
    a = build_model(cfg).init(3, device="cpu")
    b = build_model(cfg).init(3, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        na, nb = a, b
        for key in path:
            na, nb = na[key.key], nb[key.key]
        assert tuple(na.shape) == leaf.shape and na.dtype == cfg.dtype
        assert torch.equal(na, nb)
    # the reference's scales: dense_init's 1/sqrt(fan_in), decay_B x 0.1
    D = cfg.d_model
    w = a["layers"]["w_r"].float()
    assert abs(w.std().item() * math.sqrt(D) - 1) < 0.05
    db = a["layers"]["decay_B"].float()
    assert abs(db.std().item() * math.sqrt(trwkv.LORA_R) - 0.1) < 0.01


def test_kv_bytes_counts_every_leaf(pair):
    """``kv_bytes`` walks any pytree, as the reference's does: an int8
    pool (values and scales), a bf16 pool and an rwkv6 state dict."""
    _, _, cfg, _ = pair
    dec = get_config("llama3.2-3b").reduced()
    q = tattn.make_paged_pool(dec, 3, 4, device="cpu", kv_dtype="int8",
                              layers=2)
    f = tattn.make_paged_pool(dec, 3, 4, device="cpu", dtype=torch.bfloat16,
                              layers=2)
    st = trwkv.init_state(dataclasses.replace(cfg, dtype=torch.bfloat16), 1,
                          device="cpu")
    for tree in (q, f, st):
        leaves = tree.values() if isinstance(tree, dict) else tree
        assert kv_bytes(tree) == sum(a.numel() * a.element_size()
                                     for a in leaves)
    H, K = trwkv._heads(cfg)
    assert kv_bytes(st) == cfg.num_layers * (H * K * K * 4
                                             + 2 * cfg.d_model * 2)


# --------------------------------------------------------------------------
# Engines, migration, the server
# --------------------------------------------------------------------------
PROMPTS = (5, 23, 12, 9)
NEW = 8
KW = dict(max_slots=3, max_seq=64)


def _serve(eng, reqs, max_steps=200):
    for r in reqs:
        eng.submit(r)
    while not all(r.state.name == "FINISHED" for r in reqs):
        assert eng.steps < max_steps, "engine did not drain"
        eng.step()


def _prompts(cfg, lens=PROMPTS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def test_slab_engine_matches_jax_engine(pair):
    jcfg, jparams, cfg, params = pair
    model = build_model(cfg)
    with pytest.raises(ValueError, match="paged"):
        Engine(0, model, params, paged=True, **KW)
    with pytest.raises(ValueError, match="paged"):
        Engine(0, model, params, chunked_prefill=True, **KW)
    prompts = _prompts(cfg)
    jeng = jengine.Engine(0, jax_build_model(jcfg), jparams, **KW)
    jreqs = [JaxRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _serve(jeng, jreqs)
    eng = Engine(0, model, params, **KW)
    assert not (eng.paged or eng.chunked_prefill or eng.device_resident)
    reqs = [ServeRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _serve(eng, reqs)
    eng.check_drained()
    jeng.check_drained()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.first_token_step, r.finish_step) for r in reqs] == \
        [(r.first_token_step, r.finish_step) for r in jreqs]
    for c in ("steps", "tokens_out", "peak_kv_bytes"):
        assert getattr(eng, c) == getattr(jeng, c), c


def _carry(req, mod):
    """The request's state as ``mod``'s ServeRequest (mod: the port's or
    the reference's request module)."""
    req_cls, state = mod
    out = req_cls(req.req_id, req.prompt.copy(), req.max_new_tokens)
    out.generated = list(req.generated)
    out.ctx_done = req.ctx_done
    out.first_token_step = req.first_token_step
    out.state = state.RUNNING
    return out


def _to_finish(eng, req, limit=200):
    while req.state.name != "FINISHED":
        assert eng.steps < limit
        eng.step()


@pytest.mark.parametrize("src", ["torch", "jax"])
def test_state_migration_continues_the_stream(pair, src):
    """A request exported after 4 steps (the whole state, untrimmed:
    34,078,720 B at rwkv6-7b's widths, here the reduced model's) and
    imported into a port engine — from another port engine, or from the
    JAX engine through numpy — decodes the stream of a twin that never
    moved; the piece's bytes equal the reference's count."""
    jcfg, jparams, cfg, params = pair
    model = build_model(cfg)
    prompt = _prompts(cfg, (17,), seed=3)[0]
    twin = Engine(2, model, params, **KW)
    ref = ServeRequest(9, prompt.copy(), 14)
    twin.submit(ref)
    if src == "torch":
        sender = Engine(0, model, params, **KW)
        r = ServeRequest(0, prompt.copy(), 14)
    else:
        sender = jengine.Engine(0, jax_build_model(jcfg), jparams, **KW)
        r = JaxRequest(0, prompt.copy(), 14)
    sender.submit(r)
    for _ in range(4):
        sender.step()
        twin.step()
    _, piece, nbytes = sender.export_slot(r.slot)
    if src == "torch":
        assert set(piece) == set(STATE_KEYS)
        assert piece["S"].shape[1:] == (1,) + tuple(
            twin.cache["S"].shape[2:])
        assert nbytes == jmigration.kv_bytes(jrwkv.init_state(jcfg, 1))
        moved = r
    else:
        piece = bridge.pool_from_numpy(jax.tree.map(np.asarray, piece),
                                       device="cpu")
        assert kv_bytes(piece) == nbytes
        moved = _carry(r, (ServeRequest, State))
    sender.evict_slot(r.slot)
    dst = Engine(1, model, params, **KW)
    assert dst.import_request(moved, piece)
    _to_finish(dst, moved)
    _to_finish(twin, ref)
    assert moved.generated == ref.generated
    dst.check_drained()


def test_state_migration_port_to_jax(pair):
    """The other direction: a port engine's state, through numpy, into
    the JAX engine, continuing the stream of a JAX twin."""
    jcfg, jparams, cfg, params = pair
    jmodel = jax_build_model(jcfg)
    prompt = _prompts(cfg, (13,), seed=4)[0]
    twin = jengine.Engine(2, jmodel, jparams, **KW)
    ref = JaxRequest(9, prompt.copy(), 12)
    twin.submit(ref)
    src = Engine(0, build_model(cfg), params, **KW)
    r = ServeRequest(0, prompt.copy(), 12)
    src.submit(r)
    for _ in range(3):
        src.step()
        twin.step()
    _, piece, _ = src.export_slot(r.slot)
    src.evict_slot(r.slot)
    moved = _carry(r, (JaxRequest, JaxState))
    dst = jengine.Engine(1, jmodel, jparams, **KW)
    assert dst.import_request(moved, {k: jnp.asarray(a) for k, a in
                                      bridge.pool_to_numpy(piece).items()})
    _to_finish(dst, moved)
    _to_finish(twin, ref)
    assert moved.generated == ref.generated
    src.check_drained()


QOE = np.array([1e-3, 1e-4, 1e-6, 0.0, 1e-6])
# prompts below the 32-token stage bound that decode across it
SERVER_TRACE = ((20, 20, 0), (9, 30, 0), (40, 6, 1), (14, 24, 2))


def test_two_engine_server_matches_jax_server(pair):
    """Two slab engines sharing one set of params, stages [0, 32) and
    [32, inf): the reference server's decision log, migrations (at least
    one, of whole states), streams and finish steps."""
    jcfg, jparams, cfg, params = pair
    prompts = _prompts(cfg, [n for n, _, _ in SERVER_TRACE], seed=1)
    runs = {}
    for name, srv_cls, conf, plan, stage, qoe, req, model, p in (
            ("jax", JaxServer, JaxConfig, JaxPlan, JaxStage, JaxQoE,
             JaxRequest, jax_build_model(jcfg), jparams),
            ("torch", MILSServer, ServerConfig, PipelinePlan, Stage,
             QoEModel, ServeRequest, build_model(cfg), params)):
        srv = srv_cls(model, p, plan([stage(0.0, 32.0, 1),
                                      stage(32.0, float("inf"), 1)], 0.0),
                      qoe(QOE), conf(seed=0, preemption=False,
                                     host_kv_budget=0),
                      max_slots=3, max_seq=96)
        reqs = [req(i, pr.copy(), new)
                for i, (pr, (_, new, _)) in enumerate(zip(prompts,
                                                          SERVER_TRACE))]
        for r, (_, _, at) in zip(reqs, SERVER_TRACE):
            srv.submit_at(r, at)
        srv.run(max_steps=300)
        runs[name] = (srv, reqs)
    (jsrv, jreqs), (srv, reqs) = runs["jax"], runs["torch"]
    assert not any(e.paged for e in srv.engines)
    assert srv.plane.decisions == jsrv.plane.decisions
    assert srv.migrations == jsrv.migrations > 0
    # each piece a whole one-row state, the reference's count of it
    assert srv.migrated_bytes == srv.migrations * jmigration.kv_bytes(
        jrwkv.init_state(jcfg, 1))
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.first_token_step, r.finish_step) for r in reqs] == \
        [(r.first_token_step, r.finish_step) for r in jreqs]
