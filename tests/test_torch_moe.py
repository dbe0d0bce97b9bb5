"""The port's MoE family vs the JAX reference, f32 on the CPU, on reduced
qwen3-moe-30b-a3b (4 experts, top 2) and reduced arctic-480b (top 2 plus
the dense residual FFN), with the JAX weights bridged over: routing, the
expert FFN, ``moe_dense`` (also tiled over tokens), ``moe_gshard`` at three
capacity factors, the MoE block, the forwards, the init scale and the f32
router, then the engine (fused on the plain path, dense) and a 2-engine
``MILSServer`` against the JAX engine and server: equal greedy streams and
decision logs. Tolerances: 1e-5 per op, 1e-4 on logits (as
``tests/test_torch_models.py``), relative to the largest magnitude of the
reference's output where that exceeds 1."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.engine as jax_engine_mod  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.partition import PipelinePlan as JaxPlan  # noqa: E402
from repro.core.partition import Stage as JaxStage  # noqa: E402
from repro.core.qoe import QoEModel as JaxQoE  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.request import ServeRequest as JaxRequest  # noqa: E402
from repro.serving.server import MILSServer as JaxServer  # noqa: E402
from repro.serving.server import ServerConfig as JaxConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partition import PipelinePlan, Stage  # noqa: E402
from repro_torch.core.qoe import QoEModel  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest  # noqa: E402
from repro_torch.serving.server import MILSServer, ServerConfig  # noqa: E402

NAMES = ["qwen3-moe-30b-a3b", "arctic-480b"]
OP_TOL, LOGIT_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """(JAX cfg, JAX params, port cfg, port params) on the same weights."""
    jcfg = jax_get_config(request.param).reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(request.param).reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return jcfg, jparams, cfg, params


def t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _layer0(jparams, params, key):
    return (jax.tree.map(lambda a: a[0], jparams["layers"][key]),
            layer_params(params["layers"], 0)[key])


def _x(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, shape + (cfg.d_model,)).astype(np.float32)


def _close(a, b, tol=OP_TOL):
    """Within ``tol`` of the reference, relative to its largest magnitude
    (the reduced experts' outputs reach ~1e3 in f32)."""
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b,
                               atol=tol * max(1.0, float(np.abs(b).max())),
                               rtol=tol)


# --------------------------------------------------------------------------
# The MoE layer
# --------------------------------------------------------------------------
def test_route_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    pj, pt = _layer0(jparams, params, "moe")
    xf = _x(cfg, (37,), 1)
    jp, jw, ji, ja = jmlp._route(pj, jcfg, jnp.asarray(xf))
    tp, tw, ti, ta = tmlp._route(pt, cfg, t(xf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tp.numpy(), jp)
    _close(tw.numpy(), jw)
    _close(ta.item(), ja)
    assert tp.dtype == tw.dtype == torch.float32


def test_experts_match_reference(pair):
    jcfg, jparams, cfg, params = pair
    pj, pt = _layer0(jparams, params, "moe")
    xe = _x(cfg, (cfg.num_experts, 2, 5), 2)
    _close(tmlp._experts(pt, cfg, t(xe)).numpy(),
           jmlp._experts(pj, jcfg, jnp.asarray(xe)))


def test_moe_dense_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    pj, pt = _layer0(jparams, params, "moe")
    x = _x(cfg, (2, 9), 3)
    jy, ja = jmlp.moe_dense(pj, jcfg, jnp.asarray(x))
    ty, ta = tmlp.moe_dense(pt, cfg, t(x))
    _close(ty.numpy(), jy)
    _close(ta.item(), ja)
    ty2, _ = tmlp.moe(pt, cfg, t(x))               # cfg.moe_impl: dense
    assert torch.equal(ty, ty2)


def _token_bytes(cfg, elem_bytes):
    """``moe_dense``'s temporaries a token, the unit of its tile budget."""
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    return E * (2 * D * elem_bytes + 3 * Fd * elem_bytes + 8 * D)


@pytest.mark.parametrize("tile", [1, 3, None])
def test_moe_dense_tiles_give_the_untiled_output(pair, tile, monkeypatch):
    """Tokens are independent: any tile of the token axis (None: one tile
    of all N), set through the byte budget ``MOE_TILE_BYTES``, gives the
    untiled output, bit for bit from 3 rows a tile; a tile of one row
    takes the CPU BLAS's matrix-vector kernel, which rounds otherwise, so
    it is held within 1e-6 of the output's largest magnitude (f32
    rounding of a 512-term sum)."""
    _, _, cfg, params = pair
    pt = layer_params(params["layers"], 0)["moe"]
    x = t(_x(cfg, (3, 7), 4))
    per_token = _token_bytes(cfg, x.element_size())

    def run(n):
        monkeypatch.setattr(tmlp, "MOE_TILE_BYTES", n * per_token)
        assert tmlp.moe_token_tile(cfg, x.element_size()) == n
        return tmlp.moe_dense(pt, cfg, x)
    whole, aux = run(x.shape[0] * x.shape[1])
    tiled, aux_t = run(tile or 21)
    if tile == 1:
        _close(tiled.numpy(), whole.numpy(), tol=1e-6)
    else:
        assert torch.equal(tiled, whole)
    assert aux_t.item() == aux.item()


def test_moe_token_tile_is_a_byte_budget():
    cfg = get_config("qwen3-moe-30b-a3b")
    tile = tmlp.moe_token_tile(cfg, 2)
    per_token = 128 * (2 * 2048 * 2 + 3 * 768 * 2 + 8 * 2048)
    assert per_token == _token_bytes(cfg, 2)
    assert tile == tmlp.MOE_TILE_BYTES // per_token
    assert tile * per_token <= tmlp.MOE_TILE_BYTES < (tile + 1) * per_token
    assert tmlp.moe_token_tile(get_config("arctic-480b"), 4) >= 1


@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
def test_moe_gshard_matches_reference_gshard(pair, cf):
    """Held against the reference's gshard itself (its gshard and dense
    disagree, a reference caveat); cf 0.25 drops most pairs, 8 none."""
    jcfg, jparams, cfg, params = pair
    pj, pt = _layer0(jparams, params, "moe")
    x = _x(cfg, (2, 9), 5)
    jy, ja = jmlp.moe_gshard(pj, jcfg, jnp.asarray(x), capacity_factor=cf)
    ty, ta = tmlp.moe_gshard(pt, cfg, t(x), capacity_factor=cf)
    _close(ty.numpy(), jy)
    _close(ta.item(), ja)


def test_moe_impl_selects_gshard(pair):
    _, _, cfg, params = pair
    pt = layer_params(params["layers"], 0)["moe"]
    x = t(_x(cfg, (2, 9), 6))
    g = dataclasses.replace(cfg, moe_impl="gshard")
    assert torch.equal(tmlp.moe(pt, g, x)[0],
                       tmlp.moe_gshard(pt, g, x)[0])
    with pytest.raises(ValueError):
        tmlp.moe(pt, cfg, x, impl="topk")


def test_mlp_part_matches_reference(pair):
    """The MoE half of a block (arctic: plus the dense residual FFN on
    ``rms_norm(x, ln_res)``)."""
    jcfg, jparams, cfg, params = pair
    pj = jax.tree.map(lambda a: a[0], jparams["layers"])
    pt = layer_params(params["layers"], 0)
    assert ("ffn" in pt) == ("ln_res" in pt) == cfg.dense_residual
    x = _x(cfg, (2, 6), 7)
    jy, _ = jtr._mlp_part(pj, jcfg, jnp.asarray(x))
    _close(ttr._mlp_part(pt, cfg, t(x)).numpy(), jy)


# --------------------------------------------------------------------------
# Forwards
# --------------------------------------------------------------------------
def test_forward_full_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    jlog, jcache, _ = jtr.forward_full(jparams, jcfg, jnp.asarray(tok),
                                       return_cache=True)
    tlog, tcache, _ = ttr.forward_full(params, cfg, t(tok),
                                       return_cache=True)
    _close(tlog.numpy(), jlog, LOGIT_TOL)
    _close(tcache.k.numpy(), jcache.k)
    _close(tcache.v.numpy(), jcache.v)


def test_forward_mixed_matches_reference(pair):
    """Both halves of a mixed step run the MoE (decode rows and chunk
    rows), one fused plain-path call against the JAX fused kernel."""
    jcfg, jparams, cfg, params = pair
    BS, NB = 16, 12
    rng = np.random.default_rng(9)
    shape = (cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim)
    k = rng.normal(0, 1, shape).astype(np.float32)
    v = rng.normal(0, 1, shape).astype(np.float32)
    pos = np.asarray([20, -1], np.int32)
    bt_dec = np.asarray([[0, 1], [NB - 1, NB - 1]], np.int32)
    bt_ck = np.asarray([[2, 3]], np.int32)
    ctx, clen = np.asarray([10], np.int32), np.asarray([7], np.int32)
    tok = np.asarray([5, 0], np.int32)
    ck = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    jd, jc, _ = jtr.forward_mixed(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(ck),
        jattn.KVCache(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(bt_dec),
        jnp.asarray(bt_ck), jnp.asarray(pos), jnp.asarray(ctx),
        jnp.asarray(clen), attn_backend="fused", attn_interpret=True)
    td, tc, _ = build_model(cfg).mixed_step(
        params, bridge.pool_from_numpy((k, v), device="cpu"), t(tok), t(ck),
        t(bt_dec), t(bt_ck), t(pos), t(ctx), t(clen))
    _close(td.numpy()[0], np.asarray(jd)[0], LOGIT_TOL)
    _close(tc.numpy(), jc, LOGIT_TOL)


# --------------------------------------------------------------------------
# Init and the bridge
# --------------------------------------------------------------------------
def test_init_scale_matches_reference():
    """The reference's ``dense_init`` takes fan_in = shape[0], which for an
    expert leaf [E, D, F] is E: std 1/sqrt(E). At qwen3-moe's 128 experts
    (narrowed D, F and depth) that is 1/sqrt(128); the router's is
    1/sqrt(D)."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=2,
                              d_model=64, d_ff=48, vocab_size=64,
                              num_heads=4, num_kv_heads=2, head_dim=16)
    p = build_model(cfg).init(3, device="cpu")["layers"]["moe"]
    assert p["w_gate"].shape == (2, 128, 64, 48)
    assert p["w_down"].shape == (2, 128, 48, 64)
    for key in ("w_gate", "w_up", "w_down"):
        assert p[key].std().item() == pytest.approx(1 / math.sqrt(128),
                                                    rel=0.02), key
    assert p["router"].std().item() == pytest.approx(1 / math.sqrt(64),
                                                     rel=0.05)
    jcfg = dataclasses.replace(jax_get_config("qwen3-moe-30b-a3b"),
                               d_model=64, d_ff=48)
    jp = jmlp.init_moe(jax.random.PRNGKey(3), jcfg)
    assert float(jnp.std(jp["w_gate"])) == pytest.approx(
        1 / math.sqrt(128), rel=0.02)


def test_router_stays_f32_under_bf16(pair):
    jcfg, jparams, cfg, _ = pair
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      bcfg, device="cpu")
    moe = params["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  np.asarray(jparams["layers"]["moe"]
                                             ["router"]))
    assert moe["w_gate"].dtype == params["embed"].dtype == torch.bfloat16
    drawn = build_model(bcfg).init(0, device="cpu")["layers"]["moe"]
    assert drawn["router"].dtype == torch.float32
    assert drawn["w_up"].dtype == torch.bfloat16
    x = torch.randn(1, 3, cfg.d_model, dtype=torch.bfloat16)
    y, _ = tmlp.moe_dense(layer_params(params["layers"], 0)["moe"], bcfg, x)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


def test_bridge_checks_the_layer_keys(pair):
    jcfg, jparams, cfg, _ = pair
    tree = jax.tree.map(np.asarray, jparams)
    bad = dict(tree, layers={k: v for k, v in tree["layers"].items()
                             if k != "moe"})
    with pytest.raises(KeyError):
        bridge.params_from_numpy(bad, cfg, device="cpu")


def test_large_leaves_are_drawn_in_slices(monkeypatch):
    """A leaf above ``DRAW_ELEMS`` is drawn slice by slice into its own
    dtype: the same seed gives the same weights, and a leaf within the
    limit is one draw, as before."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    small = build_model(cfg).init(4, device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    one = tcommon.dense_init(g, (3, 5, 7), torch.float32, fan_in=4)
    g.manual_seed(0)
    ref = torch.randn((3, 5, 7), generator=g).mul_(0.5)
    assert torch.equal(one, ref)
    monkeypatch.setattr(tcommon, "DRAW_ELEMS", 50)
    a = build_model(cfg).init(4, device="cpu")
    b = build_model(cfg).init(4, device="cpu")
    for key in ("w_gate", "w_down", "router"):
        assert torch.equal(a["layers"]["moe"][key], b["layers"]["moe"][key])
        assert a["layers"]["moe"][key].dtype == \
            small["layers"]["moe"][key].dtype
    assert torch.equal(a["embed"], b["embed"])
    std = a["layers"]["moe"]["w_gate"].std().item()
    assert std == pytest.approx(1 / math.sqrt(cfg.num_experts), rel=0.02)


# --------------------------------------------------------------------------
# Engines and the server
# --------------------------------------------------------------------------
PROMPTS = (5, 23, 12)
NEW = 8


def _drain(eng, reqs, max_iters=200):
    for r in reqs:
        eng.submit(r)
    out = []
    for _ in range(max_iters):
        out += eng.step()
        if len(out) == len(reqs):
            return out
    raise AssertionError("engine did not drain")


@pytest.fixture(scope="module", params=NAMES)
def served(request):
    jcfg = jax_get_config(request.param).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(request.param).reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    return jmodel, jparams, build_model(cfg), params, prompts


@pytest.mark.parametrize("backend", ["fused", "dense"])
def test_engine_streams_match_jax_engine(served, backend):
    """The reference's fused engine (Pallas in interpret mode) or dense
    engine against the port's on the same backend (fused: its plain path
    on the CPU): equal greedy streams, first-token steps and step count."""
    jmodel, jparams, model, params, prompts = served
    jeng = jax_engine_mod.Engine(0, jmodel, jparams, max_slots=3,
                                 max_seq=64, attn_backend=backend,
                                 prefill_token_budget=8)
    jreqs = [JaxRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _drain(jeng, jreqs)
    eng = Engine(0, model, params, max_slots=3, max_seq=64,
                 prefill_token_budget=8, attn_backend=backend)
    assert eng.fused_mixed == jeng.fused_mixed == (backend == "fused")
    reqs = [ServeRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _drain(eng, reqs)
    eng.check_drained()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [r.first_token_step for r in reqs] == \
        [r.first_token_step for r in jreqs]
    assert eng.steps == jeng.steps


QOE = np.array([1e-3, 1e-4, 1e-6, 0.0, 1e-6])
# short prompts that decode across the 40-token stage boundary, one that
# starts above it
TRACE = [(20, 26, 0), (35, 14, 0), (12, 30, 1), (44, 8, 2), (9, 24, 3),
         (28, 16, 4)]
KW = dict(max_slots=3, max_seq=96, prefill_token_budget=16)


def _plan(mod_plan, mod_stage, boundary=40.0):
    return mod_plan([mod_stage(0.0, boundary, 1),
                     mod_stage(boundary, float("inf"), 1)], 0.0)


def test_two_engine_server_matches_jax_server():
    """qwen3-moe reduced on a 2-engine cluster: the port's flat engines
    against the reference's dense ones (the same two-call step): equal
    decision logs, migrations, streams and finish steps."""
    jcfg = jax_get_config("qwen3-moe-30b-a3b").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _, _ in TRACE]

    def submit(srv, make):
        reqs = [make(i, p.copy(), new)
                for i, (p, (_, new, _)) in enumerate(zip(prompts, TRACE))]
        for r, (_, _, at) in zip(reqs, TRACE):
            srv.submit_at(r, at)
        return reqs

    jsrv = JaxServer(jmodel, jparams, _plan(JaxPlan, JaxStage), JaxQoE(QOE),
                     JaxConfig(seed=0, preemption=False, host_kv_budget=0),
                     attn_backend="dense", **KW)
    jreqs = submit(jsrv, JaxRequest)
    jsrv.run(max_steps=400)
    srv = MILSServer(build_model(cfg), params, _plan(PipelinePlan, Stage),
                     QoEModel(QOE),
                     ServerConfig(seed=0, preemption=False,
                                  host_kv_budget=0),
                     attn_backend="flat", **KW)
    reqs = submit(srv, ServeRequest)
    srv.run(max_steps=400)              # asserts every engine drained
    assert srv.plane.decisions == jsrv.plane.decisions
    assert srv.migrations == jsrv.migrations > 0
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.first_token_step, r.finish_step) for r in reqs] == \
        [(r.first_token_step, r.finish_step) for r in jreqs]
    assert srv.steps == jsrv.steps
