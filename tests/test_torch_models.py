"""The port's model layers and paged forwards vs the JAX reference, f32 on
the CPU, on reduced smollm-360m and reduced llama3.2-3b with the JAX
weights bridged over: config copies, the weight/pool bridge, rms_norm,
RoPE, the FFN, the mixed attention layer and the decode / mixed stacks.
The JAX side runs the fused Pallas kernel in interpret mode."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.mlp import ffn  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

NAMES = ["smollm-360m", "llama3.2-3b", "qwen2.5-14b", "minitron-8b",
         "starcoder2-3b"]
# the MoE and VLM decoders (tests/test_torch_moe.py, test_torch_vlm.py)
FAMILY_NAMES = ["qwen3-moe-30b-a3b", "arctic-480b", "qwen2-vl-7b"]
BS, NB = 16, 24            # block NB - 1 is the garbage block
GARBAGE = NB - 1
LOGIT_TOL, POOL_TOL = 1e-4, 1e-5


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


# --------------------------------------------------------------------------
# A mixed iteration: 3 decode slots (one dead) + 2 prompt chunks
# --------------------------------------------------------------------------
POS = np.asarray([20, -1, 40], np.int32)          # tokens already cached
CTX = np.asarray([0, 17], np.int32)
CLEN = np.asarray([9, 5], np.int32)
C = 16


def _case(cfg, seed=3):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim)
    k = rng.normal(0, 1, shape).astype(np.float32)
    v = rng.normal(0, 1, shape).astype(np.float32)
    blocks = iter(rng.permutation(GARBAGE))
    bt_dec = np.full((3, 4), GARBAGE, np.int32)
    for i, p in enumerate(POS):
        for j in range(-(-(p + 1) // BS)):
            bt_dec[i, j] = next(blocks)
    bt_ck = np.full((2, 4), GARBAGE, np.int32)
    for i in range(2):
        for j in range(-(-(CTX[i] + CLEN[i]) // BS)):
            bt_ck[i, j] = next(blocks)
    # positions that hold real K/V after the step (compared pool rows)
    real = np.zeros((NB, BS), bool)
    for i, p in enumerate(POS):
        for x in range(p + 1):
            real[bt_dec[i, x // BS], x % BS] = True
    for i in range(2):
        for x in range(CTX[i] + CLEN[i]):
            real[bt_ck[i, x // BS], x % BS] = True
    return k, v, bt_dec, bt_ck, real


def _close_pool(jpool, tpool, real):
    for a, b in ((jpool.k, tpool.k), (jpool.v, tpool.v)):
        a = np.asarray(a)
        b = b.numpy()
        np.testing.assert_allclose(b[..., real, :, :], a[..., real, :, :],
                                   atol=POOL_TOL, rtol=POOL_TOL)


# --------------------------------------------------------------------------
def test_config_copies_match_reference():
    for name in NAMES:
        for jc, tc in ((jax_get_config(name), get_config(name)),
                       (jax_get_config(name).reduced(),
                        get_config(name).reduced())):
            for f in dataclasses.fields(tc):
                # tp_plan, tp_rows, levers, seq_parallel, tp_data: the port's
                # per-leaf partition, its data ranks and its levers, no
                # reference fields
                if f.name not in ("dtype", "tp_plan", "tp_rows", "levers",
                                  "seq_parallel", "tp_data"):
                    assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    with pytest.raises(KeyError):
        get_config("gpt-2")
    for name in ("whisper-large-v3", "zamba2-2.7b"):
        # the hybrid and encoder-decoder families build, with no paged
        # entry points (as in the reference)
        other = build_model(get_config(name).reduced())
        assert not other.supports_paged and other.loss is not None
        assert (other.init_paged_cache, other.prefill_chunk,
                other.mixed_step, other.prefill_bucketed) == (None,) * 4
    # rwkv6 builds, on the slab only (its cache is a recurrent state)
    rwkv = build_model(get_config("rwkv6-7b").reduced())
    assert not rwkv.supports_paged and rwkv.prefill_bucketed is None
    for name in FAMILY_NAMES:           # the MoE and VLM decoders build
        assert build_model(get_config(name).reduced()).supports_paged
        # ... and with a window, on the slab only (a ring, no block table)
        win = build_model(get_config(name, sliding_window=64).reduced())
        assert not win.supports_paged
        assert (win.init_paged_cache, win.prefill_chunk, win.mixed_step,
                win.prefill_bucketed) == (None,) * 4


def test_bridge_round_trip(pair):
    jcfg, jparams, cfg, params = pair
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    k, v, *_ = _case(cfg)
    pool = bridge.pool_from_numpy((k, v), device="cpu")
    back = bridge.pool_to_numpy(pool)
    np.testing.assert_array_equal(back.k, k)
    np.testing.assert_array_equal(back.v, v)
    with pytest.raises(KeyError):
        bridge.params_from_numpy({"embed": np.zeros(1)}, cfg, device="cpu")


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_bridge_round_trip_moe_and_vlm(name):
    """The MoE (router, experts; arctic's ffn and ln_res) and VLM (QKV
    bias) parameter trees cross the bridge leaf for leaf; the f32 router
    stays f32 under a bf16 config; a tree missing a layer key is
    refused."""
    jcfg = jax_get_config(name).reduced()
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
        params = bridge.params_from_numpy(tree, cfg, device="cpu")
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            node = params
            for key in path:
                node = node[key.key]
            want = leaf if dtype == torch.float32 or path[-1].key == \
                "router" else np.asarray(torch.from_numpy(np.array(leaf))
                                         .to(dtype).float())
            np.testing.assert_array_equal(node.float().numpy(), want)
            assert node.dtype == (torch.float32 if path[-1].key == "router"
                                  else dtype)
    layers = set(tree["layers"])
    assert ("moe" in layers) == bool(cfg.num_experts)
    assert ("ln_res" in layers) == cfg.dense_residual
    assert "bq" in tree["layers"]["attn"] or not cfg.qkv_bias
    with pytest.raises(KeyError):
        bridge.params_from_numpy(
            dict(tree, layers={k: v for k, v in tree["layers"].items()
                               if k != "ln_mlp"}), cfg, device="cpu")


def test_rms_norm_rope_ffn(pair):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    w = rng.normal(1, 0.1, (cfg.d_model,)).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(t(x), t(w), cfg.norm_eps).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                    jcfg.norm_eps)), atol=1e-6, rtol=1e-6)
    qh = rng.normal(0, 1, (2, 5, cfg.num_heads, cfg.head_dim)) \
        .astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tattn.apply_rope(t(qh), t(pos), cfg.rope_theta).numpy(),
        np.asarray(jattn.apply_rope(jnp.asarray(qh), jnp.asarray(pos),
                                    jcfg.rope_theta)), atol=1e-5, rtol=1e-5)
    pj = jax.tree.map(lambda a: a[0], jparams["layers"]["ffn"])
    pt = layer_params(params["layers"], 0)["ffn"]
    np.testing.assert_allclose(
        ffn(pt, cfg, t(x)).numpy(),
        np.asarray(jmlp.ffn(pj, jcfg, jnp.asarray(x))), atol=1e-5, rtol=1e-5)


def test_attention_mixed_paged(pair):
    jcfg, jparams, cfg, params = pair
    k, v, bt_dec, bt_ck, real = _case(cfg)
    rng = np.random.default_rng(2)
    xd = rng.normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
    xc = rng.normal(0, 1, (2, C, cfg.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    jd, jc, jpool = jattn.attention_mixed_paged(
        pj, jcfg, jnp.asarray(xd), jnp.asarray(xc),
        jattn.KVCache(jnp.asarray(k[0]), jnp.asarray(v[0])),
        jnp.asarray(bt_dec), jnp.asarray(bt_ck), jnp.asarray(POS),
        jnp.asarray(CTX), jnp.asarray(CLEN), attn_backend="fused",
        attn_interpret=True)
    pool = bridge.pool_from_numpy((k[0], v[0]), device="cpu")
    td, tc, tpool = tattn.attention_mixed_paged(
        layer_params(params["layers"], 0)["attn"], cfg, t(xd), t(xc), pool,
        t(bt_dec), t(bt_ck), t(POS), t(CTX), t(CLEN))
    assert tpool is pool                     # written in place
    live = POS >= 0
    np.testing.assert_allclose(td.numpy()[live], np.asarray(jd)[live],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for i, n in enumerate(CLEN):
        np.testing.assert_allclose(tc.numpy()[i, :n], np.asarray(jc)[i, :n],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    _close_pool(jpool, tpool, real)


def test_forward_decode_paged(pair):
    jcfg, jparams, cfg, params = pair
    k, v, bt_dec, _, _ = _case(cfg)
    tok = np.asarray([7, 0, 300], np.int32)
    jlog, jpool = jtr.forward_decode_paged(
        jparams, jcfg, jnp.asarray(tok),
        jattn.KVCache(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(bt_dec),
        jnp.asarray(POS), attn_backend="fused", attn_interpret=True)
    model = build_model(cfg)
    tlog, tpool = model.decode_step_paged(
        params, bridge.pool_from_numpy((k, v), device="cpu"), t(tok),
        t(bt_dec), t(POS))
    live = POS >= 0
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    real = np.zeros((NB, BS), bool)
    for i, p in enumerate(POS):
        for x in range(p + 1):
            real[bt_dec[i, x // BS], x % BS] = True
    _close_pool(jpool, tpool, real)


def test_forward_mixed(pair):
    jcfg, jparams, cfg, params = pair
    k, v, bt_dec, bt_ck, real = _case(cfg)
    rng = np.random.default_rng(4)
    tok = np.asarray([7, 0, 300], np.int32)
    ck = np.zeros((2, C), np.int32)
    for i, n in enumerate(CLEN):
        ck[i, :n] = rng.integers(0, cfg.vocab_size, n)
    jd, jc, jpool = jtr.forward_mixed(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(ck),
        jattn.KVCache(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(bt_dec),
        jnp.asarray(bt_ck), jnp.asarray(POS), jnp.asarray(CTX),
        jnp.asarray(CLEN), attn_backend="fused", attn_interpret=True)
    model = build_model(cfg)
    td, tc, tpool = model.mixed_step(
        params, bridge.pool_from_numpy((k, v), device="cpu"), t(tok), t(ck),
        t(bt_dec), t(bt_ck), t(POS), t(CTX), t(CLEN))
    live = POS >= 0
    np.testing.assert_allclose(td.numpy()[live], np.asarray(jd)[live],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _close_pool(jpool, tpool, real)


def test_init_is_seeded_and_stacked():
    cfg = get_config("llama3.2-3b").reduced()
    a = build_model(cfg).init(5, device="cpu")
    b = build_model(cfg).init(5, device="cpu")
    assert a["layers"]["attn"]["wq"].shape == (
        cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["layers"]["ffn"]["w_down"],
                       b["layers"]["ffn"]["w_down"])
    win = build_model(dataclasses.replace(cfg, sliding_window=64))
    assert not win.supports_paged
    assert win.init_cache(2, 100, device="cpu").k.shape[2] == 64
    jcfg = jax_get_config("llama3.2-3b").reduced()
    pool = tattn.make_paged_pool(cfg, 5, BS, device="cpu")
    jpool = jattn.make_paged_pool(jcfg, 5, BS)
    assert pool.k.shape == jpool.k.shape and not pool.v.any()


def test_paged_gather(pair):
    jcfg, jparams, cfg, params = pair
    k, v, bt_dec, bt_ck, _ = _case(cfg)
    np.testing.assert_array_equal(
        tattn.paged_gather(t(k[0]), t(bt_dec)).numpy(),
        np.asarray(jattn.paged_gather(jnp.asarray(k[0]),
                                      jnp.asarray(bt_dec))))
