"""The port's whisper encoder-decoder vs the JAX reference, f32 on the CPU,
on reduced whisper-large-v3 (2 + 2 layers, d_model 256, 4 heads of Dh 64,
16 encoder frames) with the JAX weights bridged over: ``layer_norm``,
the encoder, cross-attention (a prompt's queries in plain PyTorch, one
decode token through #5's plain path with every encoder key valid), the
whole forward (and ``last_only``), ``Model.prefill`` / ``decode_step``
against the reference's and against the whole forward,
``synthetic_batch``'s audio embeddings, and the bridge.

Tolerances: functions within ``OP_TOL`` = 1e-5 of the largest magnitude
of the reference's output (where that exceeds 1), logits within
``LOGIT_TOL`` = 1e-4 as in ``tests/test_torch_models.py``;
``synthetic_batch`` bit-equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import synthetic_batch as jax_synthetic_batch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import whisper as jw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model, synthetic_batch  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import whisper as tw  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

ARCH = "whisper-large-v3"
OP_TOL, LOGIT_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX model, JAX params, port cfg, port model, port params)
    on the same weights, LayerNorm weights and biases made non-trivial."""
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)

    def perturb(tree):
        return {k: (perturb(v) if isinstance(v, dict) else
                    jnp.asarray(np.asarray(v) + rng.normal(
                        0, 0.1, v.shape).astype(np.float32))
                    if k in ("w", "b") else v) for k, v in tree.items()}
    jparams = perturb(jparams)
    cfg = get_config(ARCH).reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg), params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The shapes here are small: one intra-op thread runs them as fast,
    and keeps them fast beside other test processes on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=OP_TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * scale)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _batch(cfg, jcfg, B, T, seed=0):
    return (synthetic_batch(cfg, B, T, np_seed=seed, device="cpu"),
            jax_synthetic_batch(jcfg, B, T, np_seed=seed))


# --------------------------------------------------------------------------
def test_layer_norm_and_xent_match_reference():
    x, w, b = _rand(1, 3, 5, 32), _rand(2, 32), _rand(3, 32)
    _close(tcommon.layer_norm(t(x), t(w), t(b)),
           jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b)))
    bf = tcommon.layer_norm(t(x).bfloat16(), t(w).bfloat16(),
                            t(b).bfloat16())
    assert bf.dtype == torch.bfloat16
    logits = _rand(4, 3, 5, 50)
    labels = np.random.default_rng(5).integers(0, 50, (3, 5))
    mask = np.random.default_rng(6).random((3, 5)) < 0.6
    for m in (None, mask, np.zeros((3, 5), bool)):
        _close(tcommon.softmax_xent(t(logits), t(labels),
                                    None if m is None else t(m)),
               jcommon.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m)))


def test_synthetic_batch_audio_matches_reference(pair):
    jcfg, _, _, cfg, _, _ = pair
    tb, jb = _batch(cfg, jcfg, 2, 7, seed=3)
    assert set(tb) == set(jb) == {"tokens", "audio_embeds"}
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert tuple(tb["audio_embeds"].shape) == (2, cfg.encoder_seq,
                                                cfg.d_model)


def test_encode_matches_reference(pair):
    jcfg, _, jparams, cfg, _, params = pair
    a = _rand(1, 2, cfg.encoder_seq, cfg.d_model)
    _close(tw.encode(params, cfg, t(a)),
           jw.encode(jparams, jcfg, jnp.asarray(a)))


@pytest.mark.parametrize("T", [1, 5])
def test_cross_attention_matches_reference(pair, T):
    """T = 1 is a decode step (#5's path, lengths = S_enc for every row),
    T = 5 a prompt's queries (plain SDPA); both against the reference's
    unmasked SDPA, on K/V from ``encode_cross_kv``."""
    jcfg, _, jparams, cfg, _, params = pair
    jl = jax.tree.map(lambda a: a[1], jparams["dec_layers"])
    tl = layer_params(params["dec_layers"], 1)
    enc = _rand(2, 2, cfg.encoder_seq, cfg.d_model)
    x = _rand(3, 2, T, cfg.d_model)
    kv = tattn.encode_cross_kv(tl["cross_attn"], cfg, t(enc))
    jkv = jattn.encode_cross_kv(jl["cross_attn"], jcfg, jnp.asarray(enc))
    _close(kv.k, jkv.k)
    _close(kv.v, jkv.v)
    _close(tattn.cross_attention(tl["cross_attn"], cfg, t(x), kv),
           jattn.cross_attention(jl["cross_attn"], jcfg, jnp.asarray(x),
                                 jkv))


def test_cross_decode_runs_the_padded_decode_over_every_key(pair,
                                                            monkeypatch):
    """A decode step's cross-attention calls #5 once per layer, padded,
    with ``lengths`` = S_enc on every row; a prompt's never calls it."""
    _, _, _, cfg, _, params = pair
    calls = []
    real = tattn.decode_attention

    def spy(q, k, v, lengths, **kw):
        calls.append((tuple(k.shape), lengths.tolist(), kw["ragged"]))
        return real(q, k, v, lengths, **kw)
    monkeypatch.setattr(tattn, "decode_attention", spy)
    tl = layer_params(params["dec_layers"], 0)
    kv = KVCache(t(_rand(1, 2, cfg.encoder_seq, 2, 64)),
                 t(_rand(2, 2, cfg.encoder_seq, 2, 64)))
    tattn.cross_attention(tl["cross_attn"], cfg, t(_rand(3, 2, 4, 256)), kv)
    assert calls == []
    tattn.cross_attention(tl["cross_attn"], cfg, t(_rand(3, 2, 1, 256)), kv)
    assert calls == [((2, cfg.encoder_seq, 2, 64), [cfg.encoder_seq] * 2,
                      False)]


def test_forward_full_matches_reference(pair):
    jcfg, _, jparams, cfg, _, params = pair
    tb, jb = _batch(cfg, jcfg, 2, 9)
    logits, cache, aux = tw.forward_full(params, cfg, tb["tokens"],
                                         tb["audio_embeds"],
                                         return_cache=True)
    jlog, jcache, _ = jw.forward_full(jparams, jcfg, jb["tokens"],
                                      jb["audio_embeds"], return_cache=True)
    _close(logits, jlog, LOGIT_TOL)
    for a, b in ((cache.self_kv, jcache.self_kv),
                 (cache.cross_kv, jcache.cross_kv)):
        _close(a.k, b.k)
        _close(a.v, b.v)
    assert float(aux) == 0.0
    last, none, _ = tw.forward_full(params, cfg, tb["tokens"],
                                    tb["audio_embeds"], last_only=True,
                                    remat=True)
    assert none is None     # one row's unembedding: another matmul shape
    torch.testing.assert_close(last[:, 0], logits[:, -1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="position table"):
        tw.forward_full(params, cfg, torch.zeros(
            (1, cfg.max_position + 1), dtype=torch.int32),
            tb["audio_embeds"][:1])


@pytest.mark.parametrize("cache_len", [None, 16])
def test_prefill_and_decode_match_reference(pair, cache_len):
    """``Model.prefill`` (self-KV relayed into ``cache_len`` rows, the
    cross-KV fixed) and three decode steps against the reference's
    model-level calls, logits and caches."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    B, T = 2, 6
    tb, jb = _batch(cfg, jcfg, B, T + 3)
    logits, cache = model.prefill(params, tb["tokens"][:, :T], cache_len,
                                  audio_embeds=tb["audio_embeds"])
    jlog, jcache = jmodel.prefill(
        jparams, {"tokens": jb["tokens"][:, :T],
                  "audio_embeds": jb["audio_embeds"]}, cache_len)
    _close(logits, jlog, LOGIT_TOL)

    def same_cache():
        for a, b in ((cache.self_kv, jcache.self_kv),
                     (cache.cross_kv, jcache.cross_kv)):
            _close(a.k, b.k)
            _close(a.v, b.v)
    same_cache()
    if cache_len is None:
        return                  # a buffer of T rows holds no decode token
    for i in range(3):
        pos = np.full((B,), T + i, np.int32)
        logits, cache = model.decode_step(params, cache,
                                          tb["tokens"][:, T + i], t(pos))
        jlog, jcache = jmodel.decode_step(jparams, jcache,
                                          jb["tokens"][:, T + i],
                                          jnp.asarray(pos))
        _close(logits, jlog, LOGIT_TOL)
        same_cache()


def test_decode_matches_full_forward(pair):
    """``tests/test_models_consistency.py``'s check on the port."""
    _, _, _, cfg, model, params = pair
    B, T = 2, 12
    full = synthetic_batch(cfg, B, T + 1, device="cpu")
    _, cache = model.prefill(params, full["tokens"][:, :T], T + 4,
                             audio_embeds=full["audio_embeds"])
    pos = torch.full((B,), T, dtype=torch.int32)
    dec, _ = model.decode_step(params, cache, full["tokens"][:, T], pos)
    ref, _, _ = tw.forward_full(params, cfg, full["tokens"],
                                full["audio_embeds"])
    np.testing.assert_allclose(dec.numpy(), ref[:, -1].numpy(), atol=5e-5,
                               rtol=5e-4)


def test_init_cache_and_init_match_reference_shapes(pair):
    jcfg, _, jparams, cfg, model, _ = pair
    got = model.init_cache(3, 20, device="cpu")
    want = jw.init_cache(jcfg, 3, 20)
    for a, b in ((got.self_kv, want.self_kv), (got.cross_kv, want.cross_kv)):
        assert tuple(a.k.shape) == b.k.shape
    mine = model.init(1, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path


def test_bridge_layout_and_errors(pair):
    _, _, jparams, cfg, _, params = pair
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    np_tree = jax.tree.map(np.asarray, jparams)
    bad = dict(np_tree, dec_layers={k: v for k, v in
                                    np_tree["dec_layers"].items()
                                    if k != "cross_attn"})
    with pytest.raises(KeyError):
        bridge.params_from_numpy(bad, cfg, device="cpu")
    bad = dict(np_tree, enc_ln={"w": np_tree["enc_ln"]["w"]})
    with pytest.raises(KeyError):
        bridge.params_from_numpy(bad, cfg, device="cpu")
    bad = dict(np_tree, enc_layers=jax.tree.map(lambda a: a[:1],
                                                np_tree["enc_layers"]))
    with pytest.raises(ValueError):
        bridge.params_from_numpy(bad, cfg, device="cpu")
