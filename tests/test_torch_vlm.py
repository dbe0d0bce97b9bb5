"""The port's VLM backbone (reduced qwen2-vl-7b: QKV bias, M-RoPE) vs the
JAX reference, f32 on the CPU, with the JAX weights bridged over:
``apply_mrope`` on distinct t/h/w streams, the vision merge, the whole
forward with vision extras, prefill + slab decode against the whole
forward, the paged decode and chunk passes with M-RoPE ids, the engine on
``flat`` and ``dense`` against the JAX engine, and ``fused`` refusing the
config in both packages. Tolerances: 1e-5 per op, 1e-4 on logits (as
``tests/test_torch_models.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.engine as jax_engine_mod  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import synthetic_batch as jax_synthetic_batch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving.request import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, synthetic_batch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import mrope_grid_positions  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest  # noqa: E402

NAME = "qwen2-vl-7b"
OP_TOL, LOGIT_TOL = 1e-5, 1e-4
BS, NB = 16, 12


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config(NAME).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(NAME).reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg), params


def t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _batches(cfg, jcfg, B, T, seed=0):
    """The port's and the reference's synthetic batch from one numpy seed
    (the same numbers), the port's as CPU tensors."""
    tb = synthetic_batch(cfg, B, T, np_seed=seed, device="cpu")
    jb = jax_synthetic_batch(jcfg, B, T, np_seed=seed)
    return tb, jb


def _streams3(B, T, seed):
    """Distinct temporal / height / width ids per position."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3000, (B, T, 3)).astype(np.int32)


N_PATCH = 12        # a prompt opening with a 4 x 3 patch grid


def _grid_ids(positions):
    """The M-RoPE ids of ``positions`` [B, T] in a prompt that opens with
    ``N_PATCH`` patches (``synthetic_batch``'s layout): patches (0, h, w),
    distinct streams; text after them t = h = w = position - 11."""
    grid = mrope_grid_positions(1, int(positions.max()) + 1, N_PATCH)[0]
    return grid[np.maximum(positions, 0)].astype(np.int32)


# --------------------------------------------------------------------------
# M-RoPE and the vision merge
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dh", [64, 128, 80])
def test_apply_mrope_matches_reference(dh):
    """(2, 3, 3) sections over Dh/2 slots, the last absorbing the
    rounding (Dh 80: 40 slots -> 10, 15, 15)."""
    rng = np.random.default_rng(dh)
    x = rng.normal(0, 1, (2, 5, 3, dh)).astype(np.float32)
    p3 = _streams3(2, 5, dh)
    assert len({tuple(r) for r in p3.reshape(-1, 3)}) > 1
    assert (p3[..., 0] != p3[..., 1]).any()
    want = jattn.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6)
    _close(tattn.apply_mrope(t(x), t(p3), 1e6).numpy(), want, OP_TOL)
    # identical streams are plain RoPE
    same = np.repeat(p3[..., :1], 3, axis=-1)
    _close(tattn.apply_mrope(t(x), t(same), 1e6).numpy(),
           tattn.apply_rope(t(x), t(same[..., 0]), 1e6).numpy(), OP_TOL)


def test_vision_merge_matches_reference(pair):
    jcfg, _, jparams, cfg, _, params = pair
    tb, jb = _batches(cfg, jcfg, 2, 16)
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    np.testing.assert_array_equal(tb["mrope_positions"].numpy(),
                                  np.asarray(jb["mrope_positions"]))
    got = ttr.embed_tokens(params, cfg, tb["tokens"], tb["vision_embeds"],
                           tb["vision_mask"])
    want = jtr.embed_tokens(jparams, jcfg, jb["tokens"], jb["vision_embeds"],
                            jb["vision_mask"])
    _close(got.numpy(), want, OP_TOL)
    n_patch = tb["vision_embeds"].shape[1]
    assert torch.equal(got[:, :n_patch], tb["vision_embeds"])
    assert torch.equal(got[:, n_patch:],
                       ttr.embed_tokens(params, cfg, tb["tokens"])[:,
                                                                   n_patch:])


@pytest.mark.parametrize("extras", ["vision", "text"])
def test_forward_full_matches_reference(pair, extras):
    """With the vision extras, and without (M-RoPE ids default to the text
    positions on all three streams)."""
    jcfg, _, jparams, cfg, _, params = pair
    tb, jb = _batches(cfg, jcfg, 2, 16, seed=1)
    if extras == "text":
        tb, jb = {"tokens": tb["tokens"]}, {"tokens": jb["tokens"]}
    jlog, jcache, _ = jtr.forward_full(
        jparams, jcfg, jb["tokens"], vision_embeds=jb.get("vision_embeds"),
        vision_mask=jb.get("vision_mask"),
        mrope_positions=jb.get("mrope_positions"), return_cache=True)
    tlog, tcache, _ = ttr.forward_full(
        params, cfg, tb.pop("tokens"), return_cache=True, **tb)
    _close(tlog.numpy(), jlog, LOGIT_TOL)
    _close(tcache.k.numpy(), jcache.k, OP_TOL)
    _close(tcache.v.numpy(), jcache.v, OP_TOL)


def test_prefill_and_slab_decode_match_full_forward(pair):
    """``tests/test_models_consistency.py``'s check on the port: prefill T
    tokens with the vision extras into a slab of T + 4 rows, decode token
    T at its M-RoPE ids, against the whole forward's last logits (and the
    reference's)."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    B, T = 2, 12
    full, jfull = _batches(cfg, jcfg, B, T + 1)
    pre = {k: (v[:, :T] if k in ("tokens", "vision_mask", "mrope_positions")
               else v) for k, v in full.items()}
    _, cache = model.prefill(params, pre.pop("tokens"), T + 4, **pre)
    pos = torch.full((B,), T, dtype=torch.int32)
    dec, _ = model.decode_step(
        params, cache, full["tokens"][:, T], pos,
        mrope_positions=full["mrope_positions"][:, T:T + 1])
    ref, _, _ = ttr.forward_full(params, cfg, full.pop("tokens"), **full)
    _close(dec.numpy(), ref[:, -1].numpy(), LOGIT_TOL)
    jref, _, _ = jtr.forward_full(
        jparams, jcfg, jfull["tokens"], vision_embeds=jfull["vision_embeds"],
        vision_mask=jfull["vision_mask"],
        mrope_positions=jfull["mrope_positions"])
    _close(dec.numpy(), np.asarray(jref)[:, -1], LOGIT_TOL)


def test_prefill_bucketed_with_extras(pair):
    """The whole-prompt bucket: logits at the true last token and the
    prompt's K/V rows equal an unpadded prefill's."""
    jcfg, _, _, cfg, model, params = pair
    tb, _ = _batches(cfg, jcfg, 1, 16, seed=2)
    T = 11
    short = {k: (v[:, :T] if k in ("tokens", "vision_mask", "mrope_positions")
                 else v) for k, v in tb.items()}
    want, cache = model.prefill(params, short.pop("tokens"), **short)
    got, piece = model.prefill_bucketed(params, tb.pop("tokens"),
                                        torch.tensor(T), **tb)
    _close(got.numpy(), want.numpy(), OP_TOL)
    _close(piece.k[:, :, :T].numpy(), cache.k.numpy(), OP_TOL)


# --------------------------------------------------------------------------
# The paged passes with M-RoPE ids
# --------------------------------------------------------------------------
def _pool(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim)
    return (rng.normal(0, 1, shape).astype(np.float32),
            rng.normal(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("backend", ["dense", "flat", "grid", "fused"])
def test_forward_decode_paged_with_mrope(pair, backend):
    jcfg, _, jparams, cfg, model, params = pair
    k, v = _pool(cfg, 3)
    pos = np.asarray([20, -1, 5], np.int32)   # text; dead; a patch
    bt = np.asarray([[0, 1, 2], [NB - 1] * 3, [3, 4, 5]], np.int32)
    tok = np.asarray([7, 0, 300], np.int32)
    mp = _grid_ids(pos[:, None])
    assert len(set(mp[2, 0])) == 3 and mp[0, 0, 0] != pos[0]
    jlog, jpool = jtr.forward_decode_paged(
        jparams, jcfg, jnp.asarray(tok),
        jattn.KVCache(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(bt),
        jnp.asarray(pos), mrope_positions=jnp.asarray(mp),
        attn_backend="dense")
    tlog, tpool = model.decode_step_paged(
        params, bridge.pool_from_numpy((k, v), device="cpu"), t(tok), t(bt),
        t(pos), attn_backend=backend, mrope_positions=t(mp))
    live = pos >= 0
    _close(tlog.numpy()[live], np.asarray(jlog)[live], LOGIT_TOL)
    for i in np.flatnonzero(live):         # the new token's K/V rows
        blk, off = bt[i, pos[i] // BS], pos[i] % BS
        _close(tpool.k[:, blk, off].numpy(), np.asarray(jpool.k)[:, blk, off],
               OP_TOL)


@pytest.mark.parametrize("backend", ["dense", "flat", "fused"])
def test_forward_prefill_chunk_with_mrope(pair, backend):
    jcfg, _, jparams, cfg, model, params = pair
    k, v = _pool(cfg, 5)
    ctx, clen = np.asarray([0, 17], np.int32), np.asarray([9, 5], np.int32)
    # tables cover ctx + C, the padding tail on the garbage block
    bt = np.asarray([[0, NB - 1, NB - 1], [2, 3, NB - 1]], np.int32)
    C = 16
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab_size, (2, C)).astype(np.int32)
    mp = _grid_ids(ctx[:, None] + np.arange(C)[None])   # patches, then text
    jlog, jpool = jtr.forward_prefill_chunk(
        jparams, jcfg, jnp.asarray(tok),
        jattn.KVCache(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(bt),
        jnp.asarray(ctx), jnp.asarray(clen), mrope_positions=jnp.asarray(mp),
        attn_backend="dense")
    tlog, tpool = model.prefill_chunk(
        params, bridge.pool_from_numpy((k, v), device="cpu"), t(tok), t(bt),
        t(ctx), t(clen), attn_backend=backend, mrope_positions=t(mp))
    _close(tlog.numpy(), jlog, LOGIT_TOL)
    for i in range(2):
        for x in range(ctx[i], ctx[i] + clen[i]):
            blk, off = bt[i, x // BS], x % BS
            _close(tpool.k[:, blk, off].numpy(),
                   np.asarray(jpool.k)[:, blk, off], OP_TOL)


def test_mixed_step_refuses_mrope(pair):
    jcfg, _, _, cfg, model, params = pair
    k, v = _pool(cfg, 8)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(AssertionError, match="RoPE / learned-pos only"):
        model.mixed_step(params, bridge.pool_from_numpy((k, v), device="cpu"),
                         one, torch.ones((1, 4), dtype=torch.int32),
                         torch.zeros((1, 1), dtype=torch.int32),
                         torch.zeros((1, 1), dtype=torch.int32), one,
                         0 * one, one)


# --------------------------------------------------------------------------
# Engines
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


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in PROMPTS]


@pytest.mark.parametrize("backend", ["flat", "dense"])
def test_engine_streams_match_jax_engine(pair, backend):
    """Text requests (M-RoPE ids default to the text positions): the
    reference's engine (flat: Pallas in interpret mode) against the
    port's on the same backend, two forwards a step (chunks, then
    decodes)."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    prompts = _prompts(cfg)
    jeng = jax_engine_mod.Engine(0, jmodel, jparams, max_slots=3,
                                 max_seq=64, attn_backend=backend,
                                 prefill_token_budget=8)
    jreqs = [JaxRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _drain(jeng, jreqs)
    eng = Engine(0, model, params, max_slots=3, max_seq=64,
                 prefill_token_budget=8, attn_backend=backend)
    assert not eng.fused_mixed and not jeng.fused_mixed
    reqs = [ServeRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _drain(eng, reqs)
    eng.check_drained()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [r.first_token_step for r in reqs] == \
        [r.first_token_step for r in jreqs]
    assert eng.steps == jeng.steps


def test_fused_engine_refuses_the_vlm_in_both_packages(pair):
    """The reference fails at its first mixed step, the port at
    construction, with the same message; neither falls back."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    prompt = _prompts(cfg)[0]
    jeng = jax_engine_mod.Engine(0, jmodel, jparams, max_slots=2,
                                 max_seq=64, attn_backend="fused",
                                 prefill_token_budget=8)
    jeng.submit(JaxRequest(0, prompt.copy(), 2))
    with pytest.raises(AssertionError, match="RoPE / learned-pos only"):
        jeng.step()
    with pytest.raises(ValueError, match="RoPE / learned-pos only"):
        Engine(0, model, params, max_slots=2, max_seq=64,
               attn_backend="fused")
    # a fused engine that never runs a mixed step (whole-prompt prefill)
    # serves it, as the reference's does
    eng = Engine(0, model, params, max_slots=2, max_seq=64,
                 attn_backend="fused", chunked_prefill=False)
    req = ServeRequest(0, prompt.copy(), 3)
    _drain(eng, [req])
    eng.check_drained()
    assert len(req.generated) == 3


def test_engine_refuses_other_families(pair):
    """The hybrid and encoder-decoder families, which the reference's
    engine refuses too (rwkv6's ``ssm`` is served: tests/test_torch_rwkv.py)."""
    *_, model, params = pair
    import dataclasses
    for family in ("hybrid", "encdec"):
        other = dataclasses.replace(model, cfg=dataclasses.replace(
            model.cfg, family=family))
        with pytest.raises(ValueError, match="decoder-only families"):
            Engine(0, other, params, max_slots=2, max_seq=64)
