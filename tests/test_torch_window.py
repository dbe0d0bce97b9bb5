"""The port's sliding-window paths vs the JAX reference, f32 on the CPU,
on reduced smollm-360m and starcoder2-3b (G 2) given windows, with the
JAX weights bridged over: the reference's two window tests mirrored, the
whole-prompt attention below and above the window, the ring decode before
and after it wraps (and clamped where ``max_seq`` is below the window),
the ring relay, the windowed slab engine, and migration of a whole ring
between port engines and from the JAX engine. The launcher builds slab
engines for a windowed decoder and for rwkv6.

Tolerances as ``tests/test_torch_models.py``: 1e-5 on attention outputs
and cache rows, 1e-4 on logits; engines: identical streams."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import model as jmodel_mod  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.request import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import model as tmodel_mod  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest, State  # noqa: E402

ARCH = "starcoder2-3b"     # 4 / 2 heads reduced: G 2, gelu, RoPE 1e5
W = 16
LOGIT_TOL, OP_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, port params): reduced starcoder2
    with a window of ``W``, on the same weights."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               sliding_window=W)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(ARCH).reduced(), sliding_window=W)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return jcfg, jparams, cfg, params


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _layer0(pair):
    _, jparams, _, params = pair
    return (jax.tree.map(lambda a: a[0], jparams["layers"])["attn"],
            layer_params(params["layers"], 0)["attn"])


# --------------------------------------------------------------------------
# The reference's two window tests, on the port
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smollm():
    """Reduced smollm-360m and its JAX weights bridged over."""
    jbase = jax_get_config("smollm-360m").reduced()
    base = get_config("smollm-360m").reduced()
    jparams = jax_build_model(jbase).init(jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      base, device="cpu")
    return base, params


def test_window_wider_than_sequence_equals_full_attention(smollm):
    base, params = smollm
    m_full = build_model(base)
    m_win = build_model(dataclasses.replace(base, sliding_window=64))
    toks = t(tmodel_mod.synthetic_batch(base, 2, 10, device="cpu")["tokens"])
    _, c1 = m_full.prefill(params, toks, 32)
    _, c2 = m_win.prefill(params, toks, 32)
    pos = torch.full((2,), 10, dtype=torch.int32)
    l1, _ = m_full.decode_step(params, c1, toks[:, 0], pos)
    l2, _ = m_win.decode_step(params, c2, toks[:, 0], pos)
    torch.testing.assert_close(l1, l2, atol=5e-5, rtol=5e-4)


def test_window_of_4_forgets_distant_tokens(smollm):
    base, params = smollm
    win = dataclasses.replace(base, sliding_window=4)
    m = build_model(win)
    toks = tmodel_mod.synthetic_batch(win, 1, 12, device="cpu")["tokens"]
    t2 = toks.clone()
    t2[0, 0] = (t2[0, 0] + 1) % win.vocab_size
    _, c1 = m.prefill(params, toks, 16)
    _, c2 = m.prefill(params, t2, 16)
    assert c1.k.shape[2] == 4                     # the ring
    pos = torch.full((1,), 12, dtype=torch.int32)
    tok = torch.tensor([5], dtype=torch.int32)
    l1, _ = m.decode_step(params, c1, tok, pos)
    l2, _ = m.decode_step(params, c2, tok, pos)
    torch.testing.assert_close(l1, l2, atol=1e-5, rtol=1e-5)
    # ... and without the window the first token is remembered
    full = build_model(base)
    _, f1 = full.prefill(params, toks, 16)
    _, f2 = full.prefill(params, t2, 16)
    assert not torch.allclose(full.decode_step(params, f1, tok, pos)[0],
                              full.decode_step(params, f2, tok, pos)[0])


# --------------------------------------------------------------------------
# Attention, the ring, the relay
# --------------------------------------------------------------------------
@pytest.mark.parametrize("T", [7, W, 40, 1100],
                         ids=["below", "at", "above", "above-tiled"])
def test_attention_prefill_matches_reference(pair, T, monkeypatch):
    """Below or at the window: the contiguous prefill kernel's path (its
    plain version here); above: the banded path, whose query tiles (cut
    to 256 rows for the 1100-token case) cover the reference's masked
    SDPA and its flash scan (T^2 > 2048^2 is not reached here: the scan
    and the SDPA compute one function)."""
    jcfg, _, cfg, _ = pair
    jp, tp = _layer0(pair)
    monkeypatch.setattr(tattn, "WINDOW_TILE", 256)
    x = _rand(T, 1, T, cfg.d_model)
    pos = np.broadcast_to(np.arange(T), (1, T))
    out, (k, v) = tattn.attention_prefill(tp, cfg, t(x), t(pos))
    jout, (jk, jv) = jattn.attention_prefill(jp, jcfg, jnp.asarray(x),
                                             jnp.asarray(pos))
    _close(out, jout, OP_TOL)
    _close(k, jk, OP_TOL)
    _close(v, jv, OP_TOL)


def test_window_attention_tiles_agree():
    """The banded path gives one result whatever its query tile."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 50, 4, 8, generator=g)
    k, v = (torch.randn(2, 50, 2, 8, generator=g) for _ in range(2))
    ref = tattn.window_attention(q, k, v, 7, tile=50)
    for tile in (1, 8, 13):
        torch.testing.assert_close(tattn.window_attention(q, k, v, 7,
                                                          tile=tile),
                                   ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("S,pos", [
    (W, (3, 9)), (W, (16, 37)), (W, (15, 100)), (8, (5, 12))],
    ids=["before-wrap", "after-wrap", "at-and-far-past", "max-seq-below-W"])
@pytest.mark.parametrize("rows", [False, True], ids=["batch", "rows"])
def test_ring_decode_matches_reference(pair, S, pos, rows):
    """One token against a ring of S slots (S = W, or a slab of
    ``max_seq`` = 8 < W, where the write clamps to the last row as the
    reference's ``dynamic_update_slice`` does): the output and every ring
    row after the write. With ``rows`` the port decodes rows 3 and 0 of a
    4-row slab in place."""
    jcfg, _, cfg, _ = pair
    jp, tp = _layer0(pair)
    B = len(pos)
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    x = _rand(1, B, 1, cfg.d_model)
    k, v = _rand(2, B, S, Hkv, Dh), _rand(3, B, S, Hkv, Dh)
    p = np.asarray(pos, np.int32)
    jout, jc = jattn.attention_decode(jp, jcfg, jnp.asarray(x),
                                      jattn.KVCache(jnp.asarray(k),
                                                    jnp.asarray(v)),
                                      jnp.asarray(p))
    if rows:
        slab_rows = np.array([3, 0])
        kk, vv = np.zeros((4, S, Hkv, Dh), np.float32), np.zeros(
            (4, S, Hkv, Dh), np.float32)
        kk[slab_rows], vv[slab_rows] = k, v
        cache = KVCache(t(kk), t(vv))
        out, cache = tattn.attention_decode(tp, cfg, t(x), cache, t(p),
                                            rows=t(slab_rows.astype(
                                                np.int32)))
        got_k, got_v = cache.k[slab_rows], cache.v[slab_rows]
    else:
        cache = KVCache(t(k), t(v))
        out, cache = tattn.attention_decode(tp, cfg, t(x), cache, t(p))
        got_k, got_v = cache.k, cache.v
    _close(out, jout, OP_TOL)
    _close(got_k, jc.k, OP_TOL)
    _close(got_v, jc.v, OP_TOL)


@pytest.mark.parametrize("T,cache_len", [(40, 64), (12, 64), (40, 10),
                                         (16, 64)],
                         ids=["wraps", "short", "cache-below-W", "exact"])
def test_relay_kv_matches_reference(pair, T, cache_len):
    jcfg, _, cfg, _ = pair
    shape = (2, 1, T, cfg.num_kv_heads, cfg.head_dim)
    k, v = _rand(4, *shape), _rand(5, *shape)
    got = tmodel_mod._relay_kv(KVCache(t(k), t(v)), cfg, cache_len)
    want = jmodel_mod._relay_kv(jattn.KVCache(jnp.asarray(k),
                                              jnp.asarray(v)), jcfg,
                                cache_len)
    assert got.k.shape[2] == min(cache_len, W)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


def test_windowed_prefill_and_decode_match_reference(pair):
    """``Model.prefill`` into a ring of a 64-row slab (a 40-token prompt:
    the banded path and a wrapped relay), then 3 decode steps, against the
    JAX model."""
    jcfg, jparams, cfg, params = pair
    jm, m = jax_build_model(jcfg), build_model(cfg)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (2, 40)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache_len=64)
    tl, tc = m.prefill(params, t(toks), 64)
    _close(tl, jl, LOGIT_TOL)
    _close(tc.k, jc.k, OP_TOL)
    for i in range(3):
        tok = np.full(2, 11 + i, np.int32)
        p = np.full(2, 40 + i, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok),
                                jnp.asarray(p))
        tl, tc = m.decode_step(params, tc, t(tok), t(p))
        _close(tl, jl, LOGIT_TOL)
        _close(tc.v, jc.v, OP_TOL)


# --------------------------------------------------------------------------
# The windowed slab engine and migration
# --------------------------------------------------------------------------
PROMPTS = (5, 30, 12, 40)      # 30 and 40 exceed W: banded, wrapped
NEW = 12                       # 5 + 12 wraps the ring while decoding
KW = dict(max_slots=3, max_seq=64)


def _serve(eng, reqs, max_steps=200):
    for r in reqs:
        eng.submit(r)
    while not all(r.state.name == "FINISHED" for r in reqs):
        assert eng.steps < max_steps, "engine did not drain"
        eng.step()


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def test_windowed_slab_engine_matches_jax_engine(pair):
    jcfg, jparams, cfg, params = pair
    model = build_model(cfg)
    with pytest.raises(ValueError, match="paged"):
        Engine(0, model, params, paged=True, **KW)
    with pytest.raises(ValueError, match="paged"):
        Engine(0, model, params, chunked_prefill=True, **KW)
    prompts = _prompts(cfg, PROMPTS)
    jeng = jengine.Engine(0, jax_build_model(jcfg), jparams, **KW)
    jreqs = [JaxRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _serve(jeng, jreqs)
    eng = Engine(0, model, params, **KW)
    assert eng.cache.k.shape[2] == W
    reqs = [ServeRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _serve(eng, reqs)
    eng.check_drained()
    jeng.check_drained()
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.first_token_step, r.finish_step) for r in reqs] == \
        [(r.first_token_step, r.finish_step) for r in jreqs]
    for c in ("steps", "tokens_out", "peak_kv_bytes"):
        assert getattr(eng, c) == getattr(jeng, c), c


def _carry(req):
    out = ServeRequest(req.req_id, req.prompt.copy(), req.max_new_tokens)
    out.generated = list(req.generated)
    out.ctx_done = req.ctx_done
    out.first_token_step = req.first_token_step
    out.state = State.RUNNING
    return out


def _to_finish(eng, req, limit=200):
    while req.state.name != "FINISHED":
        assert eng.steps < limit
        eng.step()


@pytest.mark.parametrize("src", ["torch", "jax"])
def test_ring_migration_continues_the_stream(pair, src):
    """A request whose ring has wrapped, exported after 6 steps (the
    whole ring, untrimmed) and imported into a port engine — from another
    port engine, or from the JAX engine through numpy — decodes the stream
    of a twin that never moved."""
    jcfg, jparams, cfg, params = pair
    model = build_model(cfg)
    prompt = _prompts(cfg, (13,), seed=3)[0]
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
    for _ in range(6):
        sender.step()
        twin.step()
    assert r.length > W
    _, piece, nbytes = sender.export_slot(r.slot)
    assert piece.k.shape[2] == W
    if src == "torch":
        sender.evict_slot(r.slot)
    else:
        piece = bridge.pool_from_numpy(jax.tree.map(np.asarray, piece),
                                       device="cpu")
        r = _carry(r)
    dst = Engine(1, model, params, **KW)
    assert dst.import_request(r, piece)
    _to_finish(dst, r)
    _to_finish(twin, ref)
    assert r.generated == ref.generated
    dst.check_drained()


@pytest.mark.parametrize("argv", [
    ["--arch", "starcoder2-3b", "--sliding-window", "32"],
    ["--arch", "rwkv6-7b"]], ids=["window", "rwkv6"])
def test_launcher_builds_slab_engines(argv, capsys):
    """The launcher's factory gives a windowed decoder and rwkv6 slab
    engines, no paged-only argument reaching them (the host tier off),
    and serves a short trace."""
    args = serve.parse_args(["--device", "cpu", "--engines", "2", *argv])
    srv = serve.build_server(args)
    assert srv.cfg.host_kv_budget == 0
    for eng in srv.engines:
        assert not (eng.paged or eng.chunked_prefill or eng.prefix_cache
                    or eng.device_resident)
    if "--sliding-window" in argv:
        assert srv.engines[0].cache.k.shape[2] == 32
    serve.main(["--device", "cpu", "--engines", "2", "--requests", "4",
                *argv])
    assert "summary:" in capsys.readouterr().out
