"""The port's zamba2 hybrid (Mamba2 blocks + one shared attention block)
vs the JAX reference, f32 on the CPU, on reduced zamba2-2.7b with
``num_layers=4`` (two groups of two blocks: two shared-block sites; d_model
256, 16 SSM heads of P 32, N 16; the shared block 4 / 2 heads of Dh 64)
with the JAX weights bridged over: every function of ``models/mamba2.py``,
the whole forward, prefill and decode, prefill + decode against the whole
forward, the chunked SSD against the sequential one in f64, the bridge,
and the head-dim route (Dh 80, zamba2's own, which no kernel takes).

Tolerances: functions within ``OP_TOL`` = 1e-5 of the largest magnitude
of the reference's output (where that exceeds 1), logits within
``LOGIT_TOL`` = 1e-4 as in ``tests/test_torch_models.py``; the chunked SSD
within ``SSD_RTOL`` = 1e-10 of the sequential one's largest magnitude in
f64 (1e-5 in f32)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.models.attention import KVCache as JaxKV  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402

ARCH = "zamba2-2.7b"
OP_TOL, LOGIT_TOL, SSD_RTOL = 1e-5, 1e-4, 1e-10


def _pair(**over):
    jcfg = jax_get_config(ARCH).reduced(num_layers=4, **over)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced(num_layers=4, **over)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port cfg, port params) on the same weights;
    A_log and dt_bias spread so every head decays at its own rate."""
    jcfg, jparams, cfg, params = _pair()
    H = tm.dims(cfg)[1]
    rng = np.random.default_rng(5)
    for name, lo, hi in (("A_log", -1.0, 1.0), ("dt_bias", -2.0, 1.0)):
        a = rng.uniform(lo, hi, jparams["mamba"][name].shape).astype(
            np.float32)
        jparams["mamba"][name] = jnp.asarray(a)
        params["mamba"][name] = torch.from_numpy(a)
    assert H == 16
    return jcfg, jparams, cfg, params


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


def _block(pair, g=1, a=0):
    jcfg, jparams, cfg, params = pair
    return (jax.tree.map(lambda x: x[g, a], jparams["mamba"]),
            tm.block_params(params["mamba"], g, a))


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _ssd_operands(cfg, B, T, seed):
    d_inner, H, P, N = tm.dims(cfg)
    return (_rand(seed, B, T, d_inner), _rand(seed + 1, B, T, N),
            _rand(seed + 2, B, T, N), _rand(seed + 3, B, T, H))


# --------------------------------------------------------------------------
# Functions
# --------------------------------------------------------------------------
FUNCTIONS = ("dims", "_split_proj", "_conv_seq", "_ssd_scan",
             "_ssd_chunked", "_ssd_scan_state", "mamba_seq",
             "mamba_seq_state", "_gated_out", "mamba_step", "_shared_full",
             "_shared_decode")


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_function_matches_reference(pair, fn):
    jcfg, jparams, cfg, params = pair
    jl, tl = _block(pair)
    d_inner, H, P, N = tm.dims(cfg)
    B, T, D = 2, 12, cfg.d_model
    x = _rand(1, B, T, D)
    if fn == "dims":
        assert tm.dims(cfg) == jm.dims(jcfg)
        assert (tm.CONV_K, tm.EXPAND) == (jm.CONV_K, jm.EXPAND)
    elif fn == "_split_proj":
        z = _rand(2, B, T, 2 * d_inner + 2 * N + H)
        for a, b in zip(tm._split_proj(cfg, t(z)),
                        jm._split_proj(jcfg, jnp.asarray(z))):
            _close(a, b, 0)
    elif fn == "_conv_seq":
        xbc = _rand(2, B, T, d_inner + 2 * N)
        _close(tm._conv_seq(tl, t(xbc)), jm._conv_seq(jl, jnp.asarray(xbc)))
    elif fn in ("_ssd_scan", "_ssd_chunked", "_ssd_scan_state"):
        ops = _ssd_operands(cfg, B, T, 3)
        S0 = _rand(9, B, H, P, N) if fn == "_ssd_scan_state" else None
        jy, jS = jm._ssd_scan(jl, jcfg, *map(jnp.asarray, ops),
                              None if S0 is None else jnp.asarray(S0))
        if fn == "_ssd_chunked":        # the reference's: T % chunk == 0
            y, S = tm._ssd_chunked(tl, cfg, *map(t, ops), chunk=4)
            jy2, jS2 = jm._ssd_chunked(jl, jcfg, *map(jnp.asarray, ops),
                                       chunk=4)
            _close(y, jy2)
            _close(S, jS2)
        else:
            y, S = tm._ssd_scan(tl, cfg, *map(t, ops),
                                None if S0 is None else t(S0))
        _close(y, jy)
        _close(S, jS)
    elif fn == "mamba_seq":
        _close(tm.mamba_seq(tl, cfg, t(x)),
               jm.mamba_seq(jl, jcfg, jnp.asarray(x)))
    elif fn == "mamba_seq_state":
        got = tm.mamba_seq(tl, cfg, t(x), return_state=True)
        want = jm.mamba_seq(jl, jcfg, jnp.asarray(x), return_state=True)
        for a, b in zip(got, want):
            _close(a, b)
        # T shorter than the conv's window: zero rows before the start
        got = tm.mamba_seq(tl, cfg, t(x[:, :2]), return_state=True)
        want = jm.mamba_seq(jl, jcfg, jnp.asarray(x[:, :2]),
                            return_state=True)
        for a, b in zip(got, want):
            _close(a, b)
    elif fn == "_gated_out":
        y, z = _rand(2, B, T, d_inner), _rand(3, B, T, d_inner)
        _close(tm._gated_out(tl, cfg, t(y), t(z)),
               jm._gated_out(jl, jcfg, jnp.asarray(y), jnp.asarray(z)))
    elif fn == "mamba_step":
        conv, S = _rand(2, B, tm.CONV_K - 1, d_inner + 2 * N), \
            _rand(3, B, H, P, N)
        got = tm.mamba_step(tl, cfg, t(x[:, 0]), t(conv), t(S))
        want = jm.mamba_step(jl, jcfg, jnp.asarray(x[:, 0]),
                             jnp.asarray(conv), jnp.asarray(S))
        for a, b in zip(got, want):
            _close(a, b)
    elif fn == "_shared_full":
        pos = np.broadcast_to(np.arange(T)[None], (B, T))
        got, kv = tm._shared_full(params["shared"], cfg, t(x), t(pos))
        want, jkv = jm._shared_full(jparams["shared"], jcfg, jnp.asarray(x),
                                    jnp.asarray(pos))
        _close(got, want)
        _close(kv.k, jkv.k)
        _close(kv.v, jkv.v)
    else:                               # _shared_decode on one site's KV
        S = 16
        k, v = (_rand(s, B, S, cfg.num_kv_heads, cfg.head_dim)
                for s in (4, 5))
        pos = np.array([3, 11], np.int32)
        site = KVCache(t(k), t(v))
        got, site = tm._shared_decode(params["shared"], cfg, t(x[:, :1]),
                                      site, t(pos))
        want, jsite = jm._shared_decode(jparams["shared"], jcfg,
                                        jnp.asarray(x[:, :1]),
                                        JaxKV(jnp.asarray(k), jnp.asarray(v)),
                                        jnp.asarray(pos))
        _close(got, want)
        _close(site.k, jsite.k)
        _close(site.v, jsite.v)


def test_init_is_seeded_stacked_and_shaped_as_reference(pair):
    jcfg, jparams, cfg, _ = pair
    a = build_model(cfg).init(3, device="cpu")
    b = build_model(cfg).init(3, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        na, nb = a, b
        for key in path:
            na, nb = na[key.key], nb[key.key]
        assert tuple(na.shape) == tuple(leaf.shape), path
        assert str(na.dtype).split(".")[-1] == str(leaf.dtype), path
        torch.testing.assert_close(na, nb, rtol=0, atol=0)
    assert a["mamba"]["w_in"].shape[:2] == (2, 2)


# --------------------------------------------------------------------------
# The stack
# --------------------------------------------------------------------------
def test_forward_full_matches_reference(pair):
    jcfg, jparams, cfg, params = pair
    tok = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 13)) \
        .astype(np.int32)
    logits, kv, aux = tm.forward_full(params, cfg, t(tok), return_cache=True)
    jlog, jkv, _ = jm.forward_full(jparams, jcfg, jnp.asarray(tok),
                                   return_cache=True)
    _close(logits, jlog, LOGIT_TOL)
    _close(kv.k, jkv.k)
    _close(kv.v, jkv.v)
    assert float(aux) == 0.0
    again, none, _ = tm.forward_full(params, cfg, t(tok), remat=True)
    assert none is None
    torch.testing.assert_close(again, logits, rtol=0, atol=0)


@pytest.mark.parametrize("cache_len", [None, 20, 9])
def test_prefill_and_decode_match_reference(pair, cache_len):
    """Prefill (into a buffer longer than the prompt, as long, and
    shorter: the reference keeps the last rows at ``p % W``), then three
    decode steps, each against the reference's logits and state."""
    jcfg, jparams, cfg, params = pair
    B, T = 2, 12
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, T + 3)) \
        .astype(np.int32)
    logits, state = tm.prefill(params, cfg, t(tok[:, :T]), cache_len)
    jlog, jstate = jm.prefill(jparams, jcfg, jnp.asarray(tok[:, :T]),
                              cache_len)
    _close(logits, jlog, LOGIT_TOL)

    def same_state():
        _close(state["conv"], jstate["conv"])
        _close(state["ssm"], jstate["ssm"])
        _close(state["kv"].k, jstate["kv"].k)
        _close(state["kv"].v, jstate["kv"].v)
    same_state()
    if cache_len is not None and cache_len < T:
        return                          # a short buffer is not decoded on
    for i in range(3):
        pos = np.full((B,), T + i, np.int32)
        logits, state = tm.forward_decode(params, cfg, t(tok[:, T + i]),
                                          state, t(pos))
        jlog, jstate = jm.forward_decode(jparams, jcfg,
                                         jnp.asarray(tok[:, T + i]), jstate,
                                         jnp.asarray(pos))
        _close(logits, jlog, LOGIT_TOL)
        same_state()


def test_decode_matches_full_forward(pair):
    """``tests/test_models_consistency.py``'s check on the port: prefill T
    tokens of ``synthetic_batch`` into a cache of T + 4, decode token T,
    against the whole forward's last logits."""
    from repro_torch.models import synthetic_batch
    _, _, cfg, params = pair
    model = build_model(cfg)
    B, T = 2, 12
    full = synthetic_batch(cfg, B, T + 1, device="cpu")["tokens"]
    _, cache = model.prefill(params, full[:, :T], cache_len=T + 4)
    pos = torch.full((B,), T, dtype=torch.int32)
    dec, _ = model.decode_step(params, cache, full[:, T], pos)
    ref, _, _ = tm.forward_full(params, cfg, full)
    np.testing.assert_allclose(dec.numpy(), ref[:, -1].numpy(), atol=5e-5,
                               rtol=5e-4)


def test_state_shapes_match_reference(pair):
    jcfg, _, cfg, _ = pair
    got = build_model(cfg).init_cache(3, 40, device="cpu")
    want = jm.init_state(jcfg, 3, 40)
    for name in ("conv", "ssm"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
    assert tuple(got["kv"].k.shape) == want["kv"].k.shape


# --------------------------------------------------------------------------
# The chunked SSD
# --------------------------------------------------------------------------
@pytest.mark.parametrize("T,chunk", [(32, 8), (29, 8), (5, 8), (130, 64)])
def test_chunked_ssd_matches_sequential_f64(pair, T, chunk):
    """T a multiple of the chunk and not one (the last chunk shorter, no
    padding), from a zero and a random start state, in f64 at
    ``SSD_RTOL`` and in f32 at 1e-5."""
    _, _, cfg, params = pair
    tl = tm.block_params(params["mamba"], 0, 1)
    x, Bm, Cm, dt = (torch.from_numpy(a) for a in _ssd_operands(cfg, 2, T,
                                                                  11))
    xh, dtf, la = tm.ssd_inputs(tl, cfg, x, dt)
    d_inner, H, P, N = tm.dims(cfg)
    for S0 in (torch.zeros(2, H, P, N), torch.from_numpy(
            _rand(12, 2, H, P, N))):
        for dtype, tol in ((torch.float64, SSD_RTOL), (torch.float32, 1e-5)):
            ops = [a.to(dtype) for a in (xh, Bm, Cm, dtf, la, S0)]
            y1, S1 = tm.ssd_sequential(*ops)
            y2, S2 = tm.ssd_chunked(*ops, chunk=chunk)
            for a, b in ((y2, y1), (S2, S1)):
                assert a.dtype == dtype
                err = float((a - b).abs().max() / b.abs().max())
                assert err <= tol, (T, chunk, dtype, err)


def test_chunked_ssd_gradients_are_finite_and_match(pair):
    """Backward through the chunked SSD: finite (the masked exponent is
    -inf before exp, not inf after it) and equal to the sequential one's
    in f64."""
    _, _, cfg, params = pair
    tl = tm.block_params(params["mamba"], 0, 0)
    x, Bm, Cm, dt = (torch.from_numpy(a).double() for a in
                     _ssd_operands(cfg, 2, 21, 13))
    xh, dtf, la = tm.ssd_inputs(tl, cfg, x.float(), dt.float())
    d_inner, H, P, N = tm.dims(cfg)
    S0 = torch.zeros(2, H, P, N, dtype=torch.float64)
    grads = []
    for fn in (tm.ssd_sequential,
               lambda *a: tm.ssd_chunked(*a, chunk=8)):
        leaves = [a.detach().double().requires_grad_() for a in
                  (xh, Bm, Cm, dtf, la)]
        y, S = fn(*leaves, S0)
        ((y ** 2).sum() + S.sum()).backward()
        grads.append([a.grad for a in leaves])
    for a, b in zip(*grads):
        assert torch.isfinite(b).all()
        torch.testing.assert_close(b, a, rtol=1e-9, atol=1e-9)


def test_card_picks_the_chunked_ssd(pair):
    """The form ``_ssd`` runs with no chunk given: chunked on the card
    for any T, here the reference's choice (``ssm_chunk`` unset: token by
    token; set: chunked only where it divides T)."""
    _, _, cfg, _ = pair
    assert cfg.ssm_chunk == 0
    for T in (1, 100, 4096):
        assert tm.default_chunk(cfg, T, "cuda") == tm.SSD_CHUNK
        assert tm.default_chunk(cfg, T, "cpu") == 0
    c8 = dataclasses.replace(cfg, ssm_chunk=8)
    assert tm.default_chunk(c8, 13, "cuda") == 8
    assert [tm.default_chunk(c8, T, "cpu") for T in (4, 13, 16)] == [0, 0, 8]


# --------------------------------------------------------------------------
# The bridge and the head-dim route
# --------------------------------------------------------------------------
def test_bridge_layout_and_errors(pair):
    jcfg, jparams, cfg, params = pair
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    for name in ("A_log", "dt_bias", "D_skip"):
        assert params["mamba"][name].dtype == torch.float32
    bf = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                  dataclasses.replace(
                                      cfg, dtype=torch.bfloat16),
                                  device="cpu")
    assert bf["mamba"]["A_log"].dtype == torch.float32
    assert bf["mamba"]["w_in"].dtype == torch.bfloat16
    np_tree = jax.tree.map(np.asarray, jparams)
    bad = dict(np_tree, mamba={k: v for k, v in np_tree["mamba"].items()
                               if k != "D_skip"})
    with pytest.raises(KeyError):
        bridge.params_from_numpy(bad, cfg, device="cpu")
    bad = dict(np_tree, mamba=dict(np_tree["mamba"]))
    bad["mamba"]["w_in"] = bad["mamba"]["w_in"].reshape(
        (4, 1) + bad["mamba"]["w_in"].shape[2:])     # flat [L] stacking
    with pytest.raises(ValueError):
        bridge.params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(KeyError):
        bridge.params_from_numpy({k: v for k, v in np_tree.items()
                                  if k != "shared"}, cfg, device="cpu")


def test_head_dim_80_routes_around_the_kernels(monkeypatch):
    """zamba2's own head dim (80) is in no kernel build: the shared
    block's prefill and decode must never reach #6 or #5 (their wrappers
    made to raise here) and still match the reference."""
    assert 80 not in tattn.KERNEL_HEAD_DIMS
    jcfg, jparams, cfg, params = _pair(head_dim=80)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called at Dh 80")
    for name in ("prefill_attention", "decode_attention", "causal_prefill"):
        monkeypatch.setattr(tattn, name, refuse)
    B, T = 2, 10
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 1)) \
        .astype(np.int32)
    logits, state = tm.prefill(params, cfg, t(tok[:, :T]), T + 2)
    jlog, jstate = jm.prefill(jparams, jcfg, jnp.asarray(tok[:, :T]), T + 2)
    _close(logits, jlog, LOGIT_TOL)
    pos = np.full((B,), T, np.int32)
    logits, _ = tm.forward_decode(params, cfg, t(tok[:, T]), state, t(pos))
    jlog, _ = jm.forward_decode(jparams, jcfg, jnp.asarray(tok[:, T]),
                                jstate, jnp.asarray(pos))
    _close(logits, jlog, LOGIT_TOL)
    # at a kernel head dim, the same call does reach the wrapper
    _, _, cfg64, params64 = _pair()
    with pytest.raises(AssertionError, match="kernel wrapper"):
        tm.prefill(params64, cfg64, t(tok[:, :T]))
