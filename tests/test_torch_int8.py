"""int8 KV in the port vs the JAX reference, f32 on the CPU.

The pool ops (``quantize_kv`` values and scales bit-equal to the
reference's; the int8 branch of ``scatter_pool``; ``quantize_piece`` /
``dequantize_piece``; zero-scale garbage blocks), the int8 mode of the
fused kernel's plain version against the Pallas kernel in interpret mode,
its bounded error against the full-precision result, an int8 torch engine
against the JAX int8 engine (identical greedy streams), and migration
between int8 and full-width engines across the two frameworks (the wire
stays full-width). The card's test of the int8 kernel itself is
``tests/test_torch_kernels.py::test_cuda_int8_kernel_matches_plain``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.mixed_attention import \
    paged_mixed_attention as jax_mixed  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import request as jreq_mod  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.migration import kv_bytes  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels import mixed_attention as tk  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import request as treq_mod  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

from test_torch_kernels import ALIAS, SEGS, live_rows, mixed_case  # noqa: E402,E501


def _rows(seed, shape, scale=1.0):
    """Random rows with a spread of magnitudes, one exactly-zero row and
    values that land on rounding ties after scaling."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, shape) * np.exp(rng.normal(0, 2, shape[:-1]))[
        ..., None] * scale).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1] = np.arange(shape[-1], dtype=np.float32) - shape[-1] // 2
    return x


# --------------------------------------------------------------------------
# Pool ops
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 16, 2, 64), (3, 5, 8, 128)])
def test_quantize_kv_equals_reference(shape):
    """int8 values and f32 scales bit-equal to the reference's: amax in
    f32, max(amax/127, 1e-8), round half to even of x / scale."""
    x = _rows(1, shape)
    want_q, want_s = jattn.quantize_kv(jnp.asarray(x))
    got_q, got_s = attn.quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_scatter_pool_int8_in_place_equals_reference():
    """Quantize-on-write into an int8 pool slice, in place, gives the
    reference's pool leaves (rows and scales) exactly; rows not written
    keep int8 0 and scale 0."""
    cfg = get_config("smollm-360m").reduced()
    NB, BS = 6, 16
    pool = attn.make_paged_pool(cfg, NB, BS, device="cpu", kv_dtype="int8")
    assert isinstance(pool, attn.QuantKVCache)
    assert pool.k_scale.shape == (NB, BS, cfg.num_kv_heads)
    jpool = jattn.make_paged_pool(jax_get_config("smollm-360m").reduced(),
                                  NB, BS, kv_dtype="int8")
    rng = np.random.default_rng(2)
    blk = rng.integers(0, NB - 1, (3, 4)).astype(np.int32)
    off = np.stack([rng.permutation(BS)[:4] for _ in range(3)]).astype(
        np.int32)
    blk[1] = blk[0]                      # distinct (blk, off) pairs only
    off[1] = (off[0] + 5) % BS
    k = _rows(3, (3, 4, cfg.num_kv_heads, cfg.head_dim))
    v = _rows(4, (3, 4, cfg.num_kv_heads, cfg.head_dim))
    out = attn.scatter_pool(pool, torch.from_numpy(blk),
                            torch.from_numpy(off), torch.from_numpy(k),
                            torch.from_numpy(v))
    assert out is pool and out.k.data_ptr() == pool.k.data_ptr()
    want = jattn.scatter_pool(jpool, jnp.asarray(blk), jnp.asarray(off),
                              jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(pool, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not pool.k_scale[NB - 1].any()      # never written: scale 0
    # the bridge carries an int8 pool both ways, dtypes and all
    back = bridge.pool_from_numpy(jax.tree.map(np.asarray, want),
                                  device="cpu")
    assert isinstance(back, attn.QuantKVCache)
    for a, b in zip(back, bridge.pool_to_numpy(pool)):
        assert a.dtype == torch.from_numpy(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_quantize_roundtrip_and_garbage_blocks():
    """The twin of the reference's round-trip test: quantize ->
    dequantize errs by at most half a quant step per element, matches the
    reference's ``dequantize_piece`` exactly, and a zero-initialized
    (garbage) block carries zero scales and dequantizes to exact zeros."""
    x = _rows(5, (4, 16, 2, 64))
    piece = attn.KVCache(torch.from_numpy(x), torch.from_numpy(-x))
    q = attn.quantize_piece(piece)
    back = attn.dequantize_piece(q, torch.float32)
    step = np.abs(x).max(-1, keepdims=True) / 127.0
    assert np.all(np.abs(back.k.numpy() - x) <= step * 0.5 + 1e-7)
    jq = jattn.quantize_piece(jattn.KVCache(jnp.asarray(x), jnp.asarray(-x)))
    jback = jattn.dequantize_piece(jq, jnp.float32)
    for a, b in zip(back, jback):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cfg = get_config("smollm-360m").reduced()
    pool = attn.make_paged_pool(cfg, 3, 16, device="cpu", kv_dtype="int8")
    garbage = attn.QuantKVCache(*(a[2:3] for a in pool))
    assert not garbage.k_scale.any()
    assert attn.dequantize_piece(garbage, torch.float32).k.abs().max() == 0


def test_check_kv_backend_int8_needs_fused():
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        Engine(0, model, params, attn_backend="flat", kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        Engine(0, model, params, kv_dtype="fp8")
    pool = attn.make_paged_pool(cfg, 2, 16, device="cpu", kv_dtype="int8")
    with pytest.raises(ValueError, match="fused"):
        attn._check_kv_backend(pool, "flat")
    assert cost.kv_bytes_per_elem("int8", 128) == pytest.approx(1.03125)
    assert cost.kv_bytes_per_elem("bf16", 64) == 2.0


# --------------------------------------------------------------------------
# The int8 mode of the fused kernel (plain version on the CPU)
# --------------------------------------------------------------------------
def _int8_case(H, Hkv, Dh, C=32, BS=16):
    q, kp, vp, bt, ctx, seg, tags = mixed_case(SEGS, C, H, Hkv, Dh, BS,
                                               alias=ALIAS)
    kq, ks = attn.quantize_kv(torch.from_numpy(kp))
    vq, vs = attn.quantize_kv(torch.from_numpy(vp))
    return q, kp, vp, bt, ctx, seg, tags, (kq, vq, ks, vs)


@pytest.mark.parametrize("H,Hkv,Dh", [(8, 2, 64), (6, 2, 128)])
def test_int8_plain_matches_jax_int8_kernel(H, Hkv, Dh):
    """The int8 plain version == the Pallas kernel's quantized variant in
    interpret mode on every live row, f32 within 2e-5; padding rows and
    the dead slot are zero."""
    q, _, _, bt, ctx, seg, tags, (kq, vq, ks, vs) = _int8_case(H, Hkv, Dh)
    want = np.asarray(jax_mixed(
        *map(jnp.asarray, (q, kq.numpy(), vq.numpy(), bt, ctx, seg, tags,
                           ks.numpy(), vs.numpy())), interpret=True),
        np.float32)
    ints = [torch.from_numpy(a) for a in (bt, ctx, seg, tags)]
    launches = tk.INT8_LAUNCHES
    out = tk.paged_mixed_attention(torch.from_numpy(q), kq, vq, *ints,
                                   ks, vs).numpy()
    assert tk.INT8_LAUNCHES == launches          # the CPU never launches
    for i, s in enumerate(SEGS):
        n = 0 if s == ("dec", 0) else live_rows(seg, tags, i)
        np.testing.assert_allclose(out[i, :n], want[i, :n], atol=2e-5,
                                   rtol=2e-5)
        assert not out[i, n:].any(), f"segment {i}: padding rows not zero"


def test_int8_bounded_error_vs_full_precision():
    """The twin of ``test_fused_int8_bounded_error``: every live output
    row of the int8 mode is within cos >= 0.999 and max abs <= 0.05 of the
    full-precision result on the unquantized pool."""
    q, kp, vp, bt, ctx, seg, tags, (kq, vq, ks, vs) = _int8_case(8, 2, 64)
    ints = [torch.from_numpy(a) for a in (bt, ctx, seg, tags)]
    ref = tk.paged_mixed_attention(*(torch.from_numpy(a)
                                     for a in (q, kp, vp)), *ints).numpy()
    out = tk.paged_mixed_attention(torch.from_numpy(q), kq, vq, *ints,
                                   ks, vs).numpy()
    for i, s in enumerate(SEGS):
        if s == ("dec", 0):
            continue
        for r in range(live_rows(seg, tags, i)):
            a, b = out[i, r].ravel(), ref[i, r].ravel()
            cos = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b),
                                    1e-12))
            assert cos >= 0.999, (i, r, cos)
            assert float(np.abs(a - b).max()) <= 0.05, (i, r)


def test_wrapper_refuses_mismatched_scales():
    q = torch.empty((1, 1, 2, 64), device="meta")
    pool = torch.empty((2, 16, 1, 64), dtype=torch.int8, device="meta")
    sc = torch.empty((2, 16, 1), device="meta")
    ints = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="both scales"):
        tk.paged_mixed_attention(q, pool, pool, ints[:, None], ints, ints,
                                 ints, sc, None)


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------
PROMPTS = (5, 23, 12)
NEW = 8
KW = dict(max_slots=3, max_seq=64, prefill_token_budget=8)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("smollm-360m").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    return jmodel, jparams, build_model(cfg), params, prompts


def _drain(eng, reqs, max_iters=200):
    for r in reqs:
        eng.submit(r)
    done = []
    for _ in range(max_iters):
        done += eng.step()
        if len(done) == len(reqs):
            return
    raise AssertionError("engine did not drain")


def _jax_int8_streams(setup):
    jmodel, jparams, _, _, prompts = setup
    eng = JaxEngine(0, jmodel, jparams, attn_backend="fused",
                    kv_dtype="int8", **KW)
    reqs = [jreq_mod.ServeRequest(i, p.copy(), NEW)
            for i, p in enumerate(prompts)]
    _drain(eng, reqs)
    return eng, reqs


@pytest.fixture(scope="module")
def jax_int8(setup):
    return _jax_int8_streams(setup)


def test_int8_engine_matches_jax_int8_engine(setup, jax_int8):
    """The torch engine on an int8 pool (fused backend, plain attention)
    gives the JAX int8 fused engine's greedy streams and step timings on
    the trace of ``tests/test_fused_attention.py``; its pool holds int8
    rows and f32 scales and takes (Dh + 4) / (2 Dh) of the full-width
    pool's bytes per f32... in bf16 terms: half."""
    _, _, model, params, prompts = setup
    jeng, jreqs = jax_int8
    eng = Engine(0, model, params, attn_backend="fused", kv_dtype="int8",
                 **KW)
    assert isinstance(eng.cache, attn.QuantKVCache)
    assert eng.cache.k.dtype == torch.int8
    reqs = [treq_mod.ServeRequest(i, p.copy(), NEW)
            for i, p in enumerate(prompts)]
    _drain(eng, reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [(r.first_token_step, r.finish_step) for r in reqs] == \
        [(r.first_token_step, r.finish_step) for r in jreqs]
    full = Engine(1, model, params, attn_backend="fused", **KW)
    Dh = model.cfg.head_dim
    assert kv_bytes(eng.cache) / kv_bytes(full.cache) == pytest.approx(
        cost.kv_bytes_per_elem("int8", Dh) / 4.0)     # vs the f32 pool
    eng.check_drained()
    full.check_drained()


BUDGET = 8
MKW = dict(max_slots=2, max_seq=96, prefill_token_budget=BUDGET)


def _run_until(eng, req, n=5):
    for _ in range(60):
        eng.step()
        if len(req.generated) >= n and not req.prefilling:
            return req.slot
    raise AssertionError("request never reached the export point")


def _until_done(eng, req):
    for _ in range(200):
        if any(r is req for r in eng.step()):
            return
    raise AssertionError("request did not finish")


def _carry(req, dst_mod):
    out = dst_mod.ServeRequest(req.req_id, req.prompt.copy(),
                               req.max_new_tokens)
    out.generated = list(req.generated)
    out.ctx_done = req.ctx_done
    out.first_token_step = req.first_token_step
    out.state = dst_mod.State.RUNNING
    return out


def _jax_migrate(setup, prompt, src_kv, dst_kv):
    """The reference's own migration between a JAX ``src_kv`` engine and
    a JAX ``dst_kv`` engine: the stream the port must reproduce."""
    jmodel, jparams = setup[:2]
    backend = {"int8": "fused", "bf16": "dense"}
    src = JaxEngine(0, jmodel, jparams, attn_backend=backend[src_kv],
                    kv_dtype=src_kv, **MKW)
    req = jreq_mod.ServeRequest(0, prompt.copy(), 14)
    src.submit(req)
    slot = _run_until(src, req)
    _, piece, _ = src.export_slot(slot)
    src.evict_slot(slot)
    dst = JaxEngine(1, jmodel, jparams, attn_backend=backend[dst_kv],
                    kv_dtype=dst_kv, **MKW)
    assert dst.import_request(req, piece)
    _until_done(dst, req)
    return req.generated


@pytest.mark.parametrize("src_kv,dst_kv", [("int8", "bf16"),
                                           ("bf16", "int8")])
def test_migration_int8_full_width_across_frameworks(setup, src_kv, dst_kv):
    """A request decoding on a JAX engine of one KV dtype migrates (the
    full-width wire, through numpy) into a torch engine of the other and
    continues exactly as the reference's own migration between engines
    of those dtypes continues; an int8 exporter ships dequantized rows."""
    jmodel, jparams, model, params, prompts = setup
    prompt = np.random.default_rng(9).integers(
        0, model.cfg.vocab_size, 30).astype(np.int32)
    want = _jax_migrate(setup, prompt, src_kv, dst_kv)
    backend = {"int8": "fused", "bf16": "dense"}
    src = JaxEngine(0, jmodel, jparams, attn_backend=backend[src_kv],
                    kv_dtype=src_kv, **MKW)
    req = jreq_mod.ServeRequest(0, prompt.copy(), 14)
    src.submit(req)
    slot = _run_until(src, req)
    _, piece, _ = src.export_slot(slot)
    assert isinstance(piece, jattn.KVCache)           # full-width wire
    tpiece = bridge.pool_from_numpy(jax.tree.map(np.asarray, piece),
                                    device="cpu")
    moved = _carry(req, treq_mod)
    src.evict_slot(slot)
    dst = Engine(1, model, params, kv_dtype=dst_kv,
                 attn_backend="fused" if dst_kv == "int8" else "flat", **MKW)
    assert dst.import_request(moved, tpiece)
    _until_done(dst, moved)
    assert moved.generated == want
    dst.check_drained()


def test_migration_int8_torch_to_jax_continues_unmigrated(setup):
    """int8 torch engine -> int8 JAX engine: the dequantized wire
    re-quantizes to the same int8 rows, and the request continues with
    the tokens of the unmigrated int8 run."""
    jmodel, jparams, model, params, _ = setup
    prompt = np.random.default_rng(9).integers(
        0, model.cfg.vocab_size, 30).astype(np.int32)
    ref = Engine(2, model, params, kv_dtype="int8", **MKW)
    alone = treq_mod.ServeRequest(0, prompt.copy(), 14)
    ref.submit(alone)
    _until_done(ref, alone)
    src = Engine(0, model, params, kv_dtype="int8", **MKW)
    req = treq_mod.ServeRequest(0, prompt.copy(), 14)
    src.submit(req)
    slot = _run_until(src, req)
    rows = np.concatenate([src.cache.k[:, b].numpy()
                           for b in src.block_tables[slot]], axis=1)
    _, piece, _ = src.export_slot(slot)
    assert piece.k.dtype == torch.float32
    k, v = bridge.pool_to_numpy(piece)
    moved = _carry(req, jreq_mod)
    src.evict_slot(slot)
    dst = JaxEngine(1, jmodel, jparams, attn_backend="fused",
                    kv_dtype="int8", **MKW)
    assert dst.import_request(moved, jattn.KVCache(jnp.asarray(k),
                                                   jnp.asarray(v)))
    written = req.length - 1
    got = np.concatenate([np.asarray(dst.cache.k[:, b])
                          for b in dst.block_tables[moved.slot]], axis=1)
    np.testing.assert_array_equal(got[:, :written], rows[:, :written])
    _until_done(dst, moved)
    assert moved.generated == alone.generated
    ref.check_drained()
    src.check_drained()
