"""The port's ``flat`` kernel pair vs the JAX reference, and the chunked
prefill path built on it.

On the CPU each wrapper runs its plain PyTorch version, held against the
Pallas kernel in interpret mode and against ``repro/kernels/ref.py`` on
live rows (f32, 2e-5): heterogeneous lengths, a dead slot, shared prefix
blocks, a chunk with ``clen < C``. ``attention_prefill_chunk_paged`` and
``forward_prefill_chunk`` match the JAX functions (1e-5 / 1e-4), and
chunk-by-chunk pool rows equal the reference's. The ``gpu``-marked tests
hold each CUDA kernel against its plain version on the card; JAX is
imported by the CPU tests only."""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import prefill_attention as pk  # noqa: E402
from repro_torch.kernels.ops import flat_work_list  # noqa: E402

TOL = 2e-5


@pytest.fixture(scope="module")
def ref():
    """The JAX reference kernels and oracles."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import paged_decode_attention_flat
    from repro.kernels.prefill_attention import paged_prefill_attention
    return types.SimpleNamespace(jnp=jnp, decode=paged_decode_attention_flat,
                                 prefill=paged_prefill_attention,
                                 decode_ref=jref.decode_attention_ref,
                                 prefill_ref=jref.prefill_attention_ref)


def paged_case(totals, H, Hkv, Dh, BS, seed=7):
    """A random pool holding ``totals[i]`` keys for row i and block tables
    padded with an unused block; returns the generator for the q rows."""
    rng = np.random.default_rng(seed)
    B = len(totals)
    NBT = max(max(-(-t // BS) for t in totals), 1) + 1
    NB = sum(-(-t // BS) for t in totals) + 3
    perm = rng.permutation(NB)
    k_pool = np.zeros((NB, BS, Hkv, Dh), np.float32)
    v_pool = np.zeros_like(k_pool)
    bt = np.full((B, NBT), NB - 1, np.int32)
    pi = 0
    for s, t in enumerate(totals):
        for j in range(-(-t // BS)):
            pb = int(perm[pi])
            pi += 1
            bt[s, j] = pb
            k_pool[pb] = rng.normal(0, 1, (BS, Hkv, Dh))
            v_pool[pb] = rng.normal(0, 1, (BS, Hkv, Dh))
    return rng, k_pool, v_pool, bt


def gathered(pool, bt):
    """[B, NBT*BS, Hkv, Dh] contiguous per-row view."""
    B, NBT = bt.shape
    return pool[bt].reshape(B, NBT * pool.shape[1], *pool.shape[2:])


# 128x length spread, a dead slot, a one-key row, rows 4 and 5 sharing
# their first block
DEC_LENS = [5, 130, 0, 640, 1, 33, 47]
DEC_ALIAS = (4, 5, 1)


def decode_case(H, Hkv, Dh, BS=16, lens=DEC_LENS, alias=DEC_ALIAS):
    lens = list(lens)
    rng, kp, vp, bt = paged_case(lens, H, Hkv, Dh, BS)
    if alias:       # row j reads row i's first nb blocks
        i, j, nb = alias
        need = -(-lens[j] // BS)
        assert nb <= min(need, -(-lens[i] // BS))
        bt[j, :nb] = bt[i, :nb]
    q = rng.normal(0, 1, (len(lens), H, Dh)).astype(np.float32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("H,Hkv,Dh", [(8, 2, 64), (6, 2, 128), (20, 2, 64)])
@pytest.mark.parametrize("bucket", ["real", "pow2", "worst"])
def test_decode_plain_matches_jax_flat_kernel(ref, H, Hkv, Dh, bucket):
    """Plain flat decode == the Pallas kernel (interpret mode) and the
    ``ref.py`` oracle on live rows; the dead slot's row is zero."""
    BS = 16
    q, kp, vp, bt, lens = decode_case(H, Hkv, Dh, BS)
    real = sum(-(-int(n) // BS) for n in lens)
    num_work = {"real": real, "pow2": 1 << (real - 1).bit_length(),
                "worst": None}[bucket]
    want = np.asarray(ref.decode(*map(ref.jnp.asarray, (q, kp, vp, bt, lens)),
                                 num_work=num_work, interpret=True),
                      np.float32)
    oracle = np.asarray(ref.decode_ref(
        ref.jnp.asarray(q), ref.jnp.asarray(gathered(kp, bt)),
        ref.jnp.asarray(gathered(vp, bt)), ref.jnp.asarray(lens)), np.float32)
    launches = dk.LAUNCHES
    out = dk.paged_decode_attention_flat(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, lens)),
        num_work=num_work).numpy()
    assert dk.LAUNCHES == launches            # the CPU never launches
    live = lens > 0
    np.testing.assert_allclose(out[live], want[live], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out[live], oracle[live], atol=TOL, rtol=TOL)
    assert not out[~live].any(), "dead slot row not zero"


# (ctx, clen) per chunk at C = 32: a long context, a fresh prompt, a short
# tail chunk (clen < C), a dead chunk, and chunk 4 sharing chunk 0's prefix
CHUNKS = [(300, 32), (0, 32), (77, 9), (0, 0), (48, 20)]
CK_ALIAS = (0, 4, 3)


def prefill_case(H, Hkv, Dh, C=32, BS=16, chunks=CHUNKS, alias=CK_ALIAS):
    totals = [c + n for c, n in chunks]
    # tables must cover ctx + C rows (the chunk's padding rows write there)
    rng, kp, vp, bt = paged_case([c + C for c, _ in chunks], H, Hkv, Dh, BS)
    if alias:
        i, j, nb = alias
        bt[j, :nb] = bt[i, :nb]
    q = rng.normal(0, 1, (len(chunks), C, H, Dh)).astype(np.float32)
    ctx = np.asarray([c for c, _ in chunks], np.int32)
    clen = np.asarray([n for _, n in chunks], np.int32)
    return q, kp, vp, bt, ctx, clen, totals


@pytest.mark.parametrize("H,Hkv,Dh", [(8, 2, 64), (6, 2, 128)])
def test_prefill_plain_matches_jax_paged_prefill(ref, H, Hkv, Dh):
    """Plain chunked prefill == the Pallas kernel (interpret mode) on rows
    ``< clen``, and == the causal ``ref.py`` oracle over each chunk's full
    context; padding rows are zero."""
    C, BS = 32, 16
    q, kp, vp, bt, ctx, clen, totals = prefill_case(H, Hkv, Dh, C, BS)
    want = np.asarray(ref.prefill(
        *map(ref.jnp.asarray, (q, kp, vp, bt, ctx, clen)), interpret=True),
        np.float32)
    out = pk.paged_prefill_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, ctx, clen))).numpy()
    kg, vg = gathered(kp, bt), gathered(vp, bt)
    for b, (c, n) in enumerate(zip(ctx, clen)):
        np.testing.assert_allclose(out[b, :n], want[b, :n], atol=TOL,
                                   rtol=TOL)
        assert not out[b, n:].any(), f"chunk {b}: padding rows not zero"
        if n == 0:
            continue
        # oracle: the whole prefix as one causal sequence, chunk rows only
        T = int(c + n)
        qfull = np.zeros((1, T, H, Dh), np.float32)
        qfull[0, c:] = q[b, :n]
        oracle = np.asarray(ref.prefill_ref(
            ref.jnp.asarray(qfull), ref.jnp.asarray(kg[b:b + 1, :T]),
            ref.jnp.asarray(vg[b:b + 1, :T])), np.float32)[0, c:]
        np.testing.assert_allclose(out[b, :n], oracle, atol=TOL, rtol=TOL)


def test_wrappers_refuse_devices_without_a_kernel():
    q3 = torch.empty((1, 2, 64), device="meta")
    q4 = torch.empty((1, 1, 2, 64), device="meta")
    pool = torch.empty((2, 16, 1, 64), device="meta")
    ints = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dk.paged_decode_attention_flat(q3, pool, pool, ints[:, None], ints)
    with pytest.raises(ValueError, match="no kernel"):
        pk.paged_prefill_attention(q4, pool, pool, ints[:, None], ints, ints)


# --------------------------------------------------------------------------
# The paged layer and the stack
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """Reduced smollm-360m in both frameworks, the same weights."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    jcfg = jget("smollm-360m").reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    return types.SimpleNamespace(jax=jax, jcfg=jcfg, jmodel=jmodel,
                                 jparams=jparams, cfg=cfg,
                                 model=build_model(cfg), params=params)


@pytest.mark.parametrize("backend", ["flat", "fused"])
def test_attention_prefill_chunk_paged_matches_jax(models, backend):
    """One layer's chunk attention (flat or fused kernel path) == the JAX
    function on its ``flat`` interpret path, within 1e-5; pool rows
    equal."""
    from repro.models import attention as jattn
    from repro_torch.bridge import pool_from_numpy, pool_to_numpy
    from repro_torch.models import attention as tattn
    from repro_torch.models.transformer import layer_params
    jax, cfg = models.jax, models.cfg
    jnp = jax.numpy
    rng = np.random.default_rng(3)
    BS, C, NB = 16, 16, 24
    x = rng.normal(0, 1, (3, C, cfg.d_model)).astype(np.float32)
    ctx = np.asarray([0, 37, 5], np.int32)
    clen = np.asarray([16, 11, 3], np.int32)
    bt = np.full((3, 5), NB - 1, np.int32)
    bt[0, :1] = [2]
    bt[1, :4] = [7, 3, 11, 4]
    bt[2, :2] = [9, 5]
    pool = rng.normal(0, 1, (NB, BS, cfg.num_kv_heads, cfg.head_dim)
                      ).astype(np.float32)
    pl = jax.tree.map(lambda a: a[0], models.jparams["layers"]["attn"])
    jout, jpool = jattn.attention_prefill_chunk_paged(
        pl, models.jcfg, jnp.asarray(x), jattn.KVCache(jnp.asarray(pool),
                                                       jnp.asarray(pool)),
        jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(clen),
        attn_backend="flat", attn_interpret=True)
    tp = layer_params(models.params["layers"], 0)["attn"]
    tpool = pool_from_numpy((pool, pool), device="cpu")
    out, tpool = tattn.attention_prefill_chunk_paged(
        tp, cfg, torch.from_numpy(x), tpool, torch.from_numpy(bt),
        torch.from_numpy(ctx), torch.from_numpy(clen), attn_backend=backend)
    out = out.numpy()
    for b in range(3):
        np.testing.assert_allclose(out[b, :clen[b]],
                                   np.asarray(jout)[b, :clen[b]],
                                   atol=1e-5, rtol=1e-5)
    got = pool_to_numpy(tpool)
    np.testing.assert_allclose(got.k, np.asarray(jpool.k), atol=1e-5)
    np.testing.assert_allclose(got.v, np.asarray(jpool.v), atol=1e-5)


@pytest.mark.parametrize("chunk", [7, 16])
def test_forward_prefill_chunk_matches_jax_chunk_by_chunk(models, chunk):
    """Two prompts (29 and 40 tokens) prefilled chunk by chunk through the
    stack: every chunk's last-token logits match the JAX forward within
    1e-4, and the final pool rows equal the reference's within 1e-5."""
    from repro_torch.bridge import pool_to_numpy
    jax, cfg = models.jax, models.cfg
    jnp = jax.numpy
    BS, NB = 16, 12
    rng = np.random.default_rng(5)
    lens = (29, 40)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    bt = np.asarray([[1, 4, 6, 11], [2, 8, 3, 11]], np.int32)
    jpool = models.jmodel.init_paged_cache(NB, BS)
    tpool = models.model.init_paged_cache(NB, BS, device="cpu")
    for c0 in range(0, max(lens), chunk):
        ctx = np.asarray([min(c0, n) for n in lens], np.int32)
        clen = np.asarray([max(0, min(chunk, n - c0)) for n in lens],
                          np.int32)
        live = clen > 0
        toks = np.zeros((2, chunk), np.int32)
        for b, p in enumerate(prompts):
            toks[b, :clen[b]] = p[ctx[b]:ctx[b] + clen[b]]
        # finished prompts ride along as dead rows on the garbage block
        bt_c = np.where(live[:, None], bt, NB - 1).astype(np.int32)
        jlog, jpool = models.jmodel.prefill_chunk(
            models.jparams, jpool, jnp.asarray(toks), jnp.asarray(bt_c),
            jnp.asarray(ctx), jnp.asarray(np.maximum(clen, 1)))
        tlog, tpool = models.model.prefill_chunk(
            models.params, tpool, torch.from_numpy(toks),
            torch.from_numpy(bt_c), torch.from_numpy(ctx),
            torch.from_numpy(np.maximum(clen, 1)), attn_backend="flat")
        np.testing.assert_allclose(tlog.numpy()[live],
                                   np.asarray(jlog)[live], atol=1e-4,
                                   rtol=1e-4)
    got = pool_to_numpy(tpool)
    for b, n in enumerate(lens):
        for leaf_t, leaf_j in ((got.k, jpool.k), (got.v, jpool.v)):
            rows_t = leaf_t[:, bt[b]].reshape(cfg.num_layers, -1,
                                              *leaf_t.shape[3:])[:, :n]
            rows_j = np.asarray(leaf_j)[:, bt[b]].reshape(
                cfg.num_layers, -1, *leaf_t.shape[3:])[:, :n]
            np.testing.assert_allclose(rows_t, rows_j, atol=1e-5)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    """The card, decided here (never at import or collection time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
def test_cuda_flat_decode_matches_plain(cuda, dtype, tol):
    """The built flat decode kernel == its plain version on the card, at
    llama3.2-3b heads (G 3, Dh 128) and at G 10 / Dh 64 (two rows a
    thread), with the pow2 bucket and the worst-case bucket."""
    dt = getattr(torch, dtype)
    for H, Hkv, Dh in ((24, 8, 128), (20, 2, 64)):
        q, kp, vp, bt, lens = decode_case(H, Hkv, Dh)
        floats = [torch.from_numpy(a).to(cuda, dt) for a in (q, kp, vp)]
        ints = [torch.from_numpy(a).to(cuda) for a in (bt, lens)]
        real = sum(-(-int(n) // 16) for n in lens)
        for num_work in (1 << (real - 1).bit_length(), None):
            launches = dk.LAUNCHES
            out = dk.paged_decode_attention_flat(*floats, *ints,
                                                 num_work=num_work)
            torch.cuda.synchronize()
            assert dk.LAUNCHES == launches + 1
            work = flat_work_list(ints[1], bt.shape[1], 16,
                                  num_work or bt.size)
            given = dk.paged_decode_attention_flat(
                *floats, *ints, num_work=num_work, work_list=work)
            assert torch.equal(given, out)
            plain = dk.paged_decode_attention_flat_plain(*floats, *ints)
            torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                       rtol=tol)
            assert not out[ints[1] == 0].float().abs().max().item()
            assert math.isfinite(out.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
def test_cuda_paged_prefill_matches_plain(cuda, dtype, tol):
    """The built chunked prefill kernel == its plain version on the card,
    padding rows included (zeros), at llama3.2-3b heads and at Dh 64."""
    dt = getattr(torch, dtype)
    for H, Hkv, Dh, C in ((24, 8, 128, 64), (8, 2, 64, 32)):
        chunks = [(300, C), (0, C), (77, 9), (0, 0), (48, 20)]
        q, kp, vp, bt, ctx, clen, _ = prefill_case(H, Hkv, Dh, C,
                                                   chunks=chunks)
        floats = [torch.from_numpy(a).to(cuda, dt) for a in (q, kp, vp)]
        ints = [torch.from_numpy(a).to(cuda) for a in (bt, ctx, clen)]
        launches = pk.LAUNCHES
        out = pk.paged_prefill_attention(*floats, *ints)
        torch.cuda.synchronize()
        assert pk.LAUNCHES == launches + 1
        plain = pk.paged_prefill_attention_plain(*floats, *ints)
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
        assert math.isfinite(out.float().abs().max().item())


def test_forward_mixed_flat_matches_fused(models):
    """A mixed iteration on the ``flat`` backend (flat decode + chunked
    prefill) gives the fused kernel's logits and pool rows, within 1e-5:
    two decode rows (one dead) beside two chunks."""
    cfg, model, params = models.cfg, models.model, models.params
    BS, NB = 16, 20
    rng = np.random.default_rng(11)
    dec_tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, 2)
                               .astype(np.int32))
    ck_tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                              .astype(np.int32))
    bt_dec = torch.tensor([[3, 5, 19], [19, 19, 19]], dtype=torch.int32)
    bt_ck = torch.tensor([[7, 8], [9, 19]], dtype=torch.int32)
    pos = torch.tensor([20, -1], dtype=torch.int32)
    ctx = torch.tensor([12, 0], dtype=torch.int32)
    clen = torch.tensor([8, 5], dtype=torch.int32)
    base = model.init_paged_cache(NB, BS, device="cpu")
    for leaf in base:
        leaf.copy_(torch.from_numpy(rng.normal(0, 1, leaf.shape)
                                    .astype(np.float32)))
    out = {}
    for backend in ("flat", "fused"):
        pool = type(base)(base.k.clone(), base.v.clone())
        dec, ck, pool = model.mixed_step(params, pool, dec_tok, ck_tok,
                                         bt_dec, bt_ck, pos, ctx, clen,
                                         attn_backend=backend)
        out[backend] = (dec, ck, pool)
    for a, b in zip(out["flat"][:2] + tuple(out["flat"][2]),
                    out["fused"][:2] + tuple(out["fused"][2])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
