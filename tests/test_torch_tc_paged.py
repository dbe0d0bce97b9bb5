"""The tensor-core paths of the fused mixed kernel and the chunked paged
prefill kernel (``csrc/tc_walk.cuh``, ``csrc/split_decode.cuh``).

On the CPU: the fused launch's host plan (split cover, row tiles, grid
size, from shapes alone), the shape rule that picks the tensor-core path,
and the int8 operand algebra of the chunk walk written out in torch
(integers as bf16 operands, ``k_scale`` on the score columns, ``v_scale``
folded into P, P split into bf16 hi + lo, tile by tile) against
``paged_mixed_attention_plain``, which the JAX kernel's tests hold to the
reference. The ``gpu``-marked tests hold the built kernels to their plain
versions on the card at the edges of the new walks."""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import mixed_attention as tk  # noqa: E402
from repro_torch.kernels import prefill_attention as pk  # noqa: E402


def paged_case(segs, C, H, Hkv, Dh, BS, seed=0, alias=None):
    """Numpy operands of one mixed iteration. ``("dec", L)`` is a decode
    row over L cached tokens (L = 0: dead slot), ``("ck", ctx, clen)`` a
    prefill chunk (clen = 0: dead). ``alias=(i, j, nb)``: segments i and j
    share their first ``nb`` physical blocks. The table pads with the last
    block."""
    rng = np.random.default_rng(seed)
    B = len(segs)
    totals = [(s[1] if s[0] == "dec" else s[1] + s[2]) for s in segs]
    NBT = max(max(-(-t // BS) for t in totals), 1) + 1
    NB = sum(-(-t // BS) for t in totals) + 3
    perm = rng.permutation(NB)
    k_pool = rng.normal(0, 1, (NB, BS, Hkv, Dh)).astype(np.float32)
    v_pool = rng.normal(0, 1, (NB, BS, Hkv, Dh)).astype(np.float32)
    bt = np.full((B, NBT), NB - 1, np.int32)
    pi = 0
    for s, t in enumerate(totals):
        for j in range(-(-t // BS)):
            if alias and s == alias[1] and j < alias[2]:
                bt[s, j] = bt[alias[0], j]
                continue
            bt[s, j] = int(perm[pi])
            pi += 1
    q = rng.normal(0, 1, (B, C, H, Dh)).astype(np.float32)
    ctx = np.asarray([s[1] - 1 if s[0] == "dec" else s[1] for s in segs],
                     np.int32)
    seg = np.asarray([1 if s[0] == "dec" else s[2] for s in segs], np.int32)
    tags = np.asarray([0 if s[0] == "dec" else 1 for s in segs], np.int32)
    return q, k_pool, v_pool, bt, ctx, seg, tags


# --------------------------------------------------------------------------
# The host plan (CPU)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,C,H,Hkv", [(7, 256, 24, 8), (1, 1, 4, 4),
                                       (16, 1, 24, 8), (3, 100, 20, 1),
                                       (65535, 1, 24, 8)])
@pytest.mark.parametrize("NBT,BS", [(1, 16), (208, 16), (513, 16),
                                    (70000, 16), (30, 4), (9, 32)])
@pytest.mark.parametrize("sms", [8, 132])
def test_fused_plan_covers_splits_rows_and_fits_the_grid(B, C, H, Hkv, NBT,
                                                         BS, sms):
    """The splits cover table entries [0, NBT) once, none empty; the row
    tiles cover the C*G rows of a chunk segment, none empty; every split
    and every row tile has a block (two splits a block); the 1-D grid fits
    a launch."""
    S, P, row_tiles, X = tk.fused_grid(B, C, H, Hkv, NBT, BS, sms)
    covered = np.zeros(NBT, np.int64)
    for s in range(S):
        lo, hi = s * P, min((s + 1) * P, NBT)
        assert lo < hi, "empty split"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert 1 <= S <= dk.MAX_SPLITS
    rows = C * (H // Hkv)
    assert (row_tiles - 1) * tk.ROW_TILE < rows <= row_tiles * tk.ROW_TILE
    assert X >= row_tiles and X * tk.SPLITS_PER_BLOCK >= S
    assert X == max(row_tiles, -(-S // tk.SPLITS_PER_BLOCK))
    assert X * Hkv * B < 2 ** 31


def test_fused_plan_reads_shapes_only():
    """The plan is a function of host integers: no tensor (and so no
    length or tag) enters it, and the engine's one device-to-host read per
    step stays the only one."""
    params = inspect.signature(tk.fused_grid).parameters
    assert list(params) == ["B", "C", "H", "Hkv", "NBT", "BS", "sms"]
    assert all(p.annotation in (int, "int") for p in params.values())
    # phase 3's segments on 132 SMs: a 3300-token row in 21 splits of 10
    # table entries, chunks of 256 in 6 row tiles
    assert tk.fused_grid(7, 256, 24, 8, 208, 16, 132) == (21, 10, 6, 11)


@pytest.mark.parametrize("dtype,G,BS,quant,want", [
    (torch.bfloat16, 3, 16, False, True),
    (torch.bfloat16, 3, 4, False, True),
    (torch.bfloat16, 16, 32, False, True),
    (torch.bfloat16, 1, 64, False, True),
    (torch.bfloat16, 3, 128, False, True),
    (torch.bfloat16, 3, 6, False, False),     # BS 6 does not tile 64 keys
    (torch.bfloat16, 3, 48, False, False),
    (torch.bfloat16, 3, 6, True, True),       # int8: staged by threads
    (torch.bfloat16, 17, 16, False, False),   # G past the split tile
    (torch.bfloat16, 20, 16, True, False),
    (torch.float32, 3, 16, False, False),     # f32: the CUDA-core walk
    (torch.float32, 3, 16, True, False),
])
def test_tensor_core_path_by_shape(dtype, G, BS, quant, want):
    """The shape rule that picks the tensor-core path, as the kernel's
    header states it."""
    assert tk.tensor_core_path(dtype, G, BS, quant) is want


# --------------------------------------------------------------------------
# The int8 operand algebra (CPU)
# --------------------------------------------------------------------------
def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def int8_chunk_emulation(q, kq, vq, ks, vs, bt, ctx, clen, tile=64):
    """One chunk segment of the int8 tensor-core walk in torch: q rounded
    to bf16, the integers as bf16 operands (exact), S = Q K_intᵀ in f32
    times k_scale per key column, the causal online softmax in base 2 tile
    by tile, P times v_scale per key, split into bf16 hi + lo, and both
    halves times V_int in f32; l sums the unscaled P. Rows past the chunk
    are zeros. q [C, H, Dh] (bf16), pools int8 [NB, BS, Hkv, Dh], scales
    f32 [NB, BS, Hkv], bt [NBT] -> [C, H, Dh] f32."""
    C, H, Dh = q.shape
    BS, Hkv = kq.shape[1], kq.shape[2]
    G = H // Hkv
    total = ctx + clen
    idx = torch.arange(total)
    rows = bt.long()[idx // BS] * BS + idx % BS              # pool rows
    k_int = kq.reshape(-1, Hkv, Dh)[rows].float()            # [T, Hkv, Dh]
    v_int = vq.reshape(-1, Hkv, Dh)[rows].float()
    k_sc = ks.reshape(-1, Hkv)[rows]                         # [T, Hkv]
    v_sc = vs.reshape(-1, Hkv)[rows]
    qg = bf16(q[:clen].float()).reshape(clen, Hkv, G, Dh)
    lim = torch.minimum(torch.tensor(total), ctx + torch.arange(clen) + 1)
    log2e = 1.0 / math.log(2.0)
    scale_log2 = log2e / math.sqrt(Dh)
    m = torch.full((Hkv, G, clen), -math.inf)
    l = torch.zeros(Hkv, G, clen)
    o = torch.zeros(Hkv, G, clen, Dh)
    for j0 in range(0, total, tile):
        j1 = min(j0 + tile, total)
        s = torch.einsum("thgd,khd->hgtk", qg, k_int[j0:j1])
        s = s * k_sc[j0:j1].T[:, None, None, :]
        keep = torch.arange(j0, j1)[None, :] < lim[:, None]   # [t, k]
        s = torch.where(keep, s, -math.inf)
        mn = torch.maximum(m, s.amax(-1))
        base = torch.where(mn == -math.inf, 0.0, mn * scale_log2)
        alpha = torch.exp2(m * scale_log2 - base)
        p = torch.exp2(s * scale_log2 - base[..., None])
        l = l * alpha + p.sum(-1)
        m = mn
        pv = p * v_sc[j0:j1].T[:, None, None, :]
        hi = bf16(pv)
        lo = bf16(pv - hi)
        o = o * alpha[..., None] + torch.einsum(
            "hgtk,khd->hgtd", hi, v_int[j0:j1]) + torch.einsum(
            "hgtk,khd->hgtd", lo, v_int[j0:j1])
    out = torch.zeros(C, H, Dh)
    out[:clen] = (o / torch.where(l == 0, 1.0, l)[..., None]).permute(
        2, 0, 1, 3).reshape(clen, H, Dh)
    return out


# phase 3's chunk segments (chunks of 256 at ctx 2800 and at ctx 0) and a
# chunk of 100 rows at ctx 1000, llama3.2-3b heads, BS 16
@pytest.mark.parametrize("ctx,clen", [(2800, 256), (0, 256), (1000, 100)])
def test_int8_operand_algebra_matches_plain(ctx, clen):
    """The int8 chunk walk's rounding design, emulated in torch with bf16
    outputs, == the plain int8 version (which dequantizes in f32 before
    both products) within the card's 5e-3, at phase 3's chunk shapes."""
    from repro_torch.models.attention import quantize_kv
    H, Hkv, Dh, BS, C = 24, 8, 128, 16, 256
    q, kp, vp, bt, c_, s_, t_ = paged_case([("ck", ctx, clen)], C, H, Hkv,
                                           Dh, BS, seed=3)
    (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(a)) for a in (kp, vp))
    qb = torch.from_numpy(q).to(torch.bfloat16)
    ints = [torch.from_numpy(a) for a in (bt, c_, s_, t_)]
    want = tk.paged_mixed_attention_plain(qb, kq, vq, *ints, ks, vs)[0]
    got = int8_chunk_emulation(qb[0], kq, vq, ks, vs, ints[0][0], ctx, clen)
    torch.testing.assert_close(got.to(torch.bfloat16).float(), want.float(),
                               atol=5e-3, rtol=5e-3)
    assert not got[clen:].any()


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


# (H, Hkv, Dh, BS): G 1, 3, 4, 12 and 20, Dh 64 and 128, BS 4, 6, 16, 32
SHAPES = [(2, 2, 128, 16), (24, 8, 128, 16), (8, 2, 64, 4),
          (24, 2, 128, 32), (20, 1, 64, 16), (12, 4, 64, 6),
          (12, 1, 128, 4)]


def chunk_segs(BS):
    """Chunks of 1, 15, 16, 17, 63, 64, 65, 100 and 256 rows at ctx 0, 1,
    BS - 1, BS and values that are no multiple of 64, a dead chunk."""
    return [("ck", 0, 1), ("ck", 1, 15), ("ck", BS - 1, 16), ("ck", BS, 17),
            ("ck", 100, 63), ("ck", 37, 64), ("ck", 1037, 65),
            ("ck", 0, 100), ("ck", 130, 256), ("ck", 5, 0),
            ("ck", 0, 256)]


def mixed_segs(BS, decode_first):
    """Decode rows (one past a 64-key tile, a long one, a dead slot) and
    chunks, interleaved in either order."""
    dec = [("dec", 1), ("dec", 65), ("dec", 1500), ("dec", 0), ("dec", BS)]
    ck = chunk_segs(BS)
    out = []
    for i in range(max(len(dec), len(ck))):
        pair = ([dec[i]] if i < len(dec) else []) + (
            [ck[i]] if i < len(ck) else [])
        out += pair if decode_first else pair[::-1]
    return out


def _operands(cuda, segs, C, H, Hkv, Dh, BS, dtype, int8, alias):
    from repro_torch.models.attention import quantize_kv
    q, kp, vp, bt, ctx, seg, tags = paged_case(segs, C, H, Hkv, Dh, BS,
                                               seed=11, alias=alias)
    qd = torch.from_numpy(q).to(cuda, dtype)
    if int8:
        (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(a).to(cuda))
                              for a in (kp, vp))
        pools, scales = (kq, vq), (ks, vs)
    else:
        pools = tuple(torch.from_numpy(a).to(cuda, dtype) for a in (kp, vp))
        scales = ()
    ints = [torch.from_numpy(a).to(cuda) for a in (bt, ctx, seg, tags)]
    return qd, pools, scales, ints


def _padding_zero(out, segs):
    for i, sg in enumerate(segs):
        live = (1 if sg[1] > 0 else 0) if sg[0] == "dec" else sg[2]
        assert not out[i, live:].float().abs().sum().item(), \
            f"segment {i} {sg}: padding rows not zero"


@pytest.mark.gpu
@pytest.mark.parametrize("mode,tol", [("bfloat16", 5e-3), ("float32", 1e-4),
                                      ("int8", 5e-3)])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("decode_first", [True, False])
def test_cuda_fused_matches_plain(cuda, mode, tol, shape, decode_first):
    """The fused kernel (bf16 and int8 pools on the tensor-core path; f32
    and G 20 or BS 6 bf16 on the CUDA-core walk) == its plain version:
    chunks of 1..256 rows at ctx 0, 1, BS - 1, BS and off the 64-key grid,
    decode rows, dead segments, two segments sharing blocks, decode and
    chunk segments interleaved; padding rows zero; one launch; a second
    call, with a grid decode call on the same stream between, gives the
    same output (the shared arrival counts reset)."""
    H, Hkv, Dh, BS = shape
    segs = mixed_segs(BS, decode_first)
    alias = (2, 4, 2) if decode_first else (3, 5, 2)
    dtype = torch.float32 if mode == "float32" else torch.bfloat16
    qd, pools, scales, ints = _operands(cuda, segs, 256, H, Hkv, Dh, BS,
                                        dtype, mode == "int8", alias)
    counter = "INT8_LAUNCHES" if scales else "LAUNCHES"
    launches = getattr(tk, counter)
    out = tk.paged_mixed_attention(qd, *pools, *ints, *scales)
    torch.cuda.synchronize()
    assert getattr(tk, counter) == launches + 1
    plain = tk.paged_mixed_attention_plain(qd, *pools, *ints, *scales)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                               rtol=tol)
    _padding_zero(out, segs)
    if H // Hkv <= 16 and not scales:
        lens = torch.tensor([900, 0, 33], dtype=torch.int32, device=cuda)
        dk.paged_decode_attention(qd[:3, 0].contiguous(), *pools,
                                  ints[0][:3].contiguous(), lens)
    again = tk.paged_mixed_attention(qd, *pools, *ints, *scales)
    assert torch.equal(again, out)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,tol", [("bfloat16", 5e-3), ("float32", 1e-4),
                                      ("int8", 5e-3)])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_fused_decode_only_and_one_row_chunks(cuda, mode, tol, shape):
    """C = 1 (every decode step of the engine): decode rows of 1..3300
    tokens, a dead slot, and one-row chunks, held to the plain version."""
    H, Hkv, Dh, BS = shape
    segs = [("dec", 24), ("dec", 3300), ("ck", 0, 1), ("dec", 0),
            ("dec", 650), ("ck", 77, 1), ("dec", 770), ("dec", BS + 1)]
    dtype = torch.float32 if mode == "float32" else torch.bfloat16
    qd, pools, scales, ints = _operands(cuda, segs, 1, H, Hkv, Dh, BS, dtype,
                                        mode == "int8", (4, 6, 10))
    out = tk.paged_mixed_attention(qd, *pools, *ints, *scales)
    torch.cuda.synchronize()
    plain = tk.paged_mixed_attention_plain(qd, *pools, *ints, *scales)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                               rtol=tol)
    assert not out[3].float().abs().max().item()
    assert torch.equal(tk.paged_mixed_attention(qd, *pools, *ints, *scales),
                       out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 5e-3),
                                       ("float32", 1e-4)])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_chunked_prefill_matches_plain(cuda, dtype, tol, shape):
    """The chunked paged prefill kernel (bf16 on the tensor-core walk,
    BS 6 and f32 on the CUDA-core walk) == its plain version over chunks
    of 1..256 rows at ctx 0, 1, BS - 1, BS and off the 64-key grid, a dead
    chunk and two chunks sharing blocks; padding rows zero; one launch."""
    H, Hkv, Dh, BS = shape
    segs = chunk_segs(BS)
    qd, pools, _, ints = _operands(cuda, segs, 256, H, Hkv, Dh, BS,
                                   getattr(torch, dtype), False, (1, 8, 1))
    launches = pk.LAUNCHES
    out = pk.paged_prefill_attention(qd, *pools, *ints[:3])
    torch.cuda.synchronize()
    assert pk.LAUNCHES == launches + 1
    plain = pk.paged_prefill_attention_plain(qd, *pools, *ints[:3])
    torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                               rtol=tol)
    _padding_zero(out, segs)
    assert torch.equal(pk.paged_prefill_attention(qd, *pools, *ints[:3]),
                       out)
