"""The contiguous decode kernel (#5, padded and ragged) and the flat paged
decode kernel (#2) on the split-KV ring tile (``csrc/split_decode.cuh``)
vs the JAX reference.

On the CPU: the contiguous split plan's invariants over a sweep of shapes
and SM counts; and, for each kernel, a model in plain torch of the way its
CUDA version cuts the work (#5: splits of the padded or ragged computed
keys, keys at or past the length scored -1e30 and every walked key
counted, counted splits merged in order; #2: runs of the flat work list,
a part per request a run holds, parts merged in order), held against the
Pallas kernel in interpret mode (f32 2e-5, bf16 2e-2): the reference's
decode sweep and the edge case of ``test_torch_contiguous_kernels.py``
(the padded length-0 row's mean included), runs crossing request
boundaries at every offset of ``ITEMS_PER_RUN``, padding items, the pow2
and worst-case buckets; the model's count of parts per request equals one
counted from ``flat_work_list`` independently. The ``gpu``-marked tests
hold each CUDA kernel against its plain version on the card (f32 1e-4,
bf16 5e-3); JAX is imported by the CPU tests only."""
import inspect
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import mixed_attention as tk  # noqa: E402
from repro_torch.kernels.ops import NEG_INF, flat_work_list  # noqa: E402
from test_torch_contiguous_kernels import (DECODE_SWEEP, EDGE,  # noqa: E402
                                           _decode_inputs)
from test_torch_flat_attention import paged_case  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BS = 16


@pytest.fixture(scope="module")
def jx():
    """The JAX reference kernels."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention import (decode_attention,
                                                paged_decode_attention_flat)
    return types.SimpleNamespace(jnp=jnp, decode=decode_attention,
                                 flat=paged_decode_attention_flat)


def _to(jx, arrays, dtype):
    """(jax arrays, torch tensors) of numpy inputs, floats in ``dtype``."""
    jdt, tdt = getattr(jx.jnp, dtype), getattr(torch, dtype)
    js = [jx.jnp.asarray(a, jdt if a.dtype == np.float32 else None)
          for a in arrays]
    ts = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
          else torch.from_numpy(a) for a in arrays]
    return js, ts


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _part(q, k, v, live):
    """One span's unnormalised state in f32: q [Hkv, G, Dh], its keys
    k, v [n, Hkv, Dh]; keys with ``live`` False score NEG_INF. The running
    max starts at NEG_INF, so a span with no live key weighs each of its
    keys exp(0) = 1."""
    s = torch.einsum("hgd,nhd->hgn", q, k) / math.sqrt(q.shape[-1])
    s = torch.where(live, s, NEG_INF)
    m = s.amax(-1).clamp(min=NEG_INF)
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.einsum("hgn,nhd->hgd", p, v)


def _merge(parts):
    """The parts of one (row, every kv head) merged in order: acc / l."""
    if len(parts) == 1:
        m, l, acc = parts[0]
        return acc / torch.where(l == 0, 1.0, l)[..., None]
    m = torch.stack([p[0] for p in parts])
    mx = m.amax(0)
    w = torch.exp(m - mx)
    l = (w * torch.stack([p[1] for p in parts])).sum(0)
    acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    return acc / torch.where(l == 0, 1.0, l)[..., None]


# --------------------------------------------------------------------------
# #5: the contiguous split plan and the split-then-merge model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B", [1, 3, 16, 128, 512])
@pytest.mark.parametrize("S,block_s", [(100, 64), (128, 128), (1000, 512),
                                       (10000, 512), (50000, 512),
                                       (50000, 50000), (7, 7)])
@pytest.mark.parametrize("Hkv", [1, 8])
@pytest.mark.parametrize("sms", [8, 132])
def test_contiguous_split_plan(B, S, block_s, Hkv, sms):
    """Splits [s*keys, (s+1)*keys) cover the nj*block_s padded keys once,
    none empty; keys are whole tiles and at least SPLIT_MIN_KEYS (or all
    of them); one split per (request, kv head) once B*Hkv blocks fill the
    CONTIG_BLOCKS_PER_SM * sms the card holds at once, and never more
    blocks than that wave otherwise; n <= MAX_SPLITS."""
    n, keys = dk.contiguous_split_plan(B, S, Hkv, block_s, sms)
    total = -(-S // block_s) * block_s
    covered = np.zeros(total, np.int64)
    for s in range(n):
        lo, hi = s * keys, min((s + 1) * keys, total)
        assert lo < hi, "empty split"
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert 1 <= n <= dk.MAX_SPLITS
    assert keys % dk.TILE_KEYS == 0
    assert keys >= min(dk.SPLIT_MIN_KEYS, total)
    wave = dk.CONTIG_BLOCKS_PER_SM * sms
    want = min(dk.MAX_SPLITS, max(1, wave // (B * Hkv)))
    if B * Hkv >= wave:
        assert n == 1
    else:
        assert n * B * Hkv <= wave
    # no more splits than fill one wave, each no longer than it must be
    assert n <= want
    assert keys < max(dk.SPLIT_MIN_KEYS, -(-total // want)) + dk.TILE_KEYS


def test_contiguous_split_plan_reads_shapes_only():
    """The plan takes host shapes and the SM count, nothing on the device,
    and returns host ints."""
    params = list(inspect.signature(dk.contiguous_split_plan).parameters)
    assert params == ["B", "S", "Hkv", "block_s", "sms"]
    n, keys = dk.contiguous_split_plan(2, 50000, 8, 512, 132)
    assert type(n) is int and type(keys) is int and n > 1


def contiguous_model(q, k, v, lengths, block_s, ragged, n, keys):
    """#5's partition in plain torch, f32: split s of each (request, kv
    head) walks keys [s*keys, (s+1)*keys) of the computed ones (every
    padded row, or the blocks below the length when ragged); rows at or
    past S are zeros; keys at or past the length score NEG_INF; splits
    past the computed keys are not counted; the rest are merged in
    order. A ragged length-0 row is zeros."""
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    bs = min(block_s, S)
    nj = -(-S // bs)
    assert n * keys >= nj * bs
    pad = (0, 0, 0, 0, 0, nj * bs - S)
    kp = torch.nn.functional.pad(k.float(), pad)
    vp = torch.nn.functional.pad(v.float(), pad)
    out = torch.zeros(B, Hkv, G, Dh)
    for b in range(B):
        L = max(int(lengths[b]), 0)
        end = min(nj, -(-L // bs)) * bs if ragged else nj * bs
        parts = []
        for s in range(n):
            lo, hi = s * keys, min((s + 1) * keys, end)
            if lo >= end:
                break
            live = (torch.arange(lo, hi) < L)
            parts.append(_part(q[b].float().reshape(Hkv, G, Dh), kp[b, lo:hi],
                               vp[b, lo:hi], live))
        if parts:
            out[b] = _merge(parts)
    return out.reshape(B, H, Dh)


def _plans(B, S, Hkv, blk):
    """The planned split at 132 SMs, and splits as short as the kernel's
    merge takes: one tile each, or whole tiles for MAX_SPLITS splits."""
    bs = min(blk, S)
    total = -(-S // bs) * bs
    tiles = -(-total // dk.TILE_KEYS)
    keys = -(-tiles // dk.MAX_SPLITS) * dk.TILE_KEYS
    return [dk.contiguous_split_plan(B, S, Hkv, bs, 132),
            (-(-total // keys), keys)]


@pytest.mark.parametrize("B,S,H,Hkv,Dh,blk", DECODE_SWEEP)
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_split_model_matches_jax_kernel(jx, B, S, H, Hkv, Dh, blk,
                                                   ragged, dtype):
    arrays = _decode_inputs(B, S, H, Hkv, Dh)
    (jq, jk, jv, jl), (q, k, v, lengths) = _to(jx, arrays, dtype)
    want = _f32(jx.decode(jq, jk, jv, jl, block_s=blk, ragged=ragged,
                          interpret=True))
    plans = _plans(B, S, Hkv, blk)
    assert max(n for n, _ in plans) > 1
    for n, keys in plans:
        got = contiguous_model(q, k, v, lengths, blk, ragged, n, keys)
        np.testing.assert_allclose(_f32(got), want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_split_model_matches_jax_kernel_at_the_edges(jx, ragged,
                                                                dtype):
    """A length-0 row (the padded mean over all 128 padded rows, zero rows
    included, or zeros when ragged: its splits each sum V at weight 1 and
    the merge weighs them alike), rows ending inside and at a block edge,
    a cache of 100 rows in blocks of 64."""
    e = EDGE
    arrays = _decode_inputs(e["B"], e["S"], e["H"], e["Hkv"], e["Dh"],
                            e["lengths"], seed=1)
    (jq, jk, jv, jl), (q, k, v, lengths) = _to(jx, arrays, dtype)
    want = _f32(jx.decode(jq, jk, jv, jl, block_s=e["blk"], ragged=ragged,
                          interpret=True))
    for n, keys in _plans(e["B"], e["S"], e["Hkv"], e["blk"]) + [(1, 128)]:
        got = _f32(contiguous_model(q, k, v, lengths, e["blk"], ragged, n,
                                    keys))
        np.testing.assert_allclose(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])
        if ragged:
            assert not got[0].any()
        else:
            mean = _f32(v)[0].sum(0) / 128
            np.testing.assert_allclose(
                got[0], np.repeat(mean, e["H"] // e["Hkv"], 0),
                atol=TOL[dtype], rtol=TOL[dtype])


# --------------------------------------------------------------------------
# #2: runs of the flat work list, parts merged by the last
# --------------------------------------------------------------------------
def flat_model(q, kp, vp, bt, lengths, work, ipr):
    """#2's partition in plain torch, f32, following the kernel's control
    flow: runs of ``ipr`` items; at each real item that starts a segment,
    the request's first item is ``w - blk`` and its items end
    ``ceil(L/BS)`` later; the segment walks the keys of its items in this
    run and is part ``w // ipr - first // ipr`` of the request's
    ``(end - 1) // ipr - first // ipr + 1``; padding items (block NBT) do
    nothing. Returns the output (dead slots zeros) and the parts per
    request."""
    B, H, Dh = q.shape
    Hkv = kp.shape[2]
    G = H // Hkv
    work_req, work_blk = (x.numpy() for x in work)
    W = len(work_req)
    lens = lengths.numpy()
    parts, want = {}, {}
    for run in range(-(-W // ipr)):
        w, w_end = run * ipr, min(run * ipr + ipr, W)
        while w < w_end:
            b, blk = int(work_req[w]), int(work_blk[w])
            L = int(lens[b])
            if blk * BS >= L:
                w += 1
                continue
            first = w - blk
            end = first + -(-L // BS)
            w2 = min(w_end, end)
            lo, hi = blk * BS, min((blk + w2 - w) * BS, L)
            idx = torch.arange(lo, hi)
            rows = bt[b].long()[idx // BS] * BS + idx % BS
            k = kp.reshape(-1, Hkv, Dh)[rows].float()
            v = vp.reshape(-1, Hkv, Dh)[rows].float()
            j = w // ipr - first // ipr
            assert j not in parts.setdefault(b, {})
            parts[b][j] = _part(q[b].float().reshape(Hkv, G, Dh), k, v,
                                torch.ones(hi - lo, dtype=torch.bool))
            want[b] = (end - 1) // ipr - first // ipr + 1
            w = w2
    out = torch.zeros(B, Hkv, G, Dh)
    for b, got in parts.items():
        assert sorted(got) == list(range(want[b])), "parts of a request"
        out[b] = _merge([got[j] for j in range(want[b])])
    return out.reshape(B, H, Dh), want


def runs_per_request(work, lengths, ipr):
    """Runs of ``ipr`` items that hold a real item of each request, counted
    from the work list itself."""
    work_req, work_blk = (x.numpy() for x in work)
    runs = {}
    for w, (b, blk) in enumerate(zip(work_req, work_blk)):
        if blk * BS < lengths[b]:
            runs.setdefault(int(b), set()).add(w // ipr)
    return {b: len(r) for b, r in runs.items()}


# 128x spread, a dead slot, a one-key row, rows of 1..2 blocks
FLAT_LENS = [5, 130, 0, 640, 1, 33, 47]


def flat_case(H, Hkv, Dh, offset, lens=FLAT_LENS, seed=7):
    """Lengths led by a row of ``offset`` blocks (a dead slot at 0), so
    every later request boundary moves by ``offset`` items."""
    lens = [offset * BS] + list(lens)
    rng, kp, vp, bt = paged_case(lens, H, Hkv, Dh, BS, seed=seed)
    q = rng.normal(0, 1, (len(lens), H, Dh)).astype(np.float32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("offset", range(dk.ITEMS_PER_RUN))
@pytest.mark.parametrize("ipr", [dk.ITEMS_PER_RUN, 3])
def test_flat_run_model_matches_jax_kernel(jx, offset, ipr):
    """Runs crossing request boundaries at every offset, with padding items
    (pow2 bucket) and the worst-case bucket: the model == the Pallas flat
    kernel on live rows, dead slots zeros, and each request's parts ==
    the runs its items touch, counted from the work list."""
    H, Hkv, Dh = 6, 2, 64
    arrays = flat_case(H, Hkv, Dh, offset)
    lens = arrays[-1]
    (jq, jk, jv, jbt, jl), (q, kp, vp, bt, lengths) = _to(jx, arrays,
                                                          "float32")
    real = sum(-(-int(n) // BS) for n in lens)
    live = lens > 0
    for num_work in (1 << (real - 1).bit_length(), bt.numel()):
        want = _f32(jx.flat(jq, jk, jv, jbt, jl, num_work=num_work,
                            interpret=True))
        work = flat_work_list(lengths, bt.shape[1], BS, num_work)
        got, parts = flat_model(q, kp, vp, bt, lengths, work, ipr)
        np.testing.assert_allclose(_f32(got)[live], want[live],
                                   atol=TOL["float32"], rtol=TOL["float32"])
        assert not _f32(got)[~live].any()
        assert parts == runs_per_request(work, lens, ipr)
        assert max(parts.values()) > 1


@pytest.mark.parametrize("nbt", [1, 8, 512, 2040, 2041, 70000])
def test_items_per_run_keeps_parts_within_the_merge(nbt):
    """A request over a whole table of ``nbt`` entries makes at most
    MAX_SPLITS parts, from any first item."""
    ipr = dk.items_per_run(nbt)
    assert ipr >= dk.ITEMS_PER_RUN
    worst = max((f + nbt - 1) // ipr - f // ipr + 1 for f in range(ipr))
    assert worst <= dk.MAX_SPLITS
    assert -(-nbt // ipr) + 1 <= dk.MAX_SPLITS


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


def _arrivals_zero(device):
    """The stream's arrival counts (of a CUDA tensor's ``device``) all 0."""
    stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    return not dk.arrival_counts(device, stream, 1).any().item()


# (B, S, block_s, lengths): lengths 0, 1, block_s, S and off the blocks in
# a cache that is not whole blocks; one row of 50000 keys (split); B 512
CONTIG_GPU = {
    "edges": (6, 1000, 512, [0, 1, 512, 1000, 700, 999]),
    "long_b1": (1, 50000, 512, [50000]),
    "long_b3": (3, 50000, 512, [49999, 0, 1]),
    "b512": (512, 600, 256, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 12, 16])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("case", list(CONTIG_GPU))
def test_cuda_contiguous_decode_matches_plain(cuda, dtype, tol, G, Dh, case):
    """The built contiguous decode kernel == its plain version on the card,
    padded and ragged, one launch each; two calls give the same bits and
    the arrival counts are back at 0."""
    B, S, blk, lens = CONTIG_GPU[case]
    Hkv = 2 if G > 4 or case.startswith("long") else 4
    if case == "b512" and (G > 4 or Dh == 64):
        pytest.skip("B 512 at G <= 4, Dh 128 only (memory and time)")
    if lens is None:
        lens = np.random.default_rng(3).integers(0, S + 1, B)
        lens[:3] = [0, 1, S]
    dt = getattr(torch, dtype)
    arrays = _decode_inputs(B, S, G * Hkv, Hkv, Dh, lens, seed=5)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in arrays[:3])
    lengths = torch.from_numpy(arrays[3]).to(cuda)
    for ragged in (False, True):
        counter = "RAGGED_LAUNCHES" if ragged else "PADDED_LAUNCHES"
        launches = getattr(dk, counter)
        out = dk.decode_attention(q, k, v, lengths, block_s=blk,
                                  ragged=ragged)
        torch.cuda.synchronize()
        assert getattr(dk, counter) == launches + 1
        plain = dk.decode_attention_plain(q, k, v, lengths, block_s=blk,
                                          ragged=ragged)
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
        assert math.isfinite(out.float().abs().max().item())
        assert torch.equal(dk.decode_attention(q, k, v, lengths,
                                               block_s=blk, ragged=ragged),
                           out)
        assert _arrivals_zero(out.device)
        if ragged:                          # a length-0 row is zeros
            assert not out[lengths == 0].float().abs().sum().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
@pytest.mark.parametrize("G,Dh", [(1, 128), (3, 128), (10, 64), (16, 64)])
@pytest.mark.parametrize("offset", [0, 3, dk.ITEMS_PER_RUN - 1])
def test_cuda_flat_decode_ring_matches_plain(cuda, dtype, tol, G, Dh,
                                             offset):
    """The built flat kernel == its plain version on the card, runs
    crossing request boundaries, with the pow2 and the worst-case bucket:
    one launch a call, dead slots exactly 0, two calls bit-equal, and the
    arrival counts back at 0 after each call, also after a grid and a
    fused call on the same stream."""
    Hkv = 2
    dt = getattr(torch, dtype)
    q, kp, vp, bt, lens = flat_case(G * Hkv, Hkv, Dh, offset)
    floats = [torch.from_numpy(a).to(cuda, dt) for a in (q, kp, vp)]
    ints = [torch.from_numpy(a).to(cuda) for a in (bt, lens)]
    real = sum(-(-int(n) // BS) for n in lens)
    plain = dk.paged_decode_attention_flat_plain(*floats, *ints)
    for num_work in (1 << (real - 1).bit_length(), None):
        launches = dk.LAUNCHES
        out = dk.paged_decode_attention_flat(*floats, *ints,
                                             num_work=num_work)
        torch.cuda.synchronize()
        assert dk.LAUNCHES == launches + 1
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
        assert not out[ints[1] == 0].float().abs().max().item()
        assert _arrivals_zero(out.device)
        assert torch.equal(dk.paged_decode_attention_flat(
            *floats, *ints, num_work=num_work), out)
        dk.paged_decode_attention(*floats, *ints)
        if dt == torch.bfloat16:
            one = torch.ones_like(ints[1])
            tk.paged_mixed_attention(
                floats[0][:, None].contiguous(), floats[1], floats[2],
                ints[0], (ints[1] - one).clamp(min=0),
                (ints[1] > 0).to(torch.int32), torch.zeros_like(one))
        assert _arrivals_zero(out.device)
        assert torch.equal(dk.paged_decode_attention_flat(
            *floats, *ints, num_work=num_work), out)
