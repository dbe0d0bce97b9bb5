"""The port's contiguous decode and prefill kernels (``decode_attention``,
padded and ragged, and ``prefill_attention``) vs the JAX reference.

On the CPU each wrapper runs its plain PyTorch version, held against the
Pallas kernel in interpret mode (f32 2e-5, bf16 2e-2, as
``tests/test_kernels.py``) over the reference's decode sweep, plus rows of
length 0 and caches whose length is not a multiple of the block, where
the kernels and the ``ref.py`` oracle part ways; prefill at T not a
multiple of the tiles and lengths below T, every row compared. The port's
``ref.py`` oracles and ``api`` entry points match the JAX ones (``ref``,
``ops``). The ``gpu``-marked tests hold each CUDA kernel against its plain
version on the card; JAX is imported by the CPU tests only."""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels import prefill_attention as pk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference kernels, oracles and ops."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention
    from repro.kernels.prefill_attention import prefill_attention
    return types.SimpleNamespace(jnp=jnp, decode=decode_attention,
                                 prefill=prefill_attention, ref=jref,
                                 ops=jops)


def _decode_inputs(B, S, H, Hkv, Dh, lengths=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, Dh)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, Hkv, Dh)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, Hkv, Dh)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, B)
    return q, k, v, np.asarray(lengths, np.int32)


def _both(jx, arrays, dtype):
    """(jax arrays, torch tensors) of the same numpy inputs; floats in
    ``dtype``, int32 arrays as they are."""
    jdt = getattr(jx.jnp, dtype)
    tdt = getattr(torch, dtype)
    js = [jx.jnp.asarray(a, jdt if a.dtype == np.float32 else None)
          for a in arrays]
    ts = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
          else torch.from_numpy(a) for a in arrays]
    return js, ts


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# the reference's sweep (tests/test_kernels.py:25-31): B, S, H, Hkv, Dh, block
DECODE_SWEEP = [
    (1, 128, 4, 4, 64, 64),
    (2, 256, 8, 2, 64, 64),
    (4, 256, 8, 1, 128, 128),
    (3, 512, 16, 4, 128, 256),
    (2, 128, 10, 5, 64, 32),
]


@pytest.mark.parametrize("B,S,H,Hkv,Dh,blk", DECODE_SWEEP)
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_kernel(jx, B, S, H, Hkv, Dh, blk, ragged,
                                         dtype):
    arrays = _decode_inputs(B, S, H, Hkv, Dh)
    (jq, jk, jv, jl), (q, k, v, lengths) = _both(jx, arrays, dtype)
    want = jx.decode(jq, jk, jv, jl, block_s=blk, ragged=ragged,
                     interpret=True)
    launches = (dk.PADDED_LAUNCHES, dk.RAGGED_LAUNCHES)
    got = dk.decode_attention(q, k, v, lengths, block_s=blk, ragged=ragged)
    assert (dk.PADDED_LAUNCHES, dk.RAGGED_LAUNCHES) == launches
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


# a length-0 row, a full row, rows ending inside and at a block edge, and
# a cache of 100 rows in blocks of 64 (padded to 128 with zero rows)
EDGE = dict(B=5, S=100, H=6, Hkv=2, Dh=64, blk=64,
            lengths=[0, 100, 37, 64, 1])


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_kernel_at_the_edges(jx, ragged, dtype):
    """Every row, the length-0 one included, equals the Pallas kernel's:
    zeros when ragged; when padded, the mean of V over all 128 padded rows
    (zero rows included), which is not the oracle's uniform mean over the
    100 real ones."""
    e = EDGE
    arrays = _decode_inputs(e["B"], e["S"], e["H"], e["Hkv"], e["Dh"],
                            e["lengths"], seed=1)
    (jq, jk, jv, jl), (q, k, v, lengths) = _both(jx, arrays, dtype)
    want = _f32(jx.decode(jq, jk, jv, jl, block_s=e["blk"], ragged=ragged,
                          interpret=True))
    got = _f32(dk.decode_attention(q, k, v, lengths, block_s=e["blk"],
                                   ragged=ragged))
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    G = e["H"] // e["Hkv"]
    if ragged:
        assert not got[0].any()
    else:
        mean = _f32(v)[0].sum(0) / 128                     # [Hkv, Dh]
        np.testing.assert_allclose(got[0], np.repeat(mean, G, 0),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    oracle = _f32(ref.decode_attention_ref(q, k, v, lengths))
    np.testing.assert_allclose(got[1:], oracle[1:], atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("T,bq,bk", [(100, 32, 32), (77, 64, 32)])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
def test_prefill_plain_matches_jax_kernel(jx, T, bq, bk, H, Hkv):
    """T not a multiple of the tiles, lengths T, T - 37 and 0: every row
    (rows past the length attend the first ``length`` keys; the length-0
    row is zeros) equals the Pallas kernel's."""
    B, Dh = 3, 64
    rng = np.random.default_rng(2)
    arrays = [rng.normal(0, 1, (B, T, n, Dh)).astype(np.float32)
              for n in (H, Hkv, Hkv)] + [np.asarray([T, T - 37, 0],
                                                    np.int32)]
    (jq, jk, jv, jl), (q, k, v, lengths) = _both(jx, arrays, "float32")
    want = _f32(jx.prefill(jq, jk, jv, jl, block_q=bq, block_k=bk,
                           interpret=True))
    launches = pk.CONTIG_LAUNCHES
    got = _f32(pk.prefill_attention(q, k, v, lengths))
    assert pk.CONTIG_LAUNCHES == launches
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert not got[2].any()
    # no lengths: every key up to the row's own position
    want = _f32(jx.prefill(jq, jk, jv, block_q=bq, block_k=bk,
                           interpret=True))
    np.testing.assert_allclose(_f32(pk.prefill_attention(q, k, v)), want,
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_oracles_match_jax(jx, dtype):
    arrays = _decode_inputs(3, 40, 8, 2, 64, [40, 7, 0], seed=3)
    js, ts = _both(jx, arrays, dtype)
    np.testing.assert_allclose(_f32(ref.decode_attention_ref(*ts)),
                               _f32(jx.ref.decode_attention_ref(*js)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    rng = np.random.default_rng(4)
    arrays = [rng.normal(0, 1, (2, 33, n, 64)).astype(np.float32)
              for n in (8, 2, 2)] + [np.asarray([33, 20], np.int32)]
    js, ts = _both(jx, arrays, dtype)
    for n in (4, 3):            # with and without lengths
        np.testing.assert_allclose(_f32(ref.prefill_attention_ref(*ts[:n])),
                                   _f32(jx.ref.prefill_attention_ref(
                                       *js[:n])),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("backend,jbackend", [("ref", "xla"),
                                              ("kernel", "pallas")])
def test_ops_entry_points_match_jax(jx, backend, jbackend):
    """``api.decode_attention`` (both modes) and ``api.prefill_attention``
    on each backend == the JAX ``ops`` twin on its counterpart (whose
    16-row TPU tiles change only the order of its sums)."""
    arrays = _decode_inputs(3, 96, 8, 2, 64, [96, 50, 3], seed=5)
    js, ts = _both(jx, arrays, "float32")
    for ragged in (False, True):
        got = api.decode_attention(*ts, backend=backend, ragged=ragged,
                                   block_s=32)
        want = jx.ops.decode_attention(*js, backend=jbackend, ragged=ragged,
                                       block_s=32)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5,
                                   rtol=2e-5)
    rng = np.random.default_rng(6)
    arrays = [rng.normal(0, 1, (2, 48, n, 64)).astype(np.float32)
              for n in (4, 2, 2)] + [np.asarray([48, 30], np.int32)]
    js, ts = _both(jx, arrays, "float32")
    got = api.prefill_attention(*ts, backend=backend)
    want = jx.ops.prefill_attention(*js, backend=jbackend, block_q=16,
                                    block_k=16)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="backend"):
        api.prefill_attention(*ts, backend="pallas")


def test_decode_kv_rows_reads_the_mapped_cache_rows():
    """``kv_rows`` maps each query row to a row of a larger cache (a
    serving slab): the result is the one over the gathered rows, padded
    and ragged, and the cache is not written."""
    arrays = _decode_inputs(7, 96, 8, 2, 64, [0, 96, 50, 3, 1, 64, 10],
                            seed=9)
    q, k, v, lengths = (torch.from_numpy(a) for a in arrays)
    rows = torch.tensor([6, 0, 3], dtype=torch.int32)
    before = k.clone()
    for ragged in (False, True):
        got = dk.decode_attention(q[:3], k, v, lengths[:3], block_s=32,
                                  ragged=ragged, kv_rows=rows)
        want = dk.decode_attention(q[:3], k[rows.long()], v[rows.long()],
                                   lengths[:3], block_s=32, ragged=ragged)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(k, before, rtol=0, atol=0)


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor on neither the CPU nor a CUDA card gets no kernel and no
    plain version: the wrapper raises."""
    meta = torch.device("meta")
    q = torch.empty(2, 4, 64, device=meta)
    kv = torch.empty(2, 16, 2, 64, device=meta)
    lengths = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        dk.decode_attention(q, kv, kv, lengths)
    with pytest.raises(ValueError, match="no kernel"):
        pk.prefill_attention(torch.empty(2, 16, 4, 64, device=meta), kv, kv,
                             lengths)


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
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_decode_matches_plain(cuda, dtype, tol, ragged):
    """The built contiguous decode kernel == its plain version on the
    card, length-0 rows and a cache that is not whole blocks included, at
    llama3.2-3b heads (G 3, Dh 128) and at G 10 / Dh 64 (two rows a
    thread)."""
    dt = getattr(torch, dtype)
    for H, Hkv, Dh, S, blk in ((24, 8, 128, 1000, 512), (20, 2, 64, 300, 64)):
        arrays = _decode_inputs(6, S, H, Hkv, Dh, [0, S, 37, blk, 1, 700 % S])
        q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in arrays[:3])
        lengths = torch.from_numpy(arrays[3]).to(cuda)
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


# (H, Hkv, Dh, T): llama3.2-3b heads and G 4 / Dh 64, then the tensor-core
# tiles' edges: T around the 64-key tile and the 128-row tile, G 1, 3, 4
PREFILL_GPU_SHAPES = [(24, 8, 128, 300), (8, 2, 64, 77)] + [
    (2 * G, 2, Dh, T) for T in (1, 63, 64, 65, 129, 300, 1000)
    for G in (1, 3, 4) for Dh in (64, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
@pytest.mark.parametrize("H,Hkv,Dh,T", PREFILL_GPU_SHAPES)
def test_cuda_prefill_matches_plain(cuda, dtype, tol, H, Hkv, Dh, T):
    """The built contiguous prefill kernel == its plain version on the
    card at lengths T, T - 1, 0, 1 and T - 37: rows past the length and a
    length-0 row (zeros) included."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (5, T, n, Dh)).astype(
        np.float32)).to(cuda, dt) for n in (H, Hkv, Hkv))
    lengths = torch.tensor([T, T - 1, 0, 1, max(T - 37, 0)],
                           dtype=torch.int32, device=cuda)
    launches = pk.CONTIG_LAUNCHES
    out = pk.prefill_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert pk.CONTIG_LAUNCHES == launches + 1
    plain = pk.prefill_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                               rtol=tol)
    assert not out[2].float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
def test_cuda_decode_kv_rows_matches_plain(cuda, dtype, tol):
    """The slab engine's call: query rows over rows 6, 0 and 3 of a
    7-row cache (llama3.2-3b heads, S 1000, padded; few rows, so the split
    plan cuts each into several splits): the kernel == its plain version,
    which gathers the rows first."""
    dt = getattr(torch, dtype)
    arrays = _decode_inputs(7, 1000, 24, 8, 128,
                            [5, 1000, 0, 37, 512, 1, 999], seed=11)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in arrays[:3])
    rows = torch.tensor([6, 0, 3], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([999, 5, 37], dtype=torch.int32, device=cuda)
    launches = dk.PADDED_LAUNCHES
    out = dk.decode_attention(q[:3], k, v, lengths, kv_rows=rows)
    torch.cuda.synchronize()
    assert dk.PADDED_LAUNCHES == launches + 1
    plain = dk.decode_attention_plain(q[:3], k, v, lengths, kv_rows=rows)
    torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
def test_cuda_prefill_whole_prompt_bucket(cuda, dtype, tol):
    """The contiguous prefill kernel as an 8192-token engine's
    whole-prompt prefill calls it at its largest pow2 bucket: B 1,
    T 8192, llama3.2-3b heads, no lengths."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 8192, n, 128)).astype(
        np.float32)).to(cuda, dt) for n in (24, 8, 8))
    launches = pk.CONTIG_LAUNCHES
    out = pk.prefill_attention(q, k, v)
    torch.cuda.synchronize()
    assert pk.CONTIG_LAUNCHES == launches + 1
    plain = pk.prefill_attention_plain(
        q, k, v, torch.full((1,), 8192, dtype=torch.int32, device=cuda))
    torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                               rtol=tol)
