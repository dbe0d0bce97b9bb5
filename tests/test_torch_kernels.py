"""The port's fused mixed-attention kernel module vs the JAX reference
(its int8 mode's CPU tests are in ``tests/test_torch_int8.py``).

On the CPU the wrapper runs its plain PyTorch version, which is held
against the Pallas kernel in interpret mode on the mixed case of
``tests/test_fused_attention.py`` (interleaved tags, a dead slot, two
decode rows sharing a prefix block, 128x context spread). The
``gpu``-marked test holds the CUDA kernel against the plain version on
the card. JAX is imported by the CPU tests only, so the ``gpu`` test also
runs where JAX is not installed."""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mixed_attention as tk  # noqa: E402
from repro_torch.kernels.ops import flat_work_list  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    """The JAX reference functions."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.mixed_attention import paged_mixed_attention
    from repro.kernels.ops import flat_work_list as jax_flat_work_list
    return types.SimpleNamespace(jnp=jnp, mixed=paged_mixed_attention,
                                 flat_work_list=jax_flat_work_list)

# interleaved tags, 128x total-context spread (4..512), a dead slot, and
# two decode rows sharing their first prefix block
SEGS = [("dec", 4), ("ck", 48, 17), ("dec", 512), ("dec", 0),
        ("ck", 0, 23), ("dec", 65), ("dec", 77)]
ALIAS = (5, 6, 1)          # segs 5 and 6 share physical block 0


def mixed_case(segs, C, H, Hkv, Dh, BS, seed=23, alias=None):
    """Numpy operands of one mixed iteration. ``("dec", L)`` is a decode
    row whose cache holds L tokens (L = 0: dead slot); ``("ck", ctx,
    clen)`` a prefill chunk. ``alias=(i, j, nb)``: segments i and j share
    their first ``nb`` physical blocks."""
    rng = np.random.default_rng(seed)
    B = len(segs)
    totals = [(s[1] if s[0] == "dec" else s[1] + s[2]) for s in segs]
    NBT = max(max(-(-t // BS) for t in totals), 1) + 1
    NB = sum(-(-t // BS) for t in totals) + 3
    perm = rng.permutation(NB)
    k_pool = np.zeros((NB, BS, Hkv, Dh), np.float32)
    v_pool = np.zeros_like(k_pool)
    bt = np.full((B, NBT), NB - 1, np.int32)
    pi = 0
    for s, t in enumerate(totals):
        for j in range(-(-t // BS)):
            if alias and s == alias[1] and j < alias[2]:
                bt[s, j] = bt[alias[0], j]       # shared prefix block
                continue
            pb = int(perm[pi])
            pi += 1
            bt[s, j] = pb
            k_pool[pb] = rng.normal(0, 1, (BS, Hkv, Dh))
            v_pool[pb] = rng.normal(0, 1, (BS, Hkv, Dh))
    q = rng.normal(0, 1, (B, C, H, Dh)).astype(np.float32)
    ctx = np.asarray([s[1] - 1 if s[0] == "dec" else s[1] for s in segs],
                     np.int32)
    seg = np.asarray([1 if s[0] == "dec" else s[2] for s in segs], np.int32)
    tags = np.asarray([0 if s[0] == "dec" else 1 for s in segs], np.int32)
    return q, k_pool, v_pool, bt, ctx, seg, tags


def live_rows(seg, tags, i):
    return 1 if tags[i] == 0 else int(seg[i])


@pytest.mark.parametrize("H,Hkv,Dh", [(8, 2, 64), (6, 2, 128)])
def test_plain_matches_jax_kernel(ref, H, Hkv, Dh):
    """Plain PyTorch version == the Pallas kernel (interpret mode) on every
    live row, f32 within 3e-5; padding rows and the dead slot are zero."""
    C, BS = 32, 16
    q, kp, vp, bt, ctx, seg, tags = mixed_case(SEGS, C, H, Hkv, Dh, BS,
                                               alias=ALIAS)
    want = np.asarray(ref.mixed(
        *map(ref.jnp.asarray, (q, kp, vp, bt, ctx, seg, tags)),
        interpret=True), np.float32)
    dead = [i for i, s in enumerate(SEGS) if s == ("dec", 0)]
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, ctx, seg, tags)]
    launches = tk.LAUNCHES
    out = tk.paged_mixed_attention(*t).numpy()
    assert tk.LAUNCHES == launches          # the CPU never launches
    for i in range(len(SEGS)):
        n = 0 if i in dead else live_rows(seg, tags, i)
        np.testing.assert_allclose(out[i, :n], want[i, :n],
                                   atol=3e-5, rtol=3e-5)
        assert not out[i, n:].any(), f"segment {i}: padding rows not zero"


@pytest.mark.parametrize("lengths,num_work", [
    ([4, 65, 0, 512, 17], 64), ([4, 65, 0, 512, 17], 43),
    ([0, 0, 0], 4), ([16, 0, 33, 0], 8)])
def test_flat_work_list_matches_jax(ref, lengths, num_work):
    want = ref.flat_work_list(ref.jnp.asarray(lengths, ref.jnp.int32), 40,
                              16, num_work)
    out = flat_work_list(torch.tensor(lengths, dtype=torch.int32), 40, 16,
                         num_work)
    for r, o in zip(want, out):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_wrapper_refuses_devices_without_a_kernel():
    q = torch.empty((1, 1, 2, 64), device="meta")
    pool = torch.empty((2, 16, 1, 64), device="meta")
    ints = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.paged_mixed_attention(q, pool, pool, ints[:, None], ints, ints,
                                 ints)


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
def test_cuda_kernel_matches_plain(cuda, dtype, tol):
    """The built kernel == its plain version on the card, at llama3.2-3b
    head shapes (H 24, Hkv 8, Dh 128) and at Dh 64; several row tiles per
    chunk. f32 differs by summation order only; bf16 rounds its output."""
    dt = getattr(torch, dtype)
    for H, Hkv, Dh, C in ((24, 8, 128, 64), (8, 2, 64, 48)):
        q, kp, vp, bt, ctx, seg, tags = mixed_case(
            SEGS, C, H, Hkv, Dh, 16, alias=ALIAS)
        floats = [torch.from_numpy(a).to(cuda, dt) for a in (q, kp, vp)]
        ints = [torch.from_numpy(a).to(cuda) for a in (bt, ctx, seg, tags)]
        launches = tk.LAUNCHES
        out = tk.paged_mixed_attention(*floats, *ints)
        torch.cuda.synchronize()
        assert tk.LAUNCHES == launches + 1
        plain = tk.paged_mixed_attention_plain(*floats, *ints)
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
        assert math.isfinite(out.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
def test_cuda_int8_kernel_matches_plain(cuda, dtype, tol):
    """The int8 mode (int8 pools, f32 per-row scales, dequantized in
    registers) == its plain version on the card, at llama3.2-3b heads and
    at Dh 64; it counts on INT8_LAUNCHES, not LAUNCHES. The scales are
    amax/127 of each pool row, as quantize-on-write makes them."""
    from repro_torch.models.attention import quantize_kv
    dt = getattr(torch, dtype)
    for H, Hkv, Dh, C in ((24, 8, 128, 64), (8, 2, 64, 48)):
        q, kp, vp, bt, ctx, seg, tags = mixed_case(
            SEGS, C, H, Hkv, Dh, 16, alias=ALIAS)
        qd = torch.from_numpy(q).to(cuda, dt)
        (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(a).to(cuda))
                              for a in (kp, vp))
        ints = [torch.from_numpy(a).to(cuda) for a in (bt, ctx, seg, tags)]
        launches, int8_launches = tk.LAUNCHES, tk.INT8_LAUNCHES
        out = tk.paged_mixed_attention(qd, kq, vq, *ints, ks, vs)
        torch.cuda.synchronize()
        assert (tk.LAUNCHES, tk.INT8_LAUNCHES) == (launches,
                                                   int8_launches + 1)
        plain = tk.paged_mixed_attention_plain(qd, kq, vq, *ints, ks, vs)
        torch.testing.assert_close(out.float(), plain.float(), atol=tol,
                                   rtol=tol)
        assert math.isfinite(out.float().abs().max().item())
