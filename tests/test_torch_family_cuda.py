"""On the card: the attention kernels at the MoE and VLM configs' head
groupings (qwen3-moe-30b-a3b: 32 / 4 / Dh 64, G 8, and at the published
Dh 128; qwen2-vl-7b: 28 / 4 / Dh 128, G 7; block 16) and #5 / #6 at
whisper's (20 / 20 / Dh 64, G 1), each held to its plain version in bf16
(5e-3) and f32 (1e-4); ``moe_dense``, reduced MoE and VLM engines, reduced
zamba2 and whisper (prefill + greedy decode) and one training step on the
card against the CPU. Every test here needs a CUDA card and skips without
one; none imports JAX (the card's machine has none)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import mixed_attention as tk  # noqa: E402
from repro_torch.kernels import prefill_attention as pk  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mlp, synthetic_batch  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            init_adamw)
from repro_torch.training.trainer import make_train_step  # noqa: E402

BS = 16
# H, Hkv, Dh: qwen3-moe as the repo's config gives it (Dh 64) and at the
# published head width (Dh 128); qwen2-vl
HEADS = {"G8": (32, 4, 64), "G8_Dh128": (32, 4, 128), "G7": (28, 4, 128)}
TOLS = [(torch.bfloat16, 5e-3), (torch.float32, 1e-4)]


@pytest.fixture
def cuda():
    """The card, decided here (never at import or collection time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool(rng, totals, Hkv, DH):
    """Pools with one table row per total, blocks in a shuffled order;
    the last block is garbage."""
    NBT = max(-(-t // BS) for t in totals) + 1
    NB = sum(-(-t // BS) for t in totals) + 2
    perm = iter(rng.permutation(NB - 1))
    bt = np.full((len(totals), NBT), NB - 1, np.int32)
    for i, t in enumerate(totals):
        for j in range(-(-t // BS)):
            bt[i, j] = next(perm)
    k, v = (rng.normal(0, 1, (NB, BS, Hkv, DH)).astype(np.float32)
            for _ in range(2))
    return k, v, bt


def _to(cuda, dtype, *arrays):
    return [torch.from_numpy(a).to(cuda, dtype) if a.dtype == np.float32
            else torch.from_numpy(a).to(cuda) for a in arrays]


def _hold(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_paged_kernels_at_family_heads(cuda, heads, dtype, tol):
    """#1 (decode rows and chunks in one launch), #2 (flat decode) and #3
    (chunked prefill) at the families' G."""
    H, Hkv, DH = HEADS[heads]
    rng = np.random.default_rng(7)
    lens = [24, 3300, 650, 0, 770]
    k, v, bt = _pool(rng, lens, Hkv, DH)
    q = rng.normal(0, 1, (len(lens), H, DH)).astype(np.float32)
    qd, kp, vp, btd, ln = _to(cuda, dtype, q, k, v, bt,
                              np.asarray(lens, np.int32))
    _hold(dk.paged_decode_attention_flat(qd, kp, vp, btd, ln),
          dk.paged_decode_attention_flat_plain(qd, kp, vp, btd, ln), tol)
    ctx, clen, C = [2800, 0, 1000], [256, 256, 100], 256
    k, v, bt = _pool(rng, [c + n for c, n in zip(ctx, clen)], Hkv, DH)
    q = rng.normal(0, 1, (3, C, H, DH)).astype(np.float32)
    qc, kp, vp, btc, c_, n_ = _to(cuda, dtype, q, k, v, bt,
                                  np.asarray(ctx, np.int32),
                                  np.asarray(clen, np.int32))
    _hold(pk.paged_prefill_attention(qc, kp, vp, btc, c_, n_),
          pk.paged_prefill_attention_plain(qc, kp, vp, btc, c_, n_), tol)
    tags = torch.ones_like(c_)
    _hold(tk.paged_mixed_attention(qc, kp, vp, btc, c_, n_, tags),
          tk.paged_mixed_attention_plain(qc, kp, vp, btc, c_, n_, tags), tol)
    # decode rows (tag 0: ctx = length - 1, one row) beside the chunks
    segs_ctx = torch.cat([c_, torch.tensor([30, 1500], device=cuda,
                                           dtype=torch.int32)])
    seg = torch.cat([n_, torch.ones(2, device=cuda, dtype=torch.int32)])
    tg = torch.cat([tags, torch.zeros(2, device=cuda, dtype=torch.int32)])
    k2, v2, bt2 = _pool(rng, [c + n for c, n in zip(ctx, clen)]
                        + [31, 1501], Hkv, DH)
    q2 = rng.normal(0, 1, (5, C, H, DH)).astype(np.float32)
    q2d, kp2, vp2, bt2d = _to(cuda, dtype, q2, k2, v2, bt2)
    _hold(tk.paged_mixed_attention(q2d, kp2, vp2, bt2d, segs_ctx, seg, tg),
          tk.paged_mixed_attention_plain(q2d, kp2, vp2, bt2d, segs_ctx, seg,
                                         tg), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_contiguous_kernels_at_family_heads(cuda, heads, dtype, tol):
    """#6 (causal prefill, B 2 at T 1024 with one row shorter) and #5
    (padded, through a reversed row map into a slab of 1025 rows)."""
    H, Hkv, DH = HEADS[heads]
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    B, T = 2, 1024
    q, k, v = (torch.randn((B, T, n, DH), generator=g, device=cuda,
                           dtype=dtype) for n in (H, Hkv, Hkv))
    lengths = torch.tensor([T, T - 37], dtype=torch.int32, device=cuda)
    _hold(pk.prefill_attention(q, k, v, lengths),
          pk.prefill_attention_plain(q, k, v, lengths), tol)
    S = T + 1
    q = torch.randn((B, H, DH), generator=g, device=cuda, dtype=dtype)
    k, v = (torch.randn((B, S, Hkv, DH), generator=g, device=cuda,
                        dtype=dtype) for _ in range(2))
    rows = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    lens = torch.tensor([S, 700], dtype=torch.int32, device=cuda)
    _hold(dk.decode_attention(q, k, v, lens, kv_rows=rows),
          dk.decode_attention_plain(q, k, v, lens, kv_rows=rows), tol)


@pytest.mark.gpu
def test_moe_dense_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One layer at qwen3-moe's widths (128 experts, D 2048, F 768), f32,
    tiled as the engine tiles it; bf16 in tiles of 7 tokens gives finite
    values."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=1,
                              dtype=torch.float32)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    p = {k: v[0] for k, v in mlp.init_moe(gen, cfg, 1).items()}
    x = torch.randn((3, 40, cfg.d_model), generator=gen, device=cuda)
    y, aux = mlp.moe_dense(p, cfg, x)
    y_cpu, aux_cpu = mlp.moe_dense({k: v.cpu() for k, v in p.items()}, cfg,
                                   x.cpu())
    torch.testing.assert_close(y.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), aux_cpu, atol=1e-5, rtol=1e-5)
    b = dataclasses.replace(cfg, dtype=torch.bfloat16)
    pb = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in p.items()}
    per_token = mlp.MOE_TILE_BYTES // mlp.moe_token_tile(b, 2)
    monkeypatch.setattr(mlp, "MOE_TILE_BYTES", 7 * per_token + 1)
    assert mlp.moe_token_tile(b, 2) == 7
    yb, _ = mlp.moe_dense(pb, b, x.to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16 and torch.isfinite(yb.float()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name,backend", [("qwen2-vl-7b", "flat"),
                                          ("qwen3-moe-30b-a3b", "fused"),
                                          ("arctic-480b", "fused")])
def test_family_engine_on_the_card_matches_the_cpu(cuda, name, backend):
    """Reduced widths, f32: equal greedy streams on the card and the
    CPU."""
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    streams = {}
    for dev in ("cuda", "cpu"):
        params = cpu_params if dev == "cpu" else _tree(cpu_params, cuda)
        eng = Engine(0, model, params, max_slots=3, max_seq=256,
                     prefill_token_budget=32, attn_backend=backend)
        rng = np.random.default_rng(1)
        reqs = [ServeRequest(i, rng.integers(0, cfg.vocab_size, n)
                             .astype(np.int32), 6)
                for i, n in enumerate((40, 90, 17))]
        for r in reqs:
            eng.submit(r)
        while not all(r.state.name == "FINISHED" for r in reqs):
            assert eng.steps < 200
            eng.step()
        eng.check_drained()
        streams[dev] = [r.generated for r in reqs]
    assert streams["cuda"] == streams["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_contiguous_kernels_at_g1(cuda, dtype, tol):
    """#6 at whisper's decoder prompt (B 2, T 448, 20 / 20 / Dh 64) and #5
    padded on its self-KV (S 448, one row short) and its cross-KV (S 1500,
    every key valid)."""
    H = Hkv = 20
    DH = 64
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    B, T = 2, 448
    q, k, v = (torch.randn((B, T, n, DH), generator=g, device=cuda,
                           dtype=dtype) for n in (H, Hkv, Hkv))
    full = torch.full((B,), T, dtype=torch.int32, device=cuda)
    _hold(pk.prefill_attention(q, k, v),
          pk.prefill_attention_plain(q, k, v, full), tol)
    for S, lens in ((448, [68, 448]), (1500, [1500, 1500])):
        q = torch.randn((B, H, DH), generator=g, device=cuda, dtype=dtype)
        k, v = (torch.randn((B, S, Hkv, DH), generator=g, device=cuda,
                            dtype=dtype) for _ in range(2))
        ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
        _hold(dk.decode_attention(q, k, v, ln),
              dk.decode_attention_plain(q, k, v, ln), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["zamba2-2.7b", "whisper-large-v3"])
def test_hybrid_and_encdec_on_the_card_match_the_cpu(cuda, name):
    """Reduced widths, 2 layers, f32: ``Model.prefill`` of 40 tokens
    (zamba2's chunked SSD on the card, chunks of 16 so the last is short,
    against the CPU's sequential one) and 6 greedy decode steps: logits
    within 1e-4 of their largest magnitude, equal tokens."""
    from repro_torch.models import mamba2
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    batch = synthetic_batch(cfg, 2, 40, device="cpu")
    out = {}
    old = mamba2.SSD_CHUNK
    mamba2.SSD_CHUNK = 16
    try:
        for dev in ("cuda", "cpu"):
            params = cpu_params if dev == "cpu" else _tree(cpu_params, cuda)
            extras = {k: v.to(dev) for k, v in batch.items()
                      if k != "tokens"}
            logits, cache = model.prefill(params, batch["tokens"].to(dev),
                                          48, **extras)
            rows, toks = [logits.float().cpu()], []
            for i in range(6):
                tok = logits.argmax(-1)
                toks.append(tok.cpu().tolist())
                pos = torch.full((2,), 40 + i, dtype=torch.int32, device=dev)
                logits, cache = model.decode_step(params, cache, tok, pos)
                rows.append(logits.float().cpu())
            out[dev] = (torch.stack(rows), toks)
    finally:
        mamba2.SSD_CHUNK = old
    (a, ta), (b, tb) = out["cuda"], out["cpu"]
    assert ta == tb
    torch.testing.assert_close(a, b, rtol=0,
                               atol=1e-4 * max(1.0, b.abs().max().item()))


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One AdamW step of reduced llama3.2-3b (2 layers, f32, remat on) on
    the card (#6 forward, its plain version differentiated) and the CPU:
    the loss, every gradient and every parameter after the step."""
    cfg = get_config("llama3.2-3b").reduced()
    model = build_model(cfg)
    cpu_params = model.init(0, device="cpu")
    batch = synthetic_batch(cfg, 2, 64, device="cpu")
    got = {}
    for dev in ("cuda", "cpu"):
        params = _tree(cpu_params, torch.device(dev))
        leaves = [p.requires_grad_() for p in _leaves(params)]
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _ = model.loss(params, b, remat=True)
        grads = torch.autograd.grad(loss, leaves)
        step = make_train_step(model, AdamWConfig(warmup_steps=1),
                               remat=True)
        params, _, m = step(params, init_adamw(params), b)
        got[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                    [p.detach().cpu() for p in _leaves(params)])
    (la, ga, pa), (lb, gb, pb) = got["cuda"], got["cpu"]
    assert abs(la - lb) <= 1e-5 * abs(lb)
    for x, y in zip(ga + pa, gb + pb):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-4 * max(
            1.0, y.abs().max().item()))


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _tree(tree, device):
    return {k: (_tree(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}
