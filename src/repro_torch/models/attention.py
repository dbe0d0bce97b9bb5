"""GQA attention with RoPE — the port's subset of
``repro.models.attention``: whole-prompt prefill (the contiguous causal
prefill kernel; a sliding window longer than the prompt masks nothing,
a prompt longer than the window runs the banded plain path,
:func:`window_attention`), single-token decode against a monolithic KV
slab or a window's ring (the contiguous decode kernel, padded), and the
decode, chunked-prefill and
mixed-iteration paths over the global block pool on the four paged
backends (``dense`` gather + masked SDPA, the ``grid`` and ``flat`` kernel
pairs, the ``fused`` kernel), and the int8 pool (``QuantKVCache``:
quantize-on-write, scales beside the rows), which the ``fused`` kernel and
the ``dense`` path read. RoPE, or Qwen2-VL's three-stream M-RoPE where the
config asks for it, rotates q and k on every path but the mixed step,
which refuses M-RoPE as the reference's does.

Shapes follow the JAX package: activations ``x [B, T, D]``, a slab layer
``[B, S, Hkv, Dh]``, a pool slice ``[NB, BS, Hkv, Dh]`` per layer, block
tables ``[B, NBT]`` int32. Slab and pool writes are IN PLACE
(``index_put_``): a functional copy would duplicate the multi-GB cache per
layer per step, so each function returns the cache it was given, updated.
The paged paths are full-attention only, as in the reference: a window's
ring has no block-table layout.

Whisper's cross-attention reads the encoder's K/V: one decoder token at a
time through the contiguous decode kernel (every key valid), a prompt's
queries in plain PyTorch, as the reference computes both in XLA. A head
dim that no kernel build takes (``KERNEL_HEAD_DIMS``: zamba2's 80) is
routed before any launch: prefill through :func:`window_attention` with a
window of the whole prompt, decode through the plain padded decode.

The causal prefill is differentiable (:func:`causal_prefill`): the loss
path runs the kernel forward and differentiates its plain version.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  paged_decode_attention,
                                                  paged_decode_attention_flat)
from repro_torch.kernels.mixed_attention import paged_mixed_attention
from repro_torch.kernels.ops import KERNEL_HEAD_DIMS, NEG_INF
from repro_torch.kernels.prefill_attention import (paged_prefill_attention,
                                                   prefill_attention,
                                                   prefill_attention_plain)
from repro_torch.models.common import (ModelConfig, copy_to_tp, dense_init,
                                       psum_if_tp)

# Paged attention backends (the JAX package's four):
#   dense — gather pool[block_tables] + masked SDPA in plain PyTorch: a
#           [B, NBT·BS, Hkv, Dh] copy per layer per step and no kernel; the
#           reference's parity baseline, and it reads int8 pools.
#   grid  — decode by the (request, kv head) grid kernel, prompt chunks by
#           the chunked prefill kernel: a mixed step makes two calls.
#   flat  — decode by the flat work-list kernel, chunks as on grid.
#   fused — one tagged kernel over decode rows and chunks: one call.
PAGED_BACKENDS = ("dense", "grid", "flat", "fused")


def resolve_paged_backend(backend: Optional[str] = None) -> str:
    """The backend to run: an explicit argument wins, else ``fused``."""
    choice = backend or "fused"
    if choice not in PAGED_BACKENDS:
        raise ValueError(f"unknown paged backend {choice!r}; the port has "
                         f"{PAGED_BACKENDS}")
    return choice


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[Dh/2] f32 inverse frequencies, cached per (Dh, theta, device) so a
    decode step does not rebuild them per layer."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, T, H, Dh]; positions [B, T] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # [Dh/2]
    angles = positions[..., None].float() * freqs                # [B, T, Dh/2]
    cos, sin = torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(2, 3, 3)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the Dh/2 frequency slots split into (t, h, w)
    sections, each rotated by its own position stream; the last section
    absorbs the rounding. x [B, T, H, Dh]; positions3 [B, T, 3] (temporal,
    height, width ids; identical streams for pure text)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = rope_freqs(dh, theta, x.device)                      # [half]
    total = sum(sections)
    bounds = []
    start = 0
    for s in sections:
        n = (half * s) // total
        bounds.append((start, start + n))
        start += n
    bounds[-1] = (bounds[-1][0], half)
    pos = positions3.float()                                     # [B, T, 3]
    angles = torch.cat([pos[..., i:i + 1] * freqs[lo:hi]
                        for i, (lo, hi) in enumerate(bounds)], dim=-1)
    cos, sin = torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rotate(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
            positions: torch.Tensor, mrope_positions=None):
    """q, k rotated at ``positions`` [B, T]: M-RoPE where the config uses
    it (``mrope_positions`` [B, T, 3], by default the text positions on
    all three streams, as the reference defaults them), RoPE otherwise,
    nothing with learned positions."""
    if cfg.use_mrope:
        mp = (mrope_positions if mrope_positions is not None
              else positions[..., None].expand(*positions.shape, 3))
        return (apply_mrope(q, mp, cfg.rope_theta),
                apply_mrope(k, mp, cfg.rope_theta))
    if cfg.learned_pos:
        return q, k
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   layers: Optional[int] = None):
    """Attention weights ``wq``/``wk``/``wv``/``wo`` (``x @ W``, fan_in the
    input width) and, with ``qkv_bias``, zero biases; with ``layers``,
    stacked on a leading axis of that many layers, drawn in that layout."""
    d, h, hk, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim)
    dev, dt = gen.device, cfg.dtype
    lead = () if layers is None else (layers,)
    att = {
        "wq": dense_init(gen, lead + (d, h * dh), dt, fan_in=d),
        "wk": dense_init(gen, lead + (d, hk * dh), dt, fan_in=d),
        "wv": dense_init(gen, lead + (d, hk * dh), dt, fan_in=d),
        "wo": dense_init(gen, lead + (h * dh, d), dt, fan_in=h * dh),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", hk), ("bv", hk)):
            att[name] = torch.zeros(lead + (n * dh,), dtype=dt, device=dev)
    return att


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor):
    B, T, _ = x.shape
    x = copy_to_tp(x, cfg)     # column-parallel under tensor parallelism
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    dh = cfg.head_dim
    return (q.reshape(B, T, -1, dh), k.reshape(B, T, -1, dh),
            v.reshape(B, T, -1, dh))


# --------------------------------------------------------------------------
# Core SDPA (GQA, masked): the dense path, plain PyTorch
# --------------------------------------------------------------------------
def _gqa_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask):
    """q [B,Tq,H,Dh]; k,v [B,S,Hkv,Dh]; mask broadcastable to
    [B, Hkv, G, Tq, S] (5-d; None = attend everything). Scores, softmax and
    both products in f32; the weights round to V's dtype before P·V, as
    the reference's ``w.astype(v.dtype)`` does."""
    B, Tq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Tq, Hkv, H // Hkv, Dh).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) / math.sqrt(Dh)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhgts,bshd->bthgd", w, v.float())
    return out.reshape(B, Tq, H, Dh).to(q.dtype)


# --------------------------------------------------------------------------
# Whole-prompt prefill and decode against the monolithic slab
# --------------------------------------------------------------------------
KV_DTYPES = ("bf16", "int8")


class KVCache(NamedTuple):
    k: torch.Tensor     # slab [(L,) B, S, Hkv, Dh] or pool [(L,) NB, BS, ...]
    v: torch.Tensor


# query rows per tile of the banded window path: its f32 scores hold
# tile x (window + tile) keys per head
WINDOW_TILE = 512


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, tile: Optional[int] = None
                     ) -> torch.Tensor:
    """Banded causal attention over a whole prompt: q [B, T, H, Dh] at
    positions 0..T-1 sees keys ``q - window < k <= q`` of k, v
    [B, T, Hkv, Dh]. Plain PyTorch (``_gqa_sdpa``), ``tile`` query rows at
    a time over the keys their band covers, so the scores stay
    O(tile x (window + tile)) at any T. This is the counterpart of the
    reference's XLA math for a prompt longer than its window (its masked
    SDPA and flash scan with ``window=``): no Hopper kernel takes a lower
    key bound yet, and the contiguous prefill kernel would attend the
    whole causal prefix. ``tile`` defaults to ``WINDOW_TILE``. Returns
    [B, T, H, Dh]."""
    B, T = q.shape[:2]
    tile = tile or WINDOW_TILE
    out = torch.empty_like(q)
    for q0 in range(0, T, tile):
        q1 = min(q0 + tile, T)
        k0 = max(0, q0 - window + 1)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        out[:, q0:q1] = _gqa_sdpa(q[:, q0:q1], k[:, k0:q1], v[:, k0:q1],
                                  mask[None, None, None])
    return out


class _CausalPrefill(torch.autograd.Function):
    """#6 under autograd: forward runs ``prefill_attention`` (the kernel,
    its plain version for CPU tensors); backward recomputes the plain
    version under autograd from the saved q, k, v and differentiates it.
    The reference trains through XLA and has no backward kernel either; a
    hand-written backward kernel is later work."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return prefill_attention(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(need) for t, need in
                       zip(saved, ctx.needs_input_grad[:3]))
            full = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                              device=q.device)
            out = prefill_attention_plain(q, k, v, full)
            wanted = [t for t in (q, k, v) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t.requires_grad else None
                     for t in (q, k, v))


def causal_prefill(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Causal attention over a whole prompt (q [B, T, H, Dh], k, v
    [B, T, Hkv, Dh], contiguous) through #6, differentiable: see
    :class:`_CausalPrefill`. Launches the kernel once a forward (again
    when a checkpointed layer recomputes it), never in backward."""
    return _CausalPrefill.apply(q, k, v)


def attention_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, mrope_positions=None):
    """Causal self-attention over a whole prompt: x [B, T, D], positions
    [B, T] = 0..T-1 (``mrope_positions`` [B, T, 3] under M-RoPE). The
    contiguous causal prefill kernel attends (its plain version for CPU
    tensors); the reference's two XLA branches (masked SDPA up to T² =
    2048², the flash scan above) compute this one function. With a
    sliding window W, a prompt of T <= W runs the same kernel (the window
    masks nothing) and a longer one :func:`window_attention`; so does a
    head dim outside ``KERNEL_HEAD_DIMS`` (zamba2's 80), with a window of
    T, checked before any launch. The kernel runs through
    :func:`causal_prefill`, so the loss can differentiate it. Returns
    (out [B, T, D], (k, v) [B, T, Hkv, Dh] after RoPE)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rotate(cfg, q, k, positions, mrope_positions)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    W = cfg.sliding_window
    if W and T > W:
        out = window_attention(q, k, v, W)
    elif cfg.head_dim not in KERNEL_HEAD_DIMS:
        # no kernel instance for this head dim: the tiled plain path,
        # whose window of T masks nothing beyond causality
        out = window_attention(q, k, v, T)
    else:
        out = causal_prefill(q, k, v)
    return psum_if_tp(out.reshape(B, T, -1) @ p["wo"], cfg), (k, v)


def make_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype: Optional[torch.dtype] = None, device="cuda",
               layers: Optional[int] = None) -> KVCache:
    """Zeroed monolithic KV slab: [batch, S, Hkv, Dh] for ONE layer, or
    [layers, batch, S, Hkv, Dh]: one row of ``S`` keys per batch slot,
    whatever the slot's request holds. ``S = seq``, or with a sliding
    window the ring ``min(seq, window)``."""
    W = cfg.sliding_window
    S = min(seq, W) if W else seq
    shape = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    if layers is not None:
        shape = (layers,) + shape
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache_l: KVCache,
                     pos: torch.Tensor, rows: Optional[torch.Tensor] = None,
                     *, mrope_positions=None):
    """One token against a slab layer: x [B, 1, D]; pos [B] int32 tokens
    already cached; cache_l [B, S, Hkv, Dh], or with ``rows`` ([B] int32,
    the slab row of each x row) a slab of any number of rows. Writes the
    new token's K/V in place at ``pos`` (``pos % W`` in a window's ring),
    clamped to ``S - 1`` as the reference's ``dynamic_update_slice``
    clamps it, then attends keys ``< min(pos + 1, S)`` through the
    contiguous decode kernel in its padded mode, which streams all S keys
    of each row with a mask, as the reference's masked SDPA does (its
    plain version for CPU tensors). In a ring the valid slots are always
    that prefix: slots 0..pos before it wraps, all W of the last W
    positions after, and attention does not depend on the keys' order
    (RoPE rotated K before it was cached). A head dim outside
    ``KERNEL_HEAD_DIMS`` runs the plain padded decode. Returns
    (out [B, 1, D], cache_l)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rotate(cfg, q, k, pos[:, None], mrope_positions)
    S = cache_l.k.shape[1]
    slab_row = (torch.arange(B, device=pos.device) if rows is None
                else rows.long())
    W = cfg.sliding_window
    write = torch.remainder(pos, W) if W else pos
    idx = (slab_row, torch.clamp(write, max=S - 1).long())
    cache_l.k.index_put_(idx, k[:, 0].to(cache_l.k.dtype))
    cache_l.v.index_put_(idx, v[:, 0].to(cache_l.v.dtype))
    lengths = torch.clamp(pos + 1, max=S).to(torch.int32)
    kv_rows = None if rows is None else rows.to(torch.int32)
    o = _decode(cfg, q[:, 0].contiguous(), cache_l.k, cache_l.v, lengths,
                kv_rows)
    return psum_if_tp(o.reshape(B, 1, -1) @ p["wo"], cfg), cache_l


def _decode(cfg: ModelConfig, q, k, v, lengths, kv_rows=None):
    """The padded contiguous decode: the kernel, or for a head dim outside
    ``KERNEL_HEAD_DIMS`` its plain version, chosen before any launch."""
    fn = (decode_attention if cfg.head_dim in KERNEL_HEAD_DIMS
          else decode_attention_plain)
    return fn(q, k, v, lengths, ragged=False, kv_rows=kv_rows)


# --------------------------------------------------------------------------
# The paged pool
# --------------------------------------------------------------------------


class QuantKVCache(NamedTuple):
    """int8 paged block pool (DESIGN.md §Quantized KV blocks): K/V rows are
    symmetric int8 over the head dim with f32 per-(block, position,
    kv-head) scales — (Dh + 4)/(2·Dh) of the bf16 bytes. A tuple of leaves
    like :class:`KVCache`, so the block gather/scatter and migration
    helpers run over it unchanged."""
    k: torch.Tensor        # [(L,) NB, BS, Hkv, Dh] int8
    v: torch.Tensor
    k_scale: torch.Tensor  # [(L,) NB, BS, Hkv] f32
    v_scale: torch.Tensor


def layer_pool(pool, l: int):
    """Layer ``l``'s slice of a layer-stacked pool (views)."""
    return type(pool)(*(a[l] for a in pool))


def make_paged_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype: Optional[torch.dtype] = None, device="cuda",
                    kv_dtype: str = "bf16", layers: Optional[int] = None):
    """Zeroed global block pool: [NB, BS, Hkv, Dh] for ONE layer, or
    [layers, NB, BS, Hkv, Dh]. ``kv_dtype="int8"`` gives the quantized
    layout with zero scales, so the garbage block (and any row never
    written) dequantizes to exact zeros."""
    assert kv_dtype in KV_DTYPES, kv_dtype
    shape = (num_blocks, block_size, cfg.num_kv_heads // cfg.tp_size,
             cfg.head_dim)
    if layers is not None:
        shape = (layers,) + shape
    if kv_dtype == "int8":
        return QuantKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 quantization over the last (head) axis, as the
    reference computes it: ``scale = max(amax_f32 / 127, 1e-8)``, then
    ``round(x_f32 / scale)`` (half to even) clipped to ±127 — a division,
    not a product with the reciprocal, so the int8 values are the
    reference's. Returns ``(int8 values, f32 scales [x.shape[:-1]])``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def scatter_pool(pool_l, blk: torch.Tensor, off: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor):
    """Write new K/V rows into one layer's pool slice at physical
    ``(blk, off)``, in place — quantize-on-write when the pool is int8.
    ``blk``/``off`` are integer tensors of a matching shape S; ``k``/``v``
    are [*S, Hkv, Dh] in compute dtype."""
    idx = (blk.long(), off.long())
    if isinstance(pool_l, QuantKVCache):
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        pool_l.k.index_put_(idx, kq)
        pool_l.v.index_put_(idx, vq)
        pool_l.k_scale.index_put_(idx, ks)
        pool_l.v_scale.index_put_(idx, vs)
        return pool_l
    pool_l.k.index_put_(idx, k.to(pool_l.k.dtype))
    pool_l.v.index_put_(idx, v.to(pool_l.v.dtype))
    return pool_l


def _pool_scales(pool_l):
    """(k_scale, v_scale) kernel operands — (None, None) for full-width
    pools."""
    if isinstance(pool_l, QuantKVCache):
        return pool_l.k_scale, pool_l.v_scale
    return None, None


def quantize_piece(piece: KVCache) -> QuantKVCache:
    """Contiguous full-precision KV piece (leaves ``[..., Hkv, Dh]``) ->
    its :class:`QuantKVCache` twin, for writing into an int8 pool."""
    kq, ks = quantize_kv(piece.k)
    vq, vs = quantize_kv(piece.v)
    return QuantKVCache(kq, vq, ks, vs)


def dequantize_piece(piece: QuantKVCache, dtype: torch.dtype) -> KVCache:
    """:class:`QuantKVCache` piece -> contiguous full-precision
    :class:`KVCache` in ``dtype`` (product in f32, then cast). Migration
    exports cross this, so the wire stays full-width and bf16 and int8
    engines interoperate."""
    return KVCache(
        (piece.k.float() * piece.k_scale[..., None]).to(dtype),
        (piece.v.float() * piece.v_scale[..., None]).to(dtype))


def _check_kv_backend(pool_l, attn_backend: str) -> None:
    """int8 pools are read by the fused kernel and the dense path; the
    grid and flat kernels take full-width pools only."""
    if isinstance(pool_l, QuantKVCache) and attn_backend in ("grid", "flat"):
        raise ValueError(f"int8 KV pools need the 'fused' or 'dense' "
                         f"backend, got {attn_backend!r}")


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor):
    """pool [NB, BS, Hkv, Dh]; block_tables [B, NBT] -> contiguous
    per-request view [B, NBT*BS, Hkv, Dh] (rows past a request's length
    come from padding entries and must be masked by the caller)."""
    B, NBT = block_tables.shape
    g = pool[block_tables.long()]
    return g.reshape(B, NBT * pool.shape[1], *pool.shape[2:])


def _gather_dequant(pool_l, block_tables: torch.Tensor):
    """Dense-path gather of a request-contiguous [B, NBT·BS, Hkv, Dh] view,
    dequantized to f32 when the pool is int8."""
    k_seq = paged_gather(pool_l.k, block_tables)
    v_seq = paged_gather(pool_l.v, block_tables)
    if isinstance(pool_l, QuantKVCache):
        ks = paged_gather(pool_l.k_scale, block_tables)      # [B, S, Hkv]
        vs = paged_gather(pool_l.v_scale, block_tables)
        k_seq = k_seq.float() * ks[..., None]
        v_seq = v_seq.float() * vs[..., None]
    return k_seq, v_seq


def _dense_attention(q: torch.Tensor, pool_l, block_tables: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """The dense backend: q [B, T, H, Dh] at global ``positions`` [B, T]
    over its request's gathered rows ``kpos <= position``. Returns
    [B, T, H, Dh]."""
    k_seq, v_seq = _gather_dequant(pool_l, block_tables)
    kpos = torch.arange(k_seq.shape[1], device=q.device)[None, None, :]
    mask = (kpos <= positions[:, :, None])[:, None, None]     # [B,1,1,T,S]
    return _gqa_sdpa(q, k_seq, v_seq, mask)


def _paged_decode(attn_backend: str, q: torch.Tensor, pool_l,
                  block_tables: torch.Tensor, lengths: torch.Tensor,
                  num_work=None, work_list=None) -> torch.Tensor:
    """The decode kernel of the ``grid`` or ``flat`` backend: q [B, H, Dh]
    over keys ``idx < lengths``. Returns [B, H, Dh]."""
    if attn_backend == "grid":
        return paged_decode_attention(q, pool_l.k, pool_l.v, block_tables,
                                      lengths)
    return paged_decode_attention_flat(q, pool_l.k, pool_l.v, block_tables,
                                       lengths, num_work=num_work,
                                       work_list=work_list)


def _table_entry(block_tables: torch.Tensor, pos: torch.Tensor, BS: int):
    """Physical block of logical position ``pos`` per row. Dead rows carry
    ``pos = -1``; the JAX gather wraps that to the table's last column,
    which here is an explicit floor-mod (every entry of a dead row is the
    garbage block, so any column would do)."""
    col = torch.remainder(torch.div(pos, BS, rounding_mode="floor"),
                          block_tables.shape[1])
    return torch.gather(block_tables, 1, col.long())


# --------------------------------------------------------------------------
# Decode, chunked prefill and the mixed iteration
# --------------------------------------------------------------------------
def attention_decode_paged(p, cfg: ModelConfig, x: torch.Tensor,
                           pool_l: KVCache, block_tables: torch.Tensor,
                           pos: torch.Tensor, *, attn_backend: str = "fused",
                           attn_num_work: Optional[int] = None,
                           attn_work_list=None, mrope_positions=None):
    """x [B, 1, D]; pool_l one layer's slice; block_tables [B, NBT] int32;
    pos [B] int32 tokens already cached (-1 = dead slot: its write lands
    in the garbage block and its attention length is 0). Writes the new
    token's K/V, then attends over keys ``<= pos``: the fused kernel with
    all-decode tags (ctx = pos, seg = 1), the grid or flat decode kernel
    (lengths = pos + 1; flat runs ``attn_num_work`` work items, and
    ``attn_work_list`` is their flat work list when the caller built it
    once for all layers), or the dense gather + SDPA. Returns
    (out [B, 1, D], pool_l)."""
    assert not cfg.sliding_window, "paged decode is full-attention only"
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rotate(cfg, q, k, pos[:, None], mrope_positions)
    _check_kv_backend(pool_l, attn_backend)
    BS = pool_l.k.shape[1]
    blk = _table_entry(block_tables, pos[:, None], BS)[:, 0]
    scatter_pool(pool_l, blk, torch.remainder(pos, BS), k[:, 0], v[:, 0])
    if attn_backend == "fused":
        o = paged_mixed_attention(
            q.contiguous(), pool_l.k, pool_l.v, block_tables, pos,
            torch.ones_like(pos), torch.zeros_like(pos),
            *_pool_scales(pool_l), num_work=attn_num_work)
    elif attn_backend == "dense":
        o = _dense_attention(q, pool_l, block_tables, pos[:, None])
    else:
        o = _paged_decode(attn_backend, q[:, 0].contiguous(), pool_l,
                          block_tables, pos + 1, attn_num_work,
                          attn_work_list)
    return psum_if_tp(o.reshape(B, 1, -1) @ p["wo"], cfg), pool_l


def attention_prefill_chunk_paged(p, cfg: ModelConfig, x: torch.Tensor,
                                  pool_l: KVCache,
                                  block_tables: torch.Tensor,
                                  ctx_len: torch.Tensor,
                                  chunk_len: torch.Tensor, *,
                                  attn_backend: str = "fused",
                                  mrope_positions=None):
    """Chunked prefill against the paged pool: x [B, C, D] — B prompt
    chunks of C tokens (rows past ``chunk_len`` are padding);
    block_tables [B, NBT] covering ``ceil((ctx_len + C)/BS)`` rows (the
    tail on the garbage block); ctx_len / chunk_len [B] int32. Writes the
    chunk's K/V at positions ``ctx..ctx+C-1`` (RoPE at the true
    positions), then attends each query causally over the written context
    and its own chunk: the chunked prefill kernel (``grid`` and ``flat``),
    the fused kernel with all-chunk tags, or the dense gather + SDPA.
    Returns (out [B, C, D], pool_l); rows past ``chunk_len`` are zeros on
    the kernel backends and unspecified on ``dense`` (the caller reads
    only real rows)."""
    assert not cfg.sliding_window, "paged prefill is full-attention only"
    B, C, _ = x.shape
    ctx = ctx_len.to(torch.int32)
    clen = chunk_len.to(torch.int32)
    positions = ctx[:, None] + torch.arange(C, dtype=torch.int32,
                                            device=ctx.device)[None]
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rotate(cfg, q, k, positions, mrope_positions)
    _check_kv_backend(pool_l, attn_backend)
    BS = pool_l.k.shape[1]
    scatter_pool(pool_l, _table_entry(block_tables, positions, BS),
                 torch.remainder(positions, BS), k, v)
    q = q.contiguous()
    if attn_backend == "fused":
        o = paged_mixed_attention(q, pool_l.k, pool_l.v, block_tables, ctx,
                                  clen, torch.ones_like(ctx),
                                  *_pool_scales(pool_l))
    elif attn_backend == "dense":
        o = _dense_attention(q, pool_l, block_tables, positions)
    else:
        o = paged_prefill_attention(q, pool_l.k, pool_l.v, block_tables,
                                    ctx, clen)
    return psum_if_tp(o.reshape(B, C, -1) @ p["wo"], cfg), pool_l


def attention_mixed_paged(p, cfg: ModelConfig, x_dec: torch.Tensor,
                          x_ck: torch.Tensor, pool_l: KVCache,
                          bt_dec: torch.Tensor, bt_ck: torch.Tensor,
                          pos: torch.Tensor, ctx_len: torch.Tensor,
                          chunk_len: torch.Tensor, *,
                          attn_backend: str = "fused",
                          attn_num_work: Optional[int] = None):
    """The attention of a whole mixed iteration: ONE fused launch; on the
    ``grid`` and ``flat`` backends that backend's decode kernel for the
    decode half and the chunked prefill kernel for the chunks
    (``attn_num_work`` is then not taken: flat's decode half runs the
    worst-case bucket); on ``dense`` a gather + SDPA for each half.

    x_dec [Bd, 1, D] — the decode batch (``pos = -1`` marks dead slots);
    x_ck [Bp, C, D] — prompt chunks (rows past ``chunk_len`` are
    padding); bt_dec [Bd, NBT] / bt_ck [Bp, NBT'] block tables, padded to
    a common width here; pos [Bd]; ctx_len / chunk_len [Bp] int32.
    Projection, RoPE and ``wo`` run per half; the attention runs as one
    tagged launch: decode segments (tag 0, ctx = pos, seg = 1), then the
    chunks (tag 1). Returns ``(out_dec [Bd, 1, D], out_ck [Bp, C, D],
    pool_l)``.
    """
    assert not cfg.sliding_window, "paged mixed step is full-attention only"
    assert not cfg.use_mrope, "paged mixed step: RoPE / learned-pos only"
    _check_kv_backend(pool_l, attn_backend)
    Bd = x_dec.shape[0]
    Bp, C, _ = x_ck.shape
    ctx = ctx_len.to(torch.int32)
    clen = chunk_len.to(torch.int32)
    positions = ctx[:, None] + torch.arange(C, dtype=torch.int32,
                                            device=ctx.device)[None]

    qd, kd, vd = _project_qkv(p, cfg, x_dec)
    qc, kc, vc = _project_qkv(p, cfg, x_ck)
    qd, kd = _rotate(cfg, qd, kd, pos[:, None])
    qc, kc = _rotate(cfg, qc, kc, positions)

    BS = pool_l.k.shape[1]
    blk_d = _table_entry(bt_dec, pos[:, None], BS)[:, 0]
    blk_c = _table_entry(bt_ck, positions, BS)
    scatter_pool(pool_l, blk_d, torch.remainder(pos, BS), kd[:, 0], vd[:, 0])
    scatter_pool(pool_l, blk_c, torch.remainder(positions, BS), kc, vc)

    if attn_backend == "dense":
        out_d = _dense_attention(qd, pool_l, bt_dec, pos[:, None])
        out_c = _dense_attention(qc, pool_l, bt_ck, positions)
        return (psum_if_tp(out_d.reshape(Bd, 1, -1) @ p["wo"], cfg),
                psum_if_tp(out_c.reshape(Bp, C, -1) @ p["wo"], cfg), pool_l)
    if attn_backend != "fused":
        out_d = _paged_decode(attn_backend, qd[:, 0].contiguous(), pool_l,
                              bt_dec, pos + 1)
        out_c = paged_prefill_attention(qc.contiguous(), pool_l.k, pool_l.v,
                                        bt_ck, ctx, clen)
        return (psum_if_tp(out_d.reshape(Bd, 1, -1) @ p["wo"], cfg),
                psum_if_tp(out_c.reshape(Bp, C, -1) @ p["wo"], cfg), pool_l)
    # decode q rides in row 0 of a chunk-wide tile; tables pad to a common
    # width (padded entries lie past every segment's total: never read)
    NBT = max(bt_dec.shape[1], bt_ck.shape[1])
    pad = torch.nn.functional.pad
    bt_all = torch.cat([pad(bt_dec, (0, NBT - bt_dec.shape[1])),
                        pad(bt_ck, (0, NBT - bt_ck.shape[1]))])
    q_all = torch.cat([pad(qd, (0, 0, 0, 0, 0, C - 1)), qc])
    o = paged_mixed_attention(
        q_all, pool_l.k, pool_l.v, bt_all, torch.cat([pos, ctx]),
        torch.cat([torch.ones_like(pos), clen]),
        torch.cat([torch.zeros_like(pos), torch.ones_like(ctx)]),
        *_pool_scales(pool_l), num_work=attn_num_work)
    out_d, out_c = o[:Bd, :1], o[Bd:]
    return (psum_if_tp(out_d.reshape(Bd, 1, -1) @ p["wo"], cfg),
            psum_if_tp(out_c.reshape(Bp, C, -1) @ p["wo"], cfg), pool_l)


# --------------------------------------------------------------------------
# Cross-attention (whisper's decoder): K/V computed once from the encoder
# --------------------------------------------------------------------------
def cross_attention(p, cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: KVCache) -> torch.Tensor:
    """Decoder queries x [B, T, D] over the encoder's K/V [B, S_enc, Hkv,
    Dh], every key visible. One token (T = 1, a decode step) runs the
    contiguous decode kernel in its padded mode with ``lengths = S_enc``
    (the plain version for CPU tensors or a head dim no kernel takes); a
    prompt's T queries run the plain ``_gqa_sdpa``, as the reference's XLA
    does: #6 is causal only. Returns [B, T, D]."""
    B, T, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
    if T == 1:
        S = enc_kv.k.shape[1]
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        out = _decode(cfg, q[:, 0].contiguous(), enc_kv.k, enc_kv.v,
                      lengths)[:, None]
    else:
        out = _gqa_sdpa(q, enc_kv.k, enc_kv.v, None)
    return out.reshape(B, T, -1) @ p["wo"]


def encode_cross_kv(p, cfg: ModelConfig, enc_out: torch.Tensor) -> KVCache:
    """The encoder output [B, S, D] projected to cross-attention K/V
    [B, S, Hkv, Dh] (with the biases where the layer has them)."""
    B, S, _ = enc_out.shape
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k.reshape(shape), v.reshape(shape))
