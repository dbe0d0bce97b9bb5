"""Paged GQA attention with RoPE — the port's subset of
``repro.models.attention``: the decode, chunked-prefill and
mixed-iteration paths over the global block pool, on the ``flat`` kernel
pair or the ``fused`` kernel, and the int8 pool (``QuantKVCache``:
quantize-on-write, scales beside the rows), which only the ``fused``
kernel reads.

Shapes follow the JAX package: activations ``x [B, T, D]``, a pool slice
``[NB, BS, Hkv, Dh]`` per layer, block tables ``[B, NBT]`` int32. Pool
writes are IN PLACE (``index_put_``): a functional copy would duplicate
the multi-GB pool per layer per step, so each function returns the pool
it was given, updated.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.decode_attention import paged_decode_attention_flat
from repro_torch.kernels.mixed_attention import paged_mixed_attention
from repro_torch.kernels.prefill_attention import paged_prefill_attention
from repro_torch.models.common import ModelConfig

# Paged attention backends of the port (the JAX package's "dense" and
# "grid" wait: on the CPU the plain versions do the dense path's job, and
# "grid" needs the kernel of its own):
#   flat  — decode by the flat work-list kernel, prompt chunks by the
#           chunked prefill kernel: a mixed step makes two calls.
#   fused — one tagged kernel over decode rows and chunks: one call.
PAGED_BACKENDS = ("flat", "fused")


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


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor):
    B, T, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    dh = cfg.head_dim
    return (q.reshape(B, T, -1, dh), k.reshape(B, T, -1, dh),
            v.reshape(B, T, -1, dh))


# --------------------------------------------------------------------------
# The paged pool
# --------------------------------------------------------------------------
KV_DTYPES = ("bf16", "int8")


class KVCache(NamedTuple):
    k: torch.Tensor     # [(L,) NB, BS, Hkv, Dh]
    v: torch.Tensor


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
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
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
    """int8 pools are read by the fused kernel only (the reference also
    allows its ``dense`` backend, which the port does not have)."""
    if isinstance(pool_l, QuantKVCache) and attn_backend != "fused":
        raise ValueError(f"int8 KV pools need the 'fused' backend, got "
                         f"{attn_backend!r}")


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor):
    """pool [NB, BS, Hkv, Dh]; block_tables [B, NBT] -> contiguous
    per-request view [B, NBT*BS, Hkv, Dh] (rows past a request's length
    come from padding entries and must be masked by the caller)."""
    B, NBT = block_tables.shape
    g = pool[block_tables.long()]
    return g.reshape(B, NBT * pool.shape[1], *pool.shape[2:])


def _table_entry(block_tables: torch.Tensor, pos: torch.Tensor, BS: int):
    """Physical block of logical position ``pos`` per row. Dead rows carry
    ``pos = -1``; the JAX gather wraps that to the table's last column,
    which here is an explicit floor-mod (every entry of a dead row is the
    garbage block, so any column would do)."""
    col = torch.remainder(torch.div(pos, BS, rounding_mode="floor"),
                          block_tables.shape[1])
    return torch.gather(block_tables, 1, col.long())


# --------------------------------------------------------------------------
# Decode and the fused mixed iteration
# --------------------------------------------------------------------------
def attention_decode_paged(p, cfg: ModelConfig, x: torch.Tensor,
                           pool_l: KVCache, block_tables: torch.Tensor,
                           pos: torch.Tensor, *, attn_backend: str = "fused",
                           attn_num_work: Optional[int] = None,
                           attn_work_list=None):
    """x [B, 1, D]; pool_l one layer's slice; block_tables [B, NBT] int32;
    pos [B] int32 tokens already cached (-1 = dead slot: its write lands
    in the garbage block and its attention length is 0). Writes the new
    token's K/V, then runs the flat decode kernel (lengths = pos + 1,
    ``attn_num_work`` work items; ``attn_work_list`` is their flat work
    list when the caller built it once for all layers) or the fused
    kernel with all-decode tags (ctx = pos, seg = 1). Returns
    (out [B, 1, D], pool_l)."""
    assert not cfg.sliding_window, "paged decode is full-attention only"
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    if not cfg.learned_pos:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    _check_kv_backend(pool_l, attn_backend)
    BS = pool_l.k.shape[1]
    blk = _table_entry(block_tables, pos[:, None], BS)[:, 0]
    scatter_pool(pool_l, blk, torch.remainder(pos, BS), k[:, 0], v[:, 0])
    if attn_backend == "flat":
        o = paged_decode_attention_flat(
            q[:, 0].contiguous(), pool_l.k, pool_l.v, block_tables, pos + 1,
            num_work=attn_num_work, work_list=attn_work_list)
    else:
        o = paged_mixed_attention(
            q.contiguous(), pool_l.k, pool_l.v, block_tables, pos,
            torch.ones_like(pos), torch.zeros_like(pos),
            *_pool_scales(pool_l), num_work=attn_num_work)
    return o.reshape(B, 1, -1) @ p["wo"], pool_l


def attention_prefill_chunk_paged(p, cfg: ModelConfig, x: torch.Tensor,
                                  pool_l: KVCache,
                                  block_tables: torch.Tensor,
                                  ctx_len: torch.Tensor,
                                  chunk_len: torch.Tensor, *,
                                  attn_backend: str = "fused"):
    """Chunked prefill against the paged pool: x [B, C, D] — B prompt
    chunks of C tokens (rows past ``chunk_len`` are padding);
    block_tables [B, NBT] covering ``ceil((ctx_len + C)/BS)`` rows (the
    tail on the garbage block); ctx_len / chunk_len [B] int32. Writes the
    chunk's K/V at positions ``ctx..ctx+C-1`` (RoPE at the true
    positions), then attends each query causally over the written context
    and its own chunk: the chunked prefill kernel (``flat``) or the fused
    kernel with all-chunk tags. Returns (out [B, C, D], pool_l); rows past
    ``chunk_len`` are zeros."""
    assert not cfg.sliding_window, "paged prefill is full-attention only"
    B, C, _ = x.shape
    ctx = ctx_len.to(torch.int32)
    clen = chunk_len.to(torch.int32)
    positions = ctx[:, None] + torch.arange(C, dtype=torch.int32,
                                            device=ctx.device)[None]
    q, k, v = _project_qkv(p, cfg, x)
    if not cfg.learned_pos:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    _check_kv_backend(pool_l, attn_backend)
    BS = pool_l.k.shape[1]
    scatter_pool(pool_l, _table_entry(block_tables, positions, BS),
                 torch.remainder(positions, BS), k, v)
    q = q.contiguous()
    if attn_backend == "flat":
        o = paged_prefill_attention(q, pool_l.k, pool_l.v, block_tables,
                                    ctx, clen)
    else:
        o = paged_mixed_attention(q, pool_l.k, pool_l.v, block_tables, ctx,
                                  clen, torch.ones_like(ctx),
                                  *_pool_scales(pool_l))
    return o.reshape(B, C, -1) @ p["wo"], pool_l


def attention_mixed_paged(p, cfg: ModelConfig, x_dec: torch.Tensor,
                          x_ck: torch.Tensor, pool_l: KVCache,
                          bt_dec: torch.Tensor, bt_ck: torch.Tensor,
                          pos: torch.Tensor, ctx_len: torch.Tensor,
                          chunk_len: torch.Tensor, *,
                          attn_backend: str = "fused",
                          attn_num_work: Optional[int] = None):
    """The attention of a whole mixed iteration: ONE fused launch, or on
    the ``flat`` backend the flat decode kernel for the decode half and
    the chunked prefill kernel for the chunks (``attn_num_work`` is then
    not taken: the decode half runs the worst-case bucket).

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
    if not cfg.learned_pos:
        qd = apply_rope(qd, pos[:, None], cfg.rope_theta)
        kd = apply_rope(kd, pos[:, None], cfg.rope_theta)
        qc = apply_rope(qc, positions, cfg.rope_theta)
        kc = apply_rope(kc, positions, cfg.rope_theta)

    BS = pool_l.k.shape[1]
    blk_d = _table_entry(bt_dec, pos[:, None], BS)[:, 0]
    blk_c = _table_entry(bt_ck, positions, BS)
    scatter_pool(pool_l, blk_d, torch.remainder(pos, BS), kd[:, 0], vd[:, 0])
    scatter_pool(pool_l, blk_c, torch.remainder(positions, BS), kc, vc)

    if attn_backend == "flat":
        out_d = paged_decode_attention_flat(
            qd[:, 0].contiguous(), pool_l.k, pool_l.v, bt_dec, pos + 1)
        out_c = paged_prefill_attention(qc.contiguous(), pool_l.k, pool_l.v,
                                        bt_ck, ctx, clen)
        return (out_d.reshape(Bd, 1, -1) @ p["wo"],
                out_c.reshape(Bp, C, -1) @ p["wo"], pool_l)
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
    return (out_d.reshape(Bd, 1, -1) @ p["wo"],
            out_c.reshape(Bp, C, -1) @ p["wo"], pool_l)
