"""Fused mixed-iteration attention over the paged KV pool — one kernel
launch per layer per engine step.

Replaces the TPU kernel ``repro/kernels/mixed_attention.py::
paged_mixed_attention`` (``_mixed_kernel``) with a CUDA kernel written for
Hopper, ``csrc/mixed_attention.cu`` (built and loaded by
:mod:`repro_torch.kernels.build`). The source's header says how it is
recast for parallel thread blocks, what bounds it on the card (the bytes
of K/V read, for decode rows) and what the design does about that.

:func:`paged_mixed_attention` launches the kernel for CUDA tensors — or
raises; it never falls back — and runs :func:`paged_mixed_attention_plain`,
the plain PyTorch version of the same function, only for tensors on the
CPU. ``LAUNCHES`` counts launches of the bf16/f32 mode, ``INT8_LAUNCHES``
those of the int8 mode.

The int8 mode (the TPU kernel's ``quantized=True`` variant) reads an int8
pool with f32 per-(block, position, kv head) scales: the kernel loads the
int8 bytes and dequantizes each row in registers (``int8 -> f32 ×
scale``), so it reads about half the K/V bytes of the bf16 mode; no
dequantized copy of the pool is ever made.

Semantics (those of ``_mixed_kernel``): segment ``s`` has
``total = ctx + seg`` keys. A decode segment (tag 0) attends query row 0
to keys ``idx < total``; a prefill chunk (tag 1) attends row ``r < seg``
to keys ``idx < total`` and ``idx <= ctx + r``. Query head ``h`` reads kv
head ``h // G``. Unlike the TPU kernel, every padding row (rows past a
segment's live rows, all rows of a dead segment) is written as zeros.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ops import NEG_INF

LAUNCHES = 0          # bf16/f32-mode launches by this process (CUDA only)
INT8_LAUNCHES = 0     # int8-mode launches by this process (CUDA only)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("mixed_attention").repro_mixed_attention
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_mixed_attention(q, k_pool, v_pool, block_tables, ctx_lens,
                          seg_lens, tags, k_scale=None, v_scale=None, *,
                          num_work: Optional[int] = None):
    """Fused mixed-iteration attention over a paged KV pool.

    q            [B, C, H, Dh]     — B segments of C query rows; a chunk
                                     uses rows [0, seg), a decode row 0
    k/v_pool     [NB, BS, Hkv, Dh] — one layer's block pool, already
                                     holding every segment's own K/V:
                                     q's dtype, or int8 with the scales
    block_tables [B, NBT] int32    — covering ceil((ctx+seg)/BS) entries
    ctx_lens     [B] int32         — tokens before the segment's queries
    seg_lens     [B] int32         — query rows (decode: 1)
    tags         [B] int32         — 0 = decode row, 1 = prefill chunk
    k/v_scale    [NB, BS, Hkv] f32 — int8 dequant scales (both or neither)
    returns      [B, C, H, Dh] in q's dtype; padding rows are zeros

    ``num_work`` is the TPU kernel's static work bucket; the CUDA grid is
    (segment, kv head, row tile) and does not need it.
    """
    del num_work
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_mixed_attention: give both scales or none")
    if q.device.type == "cpu":
        return paged_mixed_attention_plain(q, k_pool, v_pool, block_tables,
                                           ctx_lens, seg_lens, tags,
                                           k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_mixed_attention: no kernel for {q.device}")
    return _launch(q, k_pool, v_pool, block_tables, ctx_lens, seg_lens, tags,
                   k_scale, v_scale)


def _launch(q, k_pool, v_pool, block_tables, ctx_lens, seg_lens, tags,
            k_scale, v_scale):
    global LAUNCHES, INT8_LAUNCHES
    B, C, H, Dh = q.shape
    NB, BS, Hkv, Dh_k = k_pool.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_mixed_attention: dtype {q.dtype} not in "
                        f"{list(_DTYPES)}")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"paged_mixed_attention: head dim {Dh} not in "
                         f"{_HEAD_DIMS}")
    if Dh_k != Dh or v_pool.shape != k_pool.shape or H % Hkv:
        raise ValueError(f"paged_mixed_attention: q {tuple(q.shape)} vs "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    scales = ()
    if k_scale is None:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise TypeError("paged_mixed_attention: pools must share q's "
                            "dtype (or be int8 with scales)")
    else:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError("paged_mixed_attention: scales need int8 pools")
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.shape != k_pool.shape[:3]
                or v_scale.shape != k_pool.shape[:3]):
            raise ValueError("paged_mixed_attention: scales are f32 "
                             "[NB, BS, Hkv]")
        scales = (k_scale, v_scale)
    ints = (block_tables, ctx_lens, seg_lens, tags)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("paged_mixed_attention: tables and lengths are int32")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or any(t.shape != (B,) for t in ints[1:])):
        raise ValueError("paged_mixed_attention: tables [B, NBT], lengths [B]")
    tensors = (q, k_pool, v_pool) + scales + ints
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_mixed_attention: tensors on several devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged_mixed_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                       k_scale.data_ptr() if scales else None,
                       v_scale.data_ptr() if scales else None,
                       block_tables.data_ptr(), ctx_lens.data_ptr(),
                       seg_lens.data_ptr(), tags.data_ptr(), out.data_ptr(),
                       B, C, H, Hkv, Dh, BS, block_tables.shape[1],
                       _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_mixed_attention: launch failed "
                           f"(cudaError {rc})")
    if scales:
        INT8_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def paged_mixed_attention_plain(q, k_pool, v_pool, block_tables, ctx_lens,
                                seg_lens, tags, k_scale=None, v_scale=None):
    """The same function in plain PyTorch: gather each segment's blocks
    through its table (int8 rows times their scales in f32, as the
    reference dequantizes before the product), then one masked softmax
    per segment (f32)."""
    B, C, H, Dh = q.shape
    BS, Hkv = k_pool.shape[1], k_pool.shape[2]
    G = H // Hkv
    S = block_tables.shape[1] * BS
    bt = block_tables.long()
    k = k_pool[bt].reshape(B, S, Hkv, Dh).float()
    v = v_pool[bt].reshape(B, S, Hkv, Dh).float()
    if k_scale is not None:
        k = k * k_scale[bt].reshape(B, S, Hkv, 1)
        v = v * v_scale[bt].reshape(B, S, Hkv, 1)
    qg = q.float().reshape(B, C, Hkv, G, Dh)
    scores = torch.einsum("bchgd,bshd->bhgcs", qg, k) / math.sqrt(Dh)
    ctx = ctx_lens.long()[:, None]                               # [B, 1]
    total = ctx + seg_lens.long()[:, None]
    chunk = (tags == 1)[:, None]
    r = torch.arange(C, device=q.device)[None]                   # [1, C]
    live = torch.where(chunk, r < seg_lens.long()[:, None], r == 0)
    limit = torch.where(chunk, torch.minimum(total, ctx + r + 1), total)
    limit = torch.where(live & (total > 0), limit, 0)            # [B, C]
    idx = torch.arange(S, device=q.device)
    keep = (idx[None, None] < limit[..., None])[:, None, None]   # [B,1,1,C,S]
    scores = torch.where(keep, scores, NEG_INF)
    p = torch.where(keep, torch.exp(scores - scores.amax(-1, keepdim=True)),
                    0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgcs,bshd->bchgd", p, v) \
        / torch.where(l == 0, 1.0, l).permute(0, 3, 1, 2, 4)
    return out.reshape(B, C, H, Dh).to(q.dtype)
