"""Prefill attention kernels: chunked causal prefill over the paged pool
(the ``flat`` and ``grid`` backends' chunk kernel) and causal flash
prefill over contiguous caches.

Replaces two TPU kernels of ``repro/kernels/prefill_attention.py`` with
CUDA kernels written for Hopper, built and loaded by
:mod:`repro_torch.kernels.build`:

* ``paged_prefill_attention`` (``_paged_prefill_kernel``) →
  ``csrc/prefill_attention.cu``.
* ``prefill_attention`` (``_prefill_kernel``) →
  ``csrc/contiguous_prefill.cu``.

In bf16 both run the tensor-core walk of ``csrc/tc_walk.cuh`` (TMA,
``wgmma``), fed from the paged pool through the block table or from the
contiguous caches; f32 (and the paged kernel at block sizes that do not
tile 64 keys) runs ``csrc/flash_core.cuh``'s CUDA-core walk.

Each source's header says how it is recast for parallel thread blocks,
what bounds it on the card (the score and P·V products of long prompts)
and what the design does about that.

Each wrapper launches its kernel for CUDA tensors — or raises; it never
falls back — and runs its plain PyTorch version (``*_plain``) only for
tensors on the CPU. The contiguous one launches through the operator
``repro_torch::contiguous_prefill`` (``kernels.ops.LIBRARY``).
``LAUNCHES`` counts the paged kernel's launches, ``CONTIG_LAUNCHES``
the contiguous one's.

Paged semantics (those of ``_paged_prefill_kernel``): query row ``i`` of
chunk ``b`` attends keys ``idx < ctx_b + clen_b`` and ``idx <= ctx_b + i``;
the chunk's own K/V are already in the pool. Rows ``i >= clen_b`` are
padding: the TPU leaves them garbage, the port writes zeros. Contiguous
semantics (those of ``_prefill_kernel``): key ``s`` is visible to query
``t`` iff ``s <= t`` and ``s < length``; a row that sees no key is zeros.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.mixed_attention import paged_mixed_attention_plain
from repro_torch.kernels.ops import LIBRARY, NEG_INF, check_paged_operands

# kernel launches by this process (CUDA path only)
LAUNCHES = 0          # paged (chunked) prefill
CONTIG_LAUNCHES = 0   # contiguous prefill

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_prefill_attention(q, k_pool, v_pool, block_tables, ctx_lens,
                            chunk_lens, *, num_work: Optional[int] = None):
    """Chunked causal prefill attention over a paged KV pool.

    q            [B, C, H, Dh]     — B prompt chunks of C query rows
    k/v_pool     [NB, BS, Hkv, Dh] — one layer's block pool, already
                                     holding each chunk's own K/V
    block_tables [B, NBT] int32    — covering ceil((ctx+C)/BS) entries
    ctx_lens     [B] int32         — tokens written before the chunk
    chunk_lens   [B] int32         — real tokens in the chunk (<= C)
    returns      [B, C, H, Dh] in q's dtype; padding rows are zeros

    ``num_work`` is the TPU kernel's static work bucket; the CUDA grid
    (row tile, kv head, chunk) does not need it.
    """
    del num_work
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, block_tables,
                                             ctx_lens, chunk_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for "
                         f"{q.device}")
    return _launch(q, k_pool, v_pool, block_tables, ctx_lens, chunk_lens)


def _launch(q, k_pool, v_pool, block_tables, ctx_lens, chunk_lens):
    global LAUNCHES
    name = "paged_prefill_attention"
    if q.dim() != 4:
        raise ValueError(f"{name}: q is [B, C, H, Dh], got "
                         f"{tuple(q.shape)}")
    check_paged_operands(name, q, k_pool, v_pool, block_tables,
                         (ctx_lens, chunk_lens))
    B, C, H, Dh = q.shape
    BS, Hkv = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty_like(q)
    if B == 0 or C == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = build.entry("prefill_attention",
                         "repro_paged_prefill_attention", 7, 9)
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), ctx_lens.data_ptr(),
                chunk_lens.data_ptr(), out.data_ptr(), B, C, H, Hkv, Dh, BS,
                block_tables.shape[1], k_pool.shape[0], _DTYPES[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed (cudaError {rc})")
    LAUNCHES += 1
    return out


def paged_prefill_attention_plain(q, k_pool, v_pool, block_tables, ctx_lens,
                                  chunk_lens):
    """The same function in plain PyTorch: every chunk as a prefill
    segment of the mixed plain version."""
    return paged_mixed_attention_plain(q, k_pool, v_pool, block_tables,
                                       ctx_lens, chunk_lens,
                                       torch.ones_like(ctx_lens))


# --------------------------------------------------------------------------
# Contiguous causal prefill
# --------------------------------------------------------------------------
def prefill_attention(q, k, v, lengths=None):
    """Causal GQA flash prefill over contiguous caches.

    q        [B, T, H, Dh]
    k, v     [B, T, Hkv, Dh]
    lengths  [B] int32 valid keys per row (clamped to T), or None = T
    returns  [B, T, H, Dh] in q's dtype: query t over keys s <= t,
             s < length; a row that sees no key is zeros

    A CUDA tensor goes through the operator ``repro_torch::
    contiguous_prefill`` (``kernels.ops.LIBRARY``), whose CUDA version
    launches the kernel; so does a fake tensor off the CPU, which gets
    the operator's fake version (a dry run's trace of the card's
    program, on the meta device)."""
    if lengths is None:
        lengths = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                             device=q.device)
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda" and not isinstance(q, FakeTensor):
        raise ValueError(f"prefill_attention: no kernel for {q.device}")
    name = "prefill_attention"
    if q.dim() != 4 or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"{name}: q [B, T, H, Dh], k, v [B, T, Hkv, Dh]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    check_paged_operands(name, q, k, v, None, (lengths,))
    return torch.ops.repro_torch.contiguous_prefill(q, k, v, lengths)


def _launch_contiguous(q, k, v, lengths):
    """The operator's CUDA version: one launch of the kernel."""
    global CONTIG_LAUNCHES
    B, T, H, Dh = q.shape
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = build.entry("contiguous_prefill",
                         "repro_contiguous_prefill_attention", 5, 6)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), B, T, H, k.shape[2], Dh, _DTYPES[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"prefill_attention: launch failed "
                           f"(cudaError {rc})")
    CONTIG_LAUNCHES += 1
    return out


LIBRARY.define("contiguous_prefill(Tensor q, Tensor k, Tensor v, "
               "Tensor lengths) -> Tensor")
LIBRARY.impl("contiguous_prefill", _launch_contiguous, "CUDA")
torch.library.register_fake("repro_torch::contiguous_prefill",
                            lambda q, k, v, lengths: torch.empty_like(q),
                            lib=LIBRARY)


@register_flop_formula(torch.ops.repro_torch.contiguous_prefill)
def _prefill_flops(q_shape, k_shape, v_shape, lengths_shape,
                   out_shape=None, **kwargs) -> int:
    """The products a causal prompt needs: 4·Dh FLOPs per (query head,
    visible key), T·(T + 1)/2 visible keys a head (whole prompts: a
    shorter ``lengths`` is data the formula does not see)."""
    B, T, H, Dh = q_shape
    return 2 * B * H * Dh * T * (T + 1)


def prefill_attention_plain(q, k, v, lengths):
    """The same function in plain PyTorch, in f32: visible keys weigh
    ``exp(s - max)``, hidden ones 0, and ``acc / l`` with ``l = 0 -> 1``.
    One batch row at a time, so the [H, T, T] scores are the largest
    temporary."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    pos = torch.arange(T, device=q.device)
    causal = pos[None, :] <= pos[:, None]                      # [t, s]
    lengths = lengths.to(torch.int64).clamp(0, T)
    out = torch.empty_like(q)
    for b in range(B):
        qg = q[b].reshape(T, Hkv, G, Dh).float()
        s = torch.einsum("thgd,shd->hgts", qg, k[b].float()) / math.sqrt(Dh)
        keep = causal & (pos[None, :] < lengths[b])
        s = torch.where(keep, s, NEG_INF)
        p = torch.where(keep, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("hgts,shd->thgd", p / torch.where(l == 0, 1.0, l),
                         v[b].float())
        out[b] = o.reshape(T, H, Dh).to(q.dtype)
    return out
