"""Chunked causal prefill attention over the paged pool — the ``flat``
backend's prefill kernel.

Replaces the TPU kernel ``repro/kernels/prefill_attention.py::
paged_prefill_attention`` (``_paged_prefill_kernel``) with a CUDA kernel
written for Hopper, ``csrc/prefill_attention.cu`` (built and loaded by
:mod:`repro_torch.kernels.build`). The source's header says how it is
recast for parallel thread blocks, what bounds it on the card (the score
and P·V products of long chunks) and what the design does about that.

:func:`paged_prefill_attention` launches the kernel for CUDA tensors — or
raises; it never falls back — and runs
:func:`paged_prefill_attention_plain`, the plain PyTorch version of the
same function, only for tensors on the CPU. ``LAUNCHES`` counts kernel
launches.

Semantics (those of ``_paged_prefill_kernel``): query row ``i`` of chunk
``b`` attends keys ``idx < ctx_b + clen_b`` and ``idx <= ctx_b + i``; the
chunk's own K/V are already in the pool. Rows ``i >= clen_b`` are padding:
the TPU leaves them garbage, the port writes zeros.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mixed_attention import paged_mixed_attention_plain
from repro_torch.kernels.ops import check_paged_operands

LAUNCHES = 0          # kernel launches by this process (CUDA path only)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("prefill_attention").repro_paged_prefill_attention
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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

    ``num_work`` is the TPU kernel's static work bucket; the CUDA grid is
    (chunk, kv head, row tile) and does not need it.
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
        rc = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                       block_tables.data_ptr(), ctx_lens.data_ptr(),
                       chunk_lens.data_ptr(), out.data_ptr(), B, C, H, Hkv,
                       Dh, BS, block_tables.shape[1], _DTYPES[q.dtype],
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
