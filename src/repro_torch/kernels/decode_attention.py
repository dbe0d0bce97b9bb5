"""Flat-work-list paged decode attention — the ``flat`` backend's decode
kernel.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::
paged_decode_attention_flat`` (``_flat_paged_kernel``) with a CUDA kernel
written for Hopper, ``csrc/decode_attention.cu`` (built and loaded by
:mod:`repro_torch.kernels.build`). The source's header says how the
sequential flat work list is recast for parallel thread blocks (runs of
consecutive items, partial softmax states merged in a second pass), what
bounds it on the card (the bytes of K/V read) and what the design does
about that.

:func:`paged_decode_attention_flat` launches the kernel for CUDA tensors —
or raises; it never falls back — and runs
:func:`paged_decode_attention_flat_plain`, the plain PyTorch version of
the same function, only for tensors on the CPU. ``LAUNCHES`` counts
kernel launches (one per call: both passes).

Semantics (those of ``_flat_paged_kernel``): request ``b`` attends its one
query token, query head ``h`` reading kv head ``h // G``, to keys
``idx < lengths[b]``. A dead slot (length 0) has no work items; the TPU
leaves its row unwritten, the port writes zeros.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mixed_attention import paged_mixed_attention_plain
from repro_torch.kernels.ops import check_paged_operands, flat_work_list

LAUNCHES = 0          # kernel launches by this process (CUDA path only)

# consecutive work items (request, logical block) one thread block walks
ITEMS_PER_RUN = 8
_MAX_GROUP = 16       # query heads per kv head the kernel's row tile holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("decode_attention").repro_decode_attention_flat
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_decode_attention_flat(q, k_pool, v_pool, block_tables, lengths,
                                *, num_work: Optional[int] = None,
                                work_list=None):
    """Decode GQA attention over a paged KV pool, by flat work list.

    q            [B, H, Dh]        — one query token per request
    k/v_pool     [NB, BS, Hkv, Dh] — one layer's block pool
    block_tables [B, NBT] int32    — covering ceil(lengths/BS) entries
    lengths      [B] int32         — valid tokens (pos + 1; 0 = dead slot)
    num_work     — static bucket >= Σ_b ceil(lengths_b/BS) work items
                   (None: the worst case B·NBT)
    work_list    — ``flat_work_list(lengths, NBT, BS, num_work)`` when the
                   caller has it: every layer of a decode forward shares
                   one (its ~25 small torch ops cost more host time than
                   the kernel takes on the card); None builds it here
    returns      [B, H, Dh] in q's dtype; dead slots are zeros
    """
    if q.device.type == "cpu":
        return paged_decode_attention_flat_plain(q, k_pool, v_pool,
                                                 block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_flat: no kernel for "
                         f"{q.device}")
    return _launch(q, k_pool, v_pool, block_tables, lengths, num_work,
                   work_list)


def _launch(q, k_pool, v_pool, block_tables, lengths, num_work, work_list):
    global LAUNCHES
    name = "paged_decode_attention_flat"
    if q.dim() != 3:
        raise ValueError(f"{name}: q is [B, H, Dh], got {tuple(q.shape)}")
    check_paged_operands(name, q, k_pool, v_pool, block_tables, (lengths,),
                         max_group=_MAX_GROUP)
    B, H, Dh = q.shape
    BS, Hkv = k_pool.shape[1], k_pool.shape[2]
    NBT = block_tables.shape[1]
    W = num_work if num_work is not None else B * NBT
    out = torch.empty_like(q)
    if B == 0:
        return out
    if W < 1:
        raise ValueError(f"{name}: num_work {W} < 1")
    if work_list is None:
        work_list = flat_work_list(lengths, NBT, BS, W)
    work_req, work_blk = work_list
    if tuple(work_req.shape) != (W,) or tuple(work_blk.shape) != (W,):
        raise ValueError(f"{name}: work list of {tuple(work_req.shape)} "
                         f"items for num_work {W}")
    G = H // Hkv
    part_acc = torch.empty(W * Hkv * G * Dh, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(W * Hkv * G * 2, dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                       block_tables.data_ptr(), lengths.data_ptr(),
                       work_req.data_ptr(), work_blk.data_ptr(),
                       part_acc.data_ptr(), part_ml.data_ptr(),
                       out.data_ptr(), B, H, Hkv, Dh, BS, NBT, W,
                       ITEMS_PER_RUN, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed (cudaError {rc})")
    LAUNCHES += 1
    return out


def paged_decode_attention_flat_plain(q, k_pool, v_pool, block_tables,
                                      lengths):
    """The same function in plain PyTorch: each request as a decode
    segment (ctx = length - 1, one row) of the mixed plain version."""
    ones = torch.ones_like(lengths)
    return paged_mixed_attention_plain(
        q[:, None], k_pool, v_pool, block_tables, lengths - ones, ones,
        torch.zeros_like(lengths))[:, 0]
