"""Shared attention constants, the flat work list and operand checks, in
torch: the leaf that the kernel wrappers import.

The port's counterpart of ``repro.kernels.ops``. The online-softmax block
core that the Pallas kernels share (``_flash_block_update``/
``_flash_init``/``_flash_finish``) lives inside the CUDA kernels here:
``csrc/mixed_attention.cu`` and, for the others, ``csrc/flash_core.cuh``.
The reference's public ``decode_attention``/``prefill_attention`` entry
points sit above the wrappers, in ``kernels/api.py``.

``LIBRARY`` is the dispatcher's ``repro_torch`` namespace. The
contiguous kernels (#5 ``contiguous_decode``, #6 ``contiguous_prefill``)
launch through an operator of it, with a fake version (the result's
shape, for fake tensors) and a FLOP formula. So a mode that counts a
program's work (``torch.utils.flop_counter``, ``launch.dryrun.Traffic``)
sees a launch as one op over its operands, on the card and in a trace
on fake tensors (``launch.dryrun``) alike.
"""
from __future__ import annotations

import torch

LIBRARY = torch.library.Library("repro_torch", "DEF")

# Finite, as in the JAX package: a fully masked row keeps finite running
# maxima, and ``exp(NEG_INF - m)`` underflows to an exact 0.
NEG_INF = -1e30

# The head dims the attention kernels are built for (one template instance
# each); a model whose head dim is not here routes around them before any
# launch (``models.attention``).
KERNEL_HEAD_DIMS = (64, 128)


def flat_work_list(lengths: torch.Tensor, nbt: int, block_s: int,
                   num_work: int):
    """Flat (request, logical block) work list of the TPU's flattened
    grids, as a torch op on ``lengths``' device.

    Items ``[0, Σ_b ceil(L_b/BS))`` enumerate every request's real blocks
    (request-major, blocks in order); the tail up to ``num_work`` is
    padding aliasing the last request with real work, with ``nbt`` (one
    past the table) as its block index. Caller guarantees
    ``num_work >= Σ_b ceil(L_b/BS)``. Returns int32
    ``(work_req [num_work], work_blk [num_work])``."""
    B = lengths.shape[0]
    lengths = lengths.to(torch.int64)
    nb = torch.clamp(-(-lengths // block_s), min=0)
    offs = torch.cat([nb.new_zeros(1), torch.cumsum(nb, 0)])
    total = offs[-1]
    w = torch.arange(num_work, dtype=torch.int64, device=lengths.device)
    b = torch.clamp(torch.searchsorted(offs, w, right=True) - 1, 0, B - 1)
    j = w - offs[b]
    # last request with any real work (first max of the reversed mask)
    last_b = B - 1 - torch.argmax((nb > 0).flip(0).to(torch.int32))
    pad = w >= total
    return (torch.where(pad, last_b, b).to(torch.int32),
            torch.where(pad, torch.full_like(j, nbt), j).to(torch.int32))


def check_paged_operands(name: str, q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         per_row, head_dims=KERNEL_HEAD_DIMS,
                         max_group=None):
    """Raise unless the operands of an attention kernel are what its CUDA
    build takes: f32/bf16 ``q`` and pools of one dtype, a head dim in
    ``head_dims``, ``H % Hkv == 0`` (and ``H // Hkv <= max_group``), int32
    tables ``[B, NBT]`` and int32 per-row lengths ``[B]``, all contiguous
    on one device. A contiguous cache ``[B, S, Hkv, Dh]`` passes as a pool
    with ``block_tables=None``."""
    B, H, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    Hkv = k_pool.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} is not float32/bfloat16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: pools must share q's dtype")
    if Dh not in head_dims:
        raise ValueError(f"{name}: head dim {Dh} not in {head_dims}")
    if (k_pool.dim() != 4 or k_pool.shape[3] != Dh
            or v_pool.shape != k_pool.shape or H % Hkv
            or (max_group is not None and H // Hkv > max_group)):
        raise ValueError(f"{name}: q {tuple(q.shape)} vs pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    ints = tuple(per_row) if block_tables is None else (block_tables,
                                                         *per_row)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name}: tables and lengths are int32")
    if ((block_tables is not None and (block_tables.dim() != 2
                                       or block_tables.shape[0] != B))
            or any(tuple(t.shape) != (B,) for t in per_row)):
        raise ValueError(f"{name}: tables [B, NBT], lengths [B]")
    tensors = (q, k_pool, v_pool) + ints
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on several devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
