"""Shared attention constants and the flat work list, in torch.

The port's counterpart of the framework-level parts of
``repro.kernels.ops``. The online-softmax block core that the Pallas
kernels share (``_flash_block_update``/``_flash_init``/``_flash_finish``)
lives inside the CUDA kernel here (``csrc/mixed_attention.cu``).
"""
from __future__ import annotations

import torch

# Finite, as in the JAX package: a fully masked row keeps finite running
# maxima, and ``exp(NEG_INF - m)`` underflows to an exact 0.
NEG_INF = -1e30


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
