"""Plain masked-softmax oracles for the contiguous attention kernels — the
port's copy of ``repro.kernels.ref``: straightforward attention in f32
with no tiling, the ground truth the kernel sweeps are held to.

They differ from the kernels only where no key is visible: the softmax of
an all-masked row is uniform over the cache, where the kernels give zeros
(ragged decode, prefill) or the mean over the padded rows (padded decode).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ops import NEG_INF


def decode_attention_ref(q, k, v, lengths):
    """Single-token GQA decode attention.

    q        [B, H, Dh]      — one query token per request
    k, v     [B, S, Hkv, Dh] — KV cache (padded to S)
    lengths  [B] int32       — valid cache length per request
    returns  [B, H, Dh]
    """
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Dh).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(Dh)
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            < lengths[:, None, None, None])
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v.float())
    return out.reshape(B, H, Dh).to(q.dtype)


def prefill_attention_ref(q, k, v, lengths=None):
    """Causal full-sequence GQA attention (flash-prefill oracle).

    q [B, T, H, Dh]; k, v [B, T, Hkv, Dh]; lengths [B] optional padding.
    """
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) / math.sqrt(Dh)
    pos = torch.arange(T, device=q.device)
    mask = (pos[:, None] >= pos[None, :])[None, None, None]
    if lengths is not None:
        valid = pos[None, :] < lengths[:, None]                   # [B, S]
        mask = mask & valid[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", w, v.float())
    return out.reshape(B, T, H, Dh).to(q.dtype)
