"""Live KV movement between engines — the port of the KV ops of
``repro.core.migration`` (the multi-round timing model belongs to the
simulator and is not ported yet).

The wire format is the reference's: a contiguous ``[L, 1, length, Hkv,
Dh]`` piece per pool leaf, whatever the engines' block layouts, so a
piece exported from one engine (or, through numpy, from the JAX package)
imports into any other.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import KVCache


def gather_kv_blocks(pool: KVCache, block_ids: torch.Tensor) -> KVCache:
    """A request's physical blocks of a paged pool (leaves ``[L, NB, BS,
    ...]``) in table order: leaves ``[L, nb, BS, ...]``. ``block_ids`` is
    an integer tensor on the pool's device."""
    idx = block_ids.long()
    return KVCache(*(torch.index_select(a, 1, idx) for a in pool))


def scatter_kv_blocks(pool: KVCache, piece: KVCache,
                      block_ids: torch.Tensor) -> KVCache:
    """Write a gathered piece (leaves ``[L, nb, BS, ...]``) into blocks
    ``block_ids`` of the pool, IN PLACE; returns the pool."""
    idx = block_ids.long()
    for a, p in zip(pool, piece):
        a.index_copy_(1, idx, p.to(a.dtype))
    return pool


def kv_bytes(cache) -> float:
    """Bytes held by the leaves of a pool or a piece."""
    return float(sum(a.numel() * a.element_size() for a in cache))
