"""Live KV migration between instances — the port's copy of
``repro.core.migration``: the multi-round timing model the simulator
prices migrations with, and the KV ops the engines move pieces with.

Multi-round live migration (paper §5 / Llumnix-style): round k copies the
KV written since round k−1 started; rounds shrink geometrically until the
residual is below ``stop_threshold`` tokens, then a brief stop-and-copy
finishes the hand-off. A per-instance concurrency cap (3 transfers) and
skip-if-no-idle-slot flow control are enforced by the
:class:`MigrationManager`.

The wire format is the reference's: a contiguous ``[L, 1, length, Hkv,
Dh]`` piece per pool leaf, whatever the engines' block layouts, so a
piece exported from one engine (or, through numpy, from the JAX package)
imports into any other. The helpers run over every leaf of a pool, so an
int8 pool's gathers and scatters carry its scale leaves (``[L, NB, BS,
Hkv]``); the engines keep the migration wire itself full-width. The slab's
other layouts ship whole: a sliding window's ring ``[L, 1, W, Hkv, Dh]``
and rwkv6's recurrent state ``{"S", "att_prev", "ffn_prev"}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping

import torch

MAX_CONCURRENT = 3            # §5: strict concurrency limit
STOP_THRESHOLD = 256          # tokens left -> stop-and-copy
MAX_ROUNDS = 8


@dataclasses.dataclass(frozen=True)
class MigrationTiming:
    total_s: float            # wall time from start to ownership flip
    stall_s: float            # source decode stall (final round only)
    rounds: int
    bytes_moved: float


def plan_live_migration(tokens: float, decode_tok_per_s: float,
                        bytes_per_token: float, bandwidth: float,
                        stop_threshold: int = STOP_THRESHOLD) -> MigrationTiming:
    """Timing of a multi-round live migration of ``tokens`` KV tokens."""
    bw_tok = bandwidth / max(bytes_per_token, 1e-9)    # tokens/s on the wire
    remaining = float(tokens)
    total = 0.0
    moved = 0.0
    rounds = 0
    while remaining > stop_threshold and rounds < MAX_ROUNDS:
        t = remaining / bw_tok
        total += t
        moved += remaining
        # decode continued during the round: new residual to copy
        remaining = decode_tok_per_s * t
        rounds += 1
    stall = remaining / bw_tok                         # stop-and-copy
    total += stall
    moved += remaining
    return MigrationTiming(total_s=total, stall_s=stall, rounds=rounds + 1,
                           bytes_moved=moved * bytes_per_token)


class MigrationManager:
    """Concurrency + flow control for one instance's outbound transfers."""

    def __init__(self, max_concurrent: int = MAX_CONCURRENT):
        self.max_concurrent = max_concurrent
        self.active: Dict[int, float] = {}     # req_id -> finish time (sim)

    def can_start(self, target_has_idle_slot: bool) -> bool:
        # §5: skip migration entirely if the target has no idle cache slot;
        # requests above the concurrency cap stay on the source.
        return target_has_idle_slot and len(self.active) < self.max_concurrent

    def start(self, req_id: int, finish_time: float) -> None:
        assert len(self.active) < self.max_concurrent
        self.active[req_id] = finish_time

    def finish(self, req_id: int) -> None:
        self.active.pop(req_id, None)


# --------------------------------------------------------------------------
# Real KV movement between engines
# --------------------------------------------------------------------------


def gather_kv_blocks(pool, block_ids: torch.Tensor):
    """A request's physical blocks of a paged pool (leaves ``[L, NB, BS,
    ...]``) in table order: leaves ``[L, nb, BS, ...]``, of the pool's
    own type. ``block_ids`` is an integer tensor on the pool's device."""
    idx = block_ids.long()
    return type(pool)(*(torch.index_select(a, 1, idx) for a in pool))


def scatter_kv_blocks(pool, piece, block_ids: torch.Tensor):
    """Write a gathered piece (leaves ``[L, nb, BS, ...]``, the pool's
    leaf layout) into blocks ``block_ids`` of the pool, IN PLACE;
    returns the pool."""
    idx = block_ids.long()
    for a, p in zip(pool, piece):
        a.index_copy_(1, idx, p.to(a.dtype))
    return pool


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a cache pytree in ``jax.tree.leaves`` order: a
    tensor is its own leaf, a dict's values go by sorted key, a tuple's
    (``KVCache``, ``QuantKVCache``) and a list's in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [a for k in sorted(tree) for a in tree_leaves(tree[k])]
    return [a for t in tree for a in tree_leaves(t)]


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` over every tensor of a cache pytree, the structure kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    out = [tree_map(fn, t) for t in tree]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def kv_bytes(cache) -> float:
    """Bytes held by the leaves of a pool, a slab or a piece, whatever
    its pytree (int8 pools: their scales count; rwkv6: the state)."""
    return float(sum(a.numel() * a.element_size()
                     for a in tree_leaves(cache)))
