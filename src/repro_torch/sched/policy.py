"""Park-vs-recompute: what to do with a preempted decode's KV — the
port's copy of ``repro.sched.policy`` as the engine calls it (no cost
spec).

Two exits for a victim (DESIGN.md §SLO scheduling & preemption):

* **park** — keep its KV blocks and allocator reservation, free only
  the batch slot: a bit-identical restore, but no memory freed.
* **recompute** — release everything and re-enqueue the request with a
  resume prefix (prompt + generated-so-far); chunked prefill rebuilds
  the KV. Frees the victim's blocks at the price of re-running prefill.

When the preemption must free blocks (memory pressure, not just a slot
shortage) parking is useless and recompute is forced; otherwise the
victim parks. The reference can also price the two exits with its cost
model (``recompute_cost_s`` against a one-launch restore); those prices
are TPU v5e constants, and the port's H100 cost model does not exist
yet, so a cost spec is refused here rather than priced with the TPU's
numbers.
"""
from __future__ import annotations

from typing import Optional

# Restore price of a parked request (the reference: one kernel launch of
# its TPU cost model). A named placeholder until the port's H100 cost
# model exists: no decision reads it, and it claims no time on the card.
PARK_RESTORE_COST_S: Optional[float] = None


def park_or_recompute(*, must_free_blocks: int, kv_tokens: int,
                      spec=None, chunk: int = 256) -> str:
    """Pick the victim's exit: ``"park"`` or ``"recompute"``.

    ``must_free_blocks > 0`` means the preemptor is blocked on memory,
    not just a slot, so recompute is forced; otherwise the victim parks.
    ``kv_tokens`` and ``chunk`` size the recompute the reference prices
    when given a ``spec``; the port has no card cost model yet, so a
    ``spec`` raises."""
    del kv_tokens, chunk
    if must_free_blocks > 0:
        return "recompute"
    if spec is not None:
        raise NotImplementedError(
            "pricing park against recompute needs the port's H100 cost "
            "model, which is not written yet")
    return "park"
