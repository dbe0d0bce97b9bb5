"""Park-vs-recompute: what to do with a preempted decode's KV — the
port's copy of ``repro.sched.policy``, priced on the port's cost model.

Two exits for a victim (DESIGN.md §SLO scheduling & preemption):

* **park** — keep its KV blocks and allocator reservation, free only
  the batch slot: a bit-identical restore that costs one extra kernel
  launch, but no memory freed.
* **recompute** — release everything and re-enqueue the request with a
  resume prefix (prompt + generated-so-far); chunked prefill rebuilds
  the KV. Frees the victim's blocks at the price of re-running prefill
  attention over ``kv_tokens`` rows.

The decision is priced by the same ``kernels/cost.py`` terms the
simulator trusts: ``recompute_cost_s`` sums ``prefill_chunk_attn_time_s``
over the resume chunks, and parking's restore price is one extra launch
(the spec's ``chip.launch_overhead_s``). When the preemption must free
blocks (memory pressure, not just a slot shortage) parking is useless and
recompute is forced. The engines call the policy without a spec, so they
park whenever they need not free blocks.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.kernels.cost import (H100, AttnSpec,
                                      prefill_chunk_attn_time_s)

# Restoring a parked request costs one extra kernel launch worth of
# overhead (its blocks never moved): the H100's measured launch overhead
# (kernels.cost.H100); a spec on another chip is held to its own.
PARK_RESTORE_COST_S = H100.launch_overhead_s


def recompute_cost_s(kv_tokens: int, spec: AttnSpec,
                     chunk: int = 256) -> float:
    """Time to rebuild ``kv_tokens`` KV rows via chunked prefill."""
    kv_tokens = int(kv_tokens)
    if kv_tokens <= 0:
        return 0.0
    chunk = max(int(chunk), 1)
    t = 0.0
    for ctx in range(0, kv_tokens, chunk):
        t += prefill_chunk_attn_time_s(min(chunk, kv_tokens - ctx), ctx, spec)
    return t + math.ceil(kv_tokens / chunk) * spec.chip.launch_overhead_s


def park_or_recompute(*, must_free_blocks: int, kv_tokens: int,
                      spec: Optional[AttnSpec] = None,
                      chunk: int = 256) -> str:
    """Pick the victim's exit: ``"park"`` or ``"recompute"``.

    ``must_free_blocks > 0`` means the preemptor is blocked on memory,
    not just a slot — parking (which pins the victim's blocks) cannot
    help, so recompute is forced. Otherwise park unless the cost model
    says rebuilding the victim's KV is at least as cheap as the parked
    restore (one launch on the spec's chip; true only for tiny contexts,
    where recompute also returns memory to the pool for free).
    """
    if must_free_blocks > 0:
        return "recompute"
    if spec is not None and (recompute_cost_s(kv_tokens, spec, chunk)
                             <= spec.chip.launch_overhead_s):
        return "recompute"
    return "park"
