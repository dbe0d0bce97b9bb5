"""Pure cost helpers shared by the engine and the server — the port's
copies from ``repro.kernels.cost``: the bucketing policy of table widths,
chunk padding and work buckets, the routing price of host-tier prefix
hits, and the bytes a KV element takes in the pool. No time constant of
the reference's TPU cost model is copied: the port's H100 cost model is
still to be written."""
from __future__ import annotations

# routing price of one host-tier cached token: the h2d copy is ~4x cheaper
# than recomputing the token's prefill, so a host hit is priced as a
# quarter-length prompt tail
PROMOTE_TOKEN_COST = 0.25


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p


def promote_cost_tokens(n_blocks: int, block_size: int) -> float:
    """Token-equivalent ROUTING price of promoting ``n_blocks`` host-tier
    blocks: a host hit is cheaper than recompute but not free, so routing
    charges ``uncached_tail + this`` instead of treating it like a device
    hit. Pure, so the server and the reference price a hint identically
    (``Engine.prefix_hint`` reports the host-tier blocks of a hit)."""
    return PROMOTE_TOKEN_COST * float(n_blocks) * float(block_size)


def kv_bytes_per_elem(kv_dtype: str, head_dim: int) -> float:
    """Device bytes per stored KV element. int8 carries one f32 scale per
    (position, kv-head) row amortized over the head dim — ``(Dh + 4)/Dh``
    bytes, about 1.94x denser than bf16 at Dh = 128."""
    if kv_dtype == "int8":
        return 1.0 + 4.0 / head_dim
    assert kv_dtype == "bf16", kv_dtype
    return 2.0
