"""Pure cost helpers shared by the engine and the server — the port's
copies from ``repro.kernels.cost``: the bucketing policy of table widths,
chunk padding and work buckets, and the routing price of host-tier
prefix hits."""
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
    blocks (pure, so every driver prices a hint identically). The port's
    engines have no host tier yet and always advertise 0 such blocks."""
    return PROMOTE_TOKEN_COST * float(n_blocks) * float(block_size)
