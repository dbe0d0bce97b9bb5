"""Bucketing policy shared by the engine's table widths, chunk padding and
work buckets — the port's copy of ``repro.kernels.cost.pow2_bucket``."""
from __future__ import annotations


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p
