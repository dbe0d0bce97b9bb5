"""The port's own copy of the part of ``repro.serving.block_pool`` that
the engine runs (framework-free, so it is copied, not imported). The
host-RAM tier and preemption parking come with the slice that ports
their engine paths.

Block-granular KV-cache allocator (the vLLM PagedAttention role),
**refcounted and prefix-shared**.

The engine owns one global KV *pool* per model — leaves
``[L, num_blocks, block_size, Hkv, Dh]`` — and every running request owns an
ordered list of physical block ids (its *block table*). Logical token
position ``t`` of a request lives at ``(table[t // BS], t % BS)``.

``BlockAllocator`` hands out physical blocks and tracks three quantities:

  * **referenced** blocks — refcount >= 1, physically backing written KV of
    at least one live request. A *shared* prefix block counts ONCE no
    matter how many requests' tables point at it.
  * **cached** blocks — refcount 0 but still holding a published prefix
    block (reachable through the prefix index). They are *reclaimable*:
    they count as free capacity and are evicted LRU when the free list
    runs dry. ``share`` revives them (0 -> 1) without any copy.
  * **reserved** blocks — the worst-case footprint of every admitted
    request, ``ceil(min(prompt + max_new_tokens, max_seq) / BS)`` minus
    the cached blocks it shares (admission reserves only the uncached
    tail).

Admission gates on *reservations*, growth allocates *incrementally*. With
sharing, the invariant is

    reserved + cached_live <= num_blocks

where ``cached_live`` counts cached blocks that are still referenced by
sharers but whose *allocating owner* has already released them: such a
block outlived the reservation that covered it (sharers reserved only
their tails), so the allocator carries one implicit reservation unit
for it. Every live block is then covered — by a request reservation
(private blocks) or by ``cached_live`` (shared blocks) — hence a
mid-decode allocation can never fail.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` KV rows (>=0)."""
    return max(0, -(-int(tokens) // block_size))


def chain_hash(parent: int, tokens) -> int:
    """Radix-style content digest of one FULL block: 64-bit
    ``hash(parent_hash, block_tokens)``. Deterministic across processes
    (sha1, not Python's randomized hash); collision probability is
    negligible at pool scale — production would verify tokens on hit,
    exactly as vLLM's prefix cache does."""
    h = hashlib.sha1()
    h.update(int(parent).to_bytes(8, "little", signed=True))
    h.update(np.asarray(tokens, np.int32).tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def prompt_chain(prompt, block_size: int,
                 limit: Optional[int] = None) -> List[int]:
    """Chained digests of a prompt's FULL blocks (partial tail excluded).
    ``limit`` caps the number of blocks hashed (lookup caps at
    ``(len(prompt) - 1) // BS`` so a fully-cached identical prompt still
    prefill-computes >= 1 token — the first token needs its logits)."""
    n = len(prompt) // block_size
    if limit is not None:
        n = min(n, limit)
    out: List[int] = []
    parent = 0
    for j in range(n):
        parent = chain_hash(parent, prompt[j * block_size:(j + 1) * block_size])
        out.append(parent)
    return out


@dataclasses.dataclass
class BlockAllocator:
    num_blocks: int
    block_size: int

    def __post_init__(self) -> None:
        assert self.num_blocks > 0 and self.block_size > 0
        # LIFO free list: recently-freed (still-warm) blocks are reused
        # first. The set mirror makes the double-free assert O(1).
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._free_set = set(self._free)
        self._reserved = 0
        self._refs = [0] * self.num_blocks          # per-block refcount
        self._hash_of: Dict[int, int] = {}          # cached block -> digest
        self._index: Dict[int, int] = {}            # digest -> block id
        self._head_digests: set = set()             # depth-1 digests
        # refcount-0 cached blocks, LRU order (dict preserves insertion;
        # least-recently-released first)
        self._reclaimable: Dict[int, None] = {}
        self._cached_live = 0        # cached AND referenced (implicit resv)

    # ---- views -------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Allocatable capacity: the free list plus every reclaimable
        (cached, refcount-0) block — a cache entry never blocks admission."""
        return len(self._free) + len(self._reclaimable)

    @property
    def allocated_blocks(self) -> int:
        """Blocks referenced by at least one live request (shared blocks
        count once)."""
        return self.num_blocks - self.free_blocks

    def allocated_tokens(self) -> int:
        return self.allocated_blocks * self.block_size

    # ---- admission reservation ----------------------------------------------
    def can_reserve(self, n_blocks: int) -> bool:
        return self._reserved + self._cached_live + n_blocks <= self.num_blocks

    def reserve(self, n_blocks: int) -> None:
        assert self.can_reserve(n_blocks), \
            f"reserve({n_blocks}) over capacity " \
            f"({self._reserved}+{self._cached_live}/{self.num_blocks})"
        self._reserved += n_blocks

    def unreserve(self, n_blocks: int) -> None:
        self._reserved -= n_blocks
        assert self._reserved >= 0

    # ---- physical blocks -----------------------------------------------------
    def allocate(self, n_blocks: int) -> List[int]:
        """Pop ``n_blocks`` fresh private block ids (refcount 1). Caller
        must hold a covering reservation — under the invariant this cannot
        fail. When the free list runs dry, refcount-0 cached blocks are
        reclaimed LRU (their index entries drop; their content is about to
        be overwritten)."""
        assert n_blocks <= self.free_blocks, \
            f"allocator invariant broken: want {n_blocks}, " \
            f"free {self.free_blocks}"
        out: List[int] = []
        for _ in range(n_blocks):
            if not self._free:
                self._reclaim_one()
            b = self._free.pop()
            self._free_set.discard(b)
            assert self._refs[b] == 0 and b not in self._hash_of
            self._refs[b] = 1
            out.append(b)
        assert self.allocated_blocks <= self._reserved + self._cached_live, \
            "allocated blocks exceeded reservations"
        return out

    def _reclaim_one(self) -> None:
        """Evict the least-recently-released cached block: drop its index
        entry and hand the physical block back to the free list. Never
        touches a referenced block (those are not in ``_reclaimable``)."""
        b = next(iter(self._reclaimable))
        del self._reclaimable[b]
        assert self._refs[b] == 0
        h = self._hash_of.pop(b)
        self._index.pop(h, None)
        self._head_digests.discard(h)
        self._free.append(b)
        self._free_set.add(b)

    def release(self, block_ids: Sequence[int], *, owned: bool = True) -> None:
        """Drop one reference per block.

        ``owned=True`` means the caller *allocated* these blocks (they were
        covered by its admission reservation); ``owned=False`` means the
        references came from ``share``. The distinction keeps the implicit
        reservation exact: when an owner leaves a cached block behind with
        sharers still referencing it, the block is no longer covered by any
        request reservation, so one ``_cached_live`` unit takes over; the
        last sharer's release retires the unit. A block reaching refcount 0
        goes back to the free list — unless it is published in the prefix
        index, in which case it waits in the reclaimable LRU (free
        capacity, revivable by ``share``)."""
        for b in block_ids:
            assert 0 <= b < self.num_blocks and b not in self._free_set, \
                f"double free / bad block id {b}"
            assert self._refs[b] > 0, f"double free / bad block id {b}"
            self._refs[b] -= 1
            cached = b in self._hash_of
            assert cached or self._refs[b] == 0, \
                f"uncached block {b} was shared"
            if self._refs[b] == 0:
                if cached:                  # keep warm, don't free
                    if not owned:
                        self._cached_live -= 1
                    self._reclaimable[b] = None
                else:
                    self._free.append(b)
                    self._free_set.add(b)
            elif owned:
                # owner leaves, sharers remain: coverage moves from the
                # owner's reservation to the allocator's implicit unit
                self._cached_live += 1

    def share(self, block_ids: Sequence[int]) -> None:
        """Take one reference per block. Reviving a reclaimable cached
        block (0 -> 1) removes it from the LRU and adds its implicit
        reservation unit — see the module invariant."""
        for b in block_ids:
            assert b not in self._free_set, f"share of free block {b}"
            if self._refs[b] == 0:
                assert b in self._reclaimable, f"share of free block {b}"
                del self._reclaimable[b]
                self._cached_live += 1
            self._refs[b] += 1

    # ---- prefix index --------------------------------------------------------
    def publish(self, block_id: int, digest: int, *,
                head: bool = False) -> bool:
        """Register a FULL, written block under its chain digest. First
        writer wins: if the digest is already indexed (a concurrent
        request published the same content) the block stays private and
        ``False`` is returned. The block must be live — its publisher
        still references it. ``head`` marks a chain's first block, which
        :meth:`head_digests` advertises."""
        if digest in self._index:
            return False
        assert self._refs[block_id] > 0, "publish of an unreferenced block"
        assert block_id not in self._hash_of, "block already published"
        self._index[digest] = block_id
        self._hash_of[block_id] = digest
        # no accounting change: the block stays covered by its publisher's
        # reservation until the publisher releases it (see ``release``)
        if head:
            self._head_digests.add(digest)
        return True

    def lookup(self, digests: Sequence[int]) -> List[int]:
        """Longest cached chain: walk ``digests`` (parent-chained, depth
        order) and return the matched block ids — stops at the first miss,
        so the result is always a consistent prefix."""
        out: List[int] = []
        for h in digests:
            b = self._index.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def head_digests(self) -> frozenset:
        """Depth-1 digests currently indexed — the compact per-instance
        advertisement within-stage dispatch tie-breaks on."""
        return frozenset(self._head_digests)

    def revival_cost(self, block_ids: Sequence[int]) -> int:
        """Implicit reservation units ``share`` of these blocks would add:
        refcount-0 (reclaimable) blocks revive into ``_cached_live``.
        Admission gates must charge this alongside the tail reservation —
        otherwise sharing a reclaimable chain could push ``reserved +
        cached_live`` past ``num_blocks`` and break the allocate-cannot-
        fail guarantee."""
        return sum(1 for b in block_ids if self._refs[b] == 0)

    # ---- integrity (tests) ---------------------------------------------------
    def check_invariants(self) -> None:
        assert len(self._free) == len(self._free_set)
        live = sum(1 for r in self._refs if r > 0)
        assert live + self.free_blocks == self.num_blocks
        for b in self._free:
            assert self._refs[b] == 0 and b not in self._hash_of
        for b in self._reclaimable:
            assert self._refs[b] == 0 and b in self._hash_of
            assert b not in self._free_set
        assert 0 <= self._cached_live <= sum(1 for b in self._hash_of
                                             if self._refs[b] > 0)
        assert self._reserved + self._cached_live <= self.num_blocks
        assert {h: b for b, h in self._hash_of.items()} == self._index
        assert self._head_digests <= set(self._index)

    def check_drained(self) -> None:
        """A drained allocator holds NOTHING on behalf of requests: no
        reservations and no referenced blocks. Reclaimable cached chains
        (refcount 0, content-indexed) are fine — they are free capacity
        wearing a name."""
        self.check_invariants()
        assert self._reserved == 0, \
            f"leaked reservations: {self._reserved} blocks"
        assert self.allocated_blocks == 0, \
            f"leaked refcounts: {self.allocated_blocks} blocks still live"
