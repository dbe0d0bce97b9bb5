"""The port's own copy of ``repro.serving.block_pool`` (framework-free,
so it is copied, not imported): chain hashing, the refcounted prefix-shared
``BlockAllocator`` with preemption parking, and the host-RAM tier
(``HostBlockStore``) that reclaimed cached chains demote to.

Block-granular KV-cache allocator (the vLLM PagedAttention role),
**refcounted and prefix-shared** (DESIGN.md §Prefix cache).

The engine owns one global KV *pool* per model — a pytree whose leaves are
``[L, num_blocks, block_size, Hkv, Dh]`` — and every running request owns an
ordered list of physical block ids (its *block table*). Logical token
position ``t`` of a request lives at ``(table[t // BS], t % BS)``.

``BlockAllocator`` hands out physical blocks and tracks three quantities:

  * **referenced** blocks — refcount >= 1, physically backing written KV of
    at least one live request (true memory pressure; what load/bid
    accounting reports). A *shared* prefix block counts ONCE no matter how
    many requests' tables point at it.
  * **cached** blocks — refcount 0 but still holding a published prefix
    block (reachable through the prefix index). They are *reclaimable*:
    they count as free capacity and are evicted LRU when the free list
    runs dry. ``share`` revives them (0 -> 1) without any copy.
  * **reserved** blocks — the worst-case footprint of every admitted
    request, ``ceil(min(prompt + max_new_tokens, max_seq) / BS)`` minus
    the cached blocks it shares (admission reserves only the uncached
    tail — DESIGN.md §Prefix cache).

Admission gates on *reservations*, growth allocates *incrementally*. With
sharing, the non-negotiable invariant is

    reserved + cached_live <= num_blocks

where ``cached_live`` counts cached blocks that are still referenced by
sharers but whose *allocating owner* has already released them: such a
block outlived the reservation that covered it (sharers reserved only
their tails), so the allocator carries one implicit reservation unit
for it.
Every live block is then covered — by a request reservation (private
blocks) or by ``cached_live`` (shared blocks) — hence a mid-decode
allocation can never fail and ``free_tokens()`` can never go negative.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

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


class HostBlockStore:
    """Capacity-bounded host-RAM tier behind the device pool (DESIGN.md
    §Multi-tier KV). Entries are keyed by chain digest and carry the
    block's KV payload in the migration wire layout (leaves
    ``[L, 1, BS, ...]``; int8 blocks keep their scale leaves), plus the
    parent digest and head flag needed to re-publish on promote.

    The store is LRU over *insertion* order (a demote re-inserts, a
    promote removes), bounded at ``capacity_blocks`` entries. Making room
    evicts the oldest entry AND every host-resident descendant — a child
    whose parent is gone could never be reached by the chain-ordered
    lookup anyway, so cascading keeps capacity honest instead of leaking
    unreachable entries. A digest lives in exactly ONE tier: the
    allocator drops the host entry the moment the same digest is
    re-published on device."""

    def __init__(self, capacity_blocks: int):
        assert capacity_blocks > 0
        self.capacity_blocks = int(capacity_blocks)
        # digest -> (payload, parent_digest, head); dict preserves
        # insertion order = demote order = LRU order
        self._entries: Dict[int, Tuple[Any, int, bool]] = {}
        self._children: Dict[int, Set[int]] = {}    # parent -> host children
        # payloads still pending host materialization (the engine demotes
        # with an async device-side snapshot and flushes to numpy at the
        # end of the step — see Engine._flush_demotes)
        self._pending: Set[int] = set()
        self.drops = 0          # entries destroyed by host capacity pressure

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, digest: int) -> bool:
        return digest in self._entries

    def parent(self, digest: int) -> int:
        return self._entries[digest][1]

    def digests(self) -> frozenset:
        return frozenset(self._entries)

    def head_digests(self) -> frozenset:
        return frozenset(h for h, (_, _, head) in self._entries.items()
                         if head)

    def _unlink(self, digest: int) -> Tuple[Any, int, bool]:
        payload, parent, head = self._entries.pop(digest)
        self._pending.discard(digest)
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(digest)
            if not kids:
                del self._children[parent]
        return payload, parent, head

    def _drop_subtree(self, digest: int) -> None:
        """Destroy an entry and every host-resident descendant."""
        stack = [digest]
        while stack:
            h = stack.pop()
            if h not in self._entries:
                continue
            stack.extend(self._children.get(h, ()))
            self._unlink(h)
            self.drops += 1

    def drop_children_of(self, digest: int) -> None:
        """A parent left BOTH tiers (reclaim-time drop): its host-resident
        descendants can never be reached by the chain-ordered lookup again
        — destroy them so capacity stays honest."""
        for child in list(self._children.get(digest, ())):
            self._drop_subtree(child)

    def discard(self, digest: int) -> None:
        """Remove an entry whose digest was re-published on the device
        tier (single-tier residence; the device copy supersedes, nothing
        is lost, children stay — their parent is resident again)."""
        if digest in self._entries:
            self._unlink(digest)

    def put(self, digest: int, payload: Any, parent: int, *, head: bool,
            parent_ok: Callable[[int], bool]) -> bool:
        """Admit a demoted block. Evicts LRU (+ descendants) to make
        room; if making room destroyed the incoming block's own parent,
        the demote fails (``False``) — the chain would be unreachable."""
        assert digest not in self._entries, "digest already host-resident"
        while len(self._entries) >= self.capacity_blocks:
            self._drop_subtree(next(iter(self._entries)))
        if not parent_ok(parent):
            return False
        self._entries[digest] = (payload, parent, head)
        if parent:
            self._children.setdefault(parent, set()).add(digest)
        self._pending.add(digest)
        return True

    def pop(self, digest: int) -> Any:
        """Remove an entry for promotion and return its payload. Children
        stay: the promoted parent is about to be re-published on device,
        so they remain reachable."""
        payload, _, _ = self._unlink(digest)
        return payload

    def materialize(self, fn: Callable[[Any], Any]) -> int:
        """Apply ``fn`` (device→numpy) to every payload still pending
        host materialization. Returns the number flushed."""
        n = 0
        for h in self._pending:
            if h in self._entries:
                payload, parent, head = self._entries[h]
                self._entries[h] = (fn(payload), parent, head)
                n += 1
        self._pending.clear()
        return n

    def check(self, tier_resident: Callable[[int], bool]) -> None:
        assert len(self._entries) <= self.capacity_blocks, \
            f"host tier over capacity: {len(self._entries)}" \
            f"/{self.capacity_blocks}"
        for h, (_, parent, _) in self._entries.items():
            assert tier_resident(parent), \
                f"host entry {h} has a non-resident parent {parent}"
        for parent, kids in self._children.items():
            for k in kids:
                assert k in self._entries and self._entries[k][1] == parent


@dataclasses.dataclass
class BlockAllocator:
    num_blocks: int
    block_size: int
    # host-RAM tier capacity in blocks (DESIGN.md §Multi-tier KV);
    # 0 disables tiering — reclaim drops chains exactly as before
    host_blocks: int = 0

    def __post_init__(self) -> None:
        assert self.num_blocks > 0 and self.block_size > 0
        # LIFO free list: recently-freed (still-warm) blocks are reused
        # first. The set mirror makes the double-free assert O(1) instead
        # of an O(free-list) membership scan per freed block.
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._free_set = set(self._free)
        self._reserved = 0
        # ---- prefix sharing state (DESIGN.md §Prefix cache) ----
        self._refs = [0] * self.num_blocks          # per-block refcount
        self._hash_of: Dict[int, int] = {}          # cached block -> digest
        self._index: Dict[int, int] = {}            # digest -> block id
        self._head_digests: set = set()             # depth-1 digests (dispatch)
        # refcount-0 cached blocks, LRU order (dict preserves insertion;
        # least-recently-released first)
        self._reclaimable: Dict[int, None] = {}
        self._cached_live = 0        # cached AND referenced (implicit resv)
        # parked blocks (DESIGN.md §SLO scheduling & preemption): per-block
        # count of park-preempted requests pinning it. A parked block keeps
        # its references and its covering reservation — parking frees a
        # batch slot, never memory — so it must not be reclaimed or freed
        # while any parker holds it.
        self._parked: Dict[int, int] = {}
        # ---- host-RAM tier (DESIGN.md §Multi-tier KV) ----
        self._host: Optional[HostBlockStore] = (
            HostBlockStore(self.host_blocks) if self.host_blocks > 0
            else None)
        # digest -> parent digest for every DEVICE-indexed block (0 for
        # chain heads) — demote needs the link to keep host chains
        # promotable, publish populates it
        self._parent_of: Dict[int, int] = {}
        # engine-installed payload snapshot: block id -> device-side KV
        # slice (async; materialized off the hot loop). None = tier off.
        self._demote_fetch: Optional[Callable[[int], Any]] = None
        # telemetry: cache_evictions (the pre-tier counter) splits into
        # demotions (chain went to the host tier) and drops (tier full,
        # disabled, or the chain's head was already gone)
        self.cache_demotions = 0
        self._reclaim_drops = 0
        self.cache_promotions = 0    # host-tier blocks revived onto device

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

    @property
    def cached_blocks(self) -> int:
        """Published blocks currently resident (referenced or reclaimable)."""
        return len(self._hash_of)

    @property
    def reserved_blocks(self) -> int:
        return self._reserved

    def allocated_tokens(self) -> int:
        return self.allocated_blocks * self.block_size

    def free_tokens(self) -> int:
        return self.free_blocks * self.block_size

    def ref(self, block_id: int) -> int:
        return self._refs[block_id]

    @property
    def parked_blocks(self) -> int:
        """Blocks pinned by at least one park-preempted request."""
        return len(self._parked)

    @property
    def headroom_blocks(self) -> int:
        """Blocks an admission gate could still reserve."""
        return self.num_blocks - self._reserved - self._cached_live

    # ---- host-tier views (DESIGN.md §Multi-tier KV) --------------------------
    @property
    def host_tier_enabled(self) -> bool:
        return self._host is not None

    @property
    def host_blocks_used(self) -> int:
        return len(self._host) if self._host is not None else 0

    @property
    def cache_drops(self) -> int:
        """Cached chains destroyed outright: reclaim-time drops (tier
        full/disabled/orphaned chain) plus host-tier capacity evictions."""
        return self._reclaim_drops + (self._host.drops
                                      if self._host is not None else 0)

    @property
    def cache_evictions(self) -> int:
        """Back-compat view of the pre-tier counter: every cached block
        that left the device index under pressure, wherever it went."""
        return self.cache_demotions + self.cache_drops

    def set_demote_fetch(self, fn: Optional[Callable[[int], Any]]) -> None:
        """Install the engine's payload snapshot for demotes: called with
        a block id INSIDE ``allocate`` (before the block is overwritten —
        stream order makes the async device-side copy a consistent
        snapshot), must return the block's KV payload or None to decline."""
        self._demote_fetch = fn

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
        reclaimed LRU (their index entries drop; sharing them is no longer
        possible, their content is about to be overwritten)."""
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
        entry, DEMOTE its content to the host tier when possible, and hand
        the physical block back to the free list. Never touches a
        referenced block (those are not in ``_reclaimable``). Tables
        release head-first, so chains demote in depth order — a child
        always finds its parent already host-resident (or still on
        device); a child whose parent was dropped is dropped too, so a
        partially-destroyed chain can never be promoted."""
        b = next(iter(self._reclaimable))
        del self._reclaimable[b]
        assert self._refs[b] == 0
        h = self._hash_of.pop(b)
        self._index.pop(h, None)
        was_head = h in self._head_digests
        self._head_digests.discard(h)
        parent = self._parent_of.pop(h, 0)
        if self._try_demote(b, h, parent, was_head):
            self.cache_demotions += 1
        else:
            self._reclaim_drops += 1
            if self._host is not None:
                # the digest left both tiers: host descendants (possible
                # after an earlier promote of this block) are unreachable
                self._host.drop_children_of(h)
        self._free.append(b)
        self._free_set.add(b)

    def _tier_resident(self, digest: int) -> bool:
        """A chain link is promotable only while its parent is reachable
        in SOME tier (0 = chain head, no parent)."""
        return (digest == 0 or digest in self._index
                or (self._host is not None and digest in self._host))

    def _try_demote(self, b: int, h: int, parent: int, head: bool) -> bool:
        if self._host is None or self._demote_fetch is None:
            return False
        if not self._tier_resident(parent):
            return False        # orphaned link: could never be looked up
        payload = self._demote_fetch(b)
        if payload is None:
            return False
        return self._host.put(h, payload, parent, head=head,
                              parent_ok=self._tier_resident)

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
        index, in which case it parks in the reclaimable LRU (free
        capacity, revivable by ``share``)."""
        for b in block_ids:
            assert 0 <= b < self.num_blocks and b not in self._free_set, \
                f"double free / bad block id {b}"
            assert self._refs[b] > 0, f"double free / bad block id {b}"
            assert self._refs[b] - 1 >= self._parked.get(b, 0), \
                f"release would strand parked block {b}"
            self._refs[b] -= 1
            cached = b in self._hash_of
            assert cached or self._refs[b] == 0, \
                f"uncached block {b} was shared"
            if self._refs[b] == 0:
                if cached:                  # park, don't free
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

    # back-compat alias (pre-refcount callers allocated everything they free)
    def free(self, block_ids: Sequence[int]) -> None:
        self.release(block_ids, owned=True)

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

    # ---- preemption park/unpark ---------------------------------------------
    def park(self, block_ids: Sequence[int]) -> None:
        """Pin live blocks on behalf of a park-preempted request. The
        parker KEEPS its references and its reservation — parking only
        records that the blocks must survive until ``unpark``. A shared
        block may be parked by several preempted sharers at once."""
        for b in block_ids:
            assert self._refs[b] > 0, f"park of unreferenced block {b}"
            assert b not in self._free_set
            self._parked[b] = self._parked.get(b, 0) + 1
            assert self._refs[b] >= self._parked[b], \
                f"parked count exceeds refs on block {b}"

    def unpark(self, block_ids: Sequence[int]) -> None:
        """Drop one parker from each block (resume or recompute-preempt of
        a parked request). References are untouched — the caller still
        owns them and releases them through the normal paths."""
        for b in block_ids:
            n = self._parked.get(b, 0)
            assert n > 0, f"unpark of unparked block {b}"
            if n == 1:
                del self._parked[b]
            else:
                self._parked[b] = n - 1

    # ---- prefix index --------------------------------------------------------
    def publish(self, block_id: int, digest: int, *, head: bool = False,
                parent: int = 0) -> bool:
        """Register a FULL, written block under its chain digest. First
        writer wins: if the digest is already indexed (a concurrent
        request published the same content) the block stays private and
        ``False`` is returned. The block must be live — its publisher
        still references it. ``parent`` is the chain-parent digest (0 for
        heads), recorded so a later demote keeps the chain promotable; a
        stale host-tier entry under the same digest is superseded by the
        freshly-written device copy (single-tier residence)."""
        if digest in self._index:
            return False
        assert self._refs[block_id] > 0, "publish of an unreferenced block"
        assert block_id not in self._hash_of, "block already published"
        self._index[digest] = block_id
        self._hash_of[block_id] = digest
        self._parent_of[digest] = parent
        if self._host is not None:
            self._host.discard(digest)
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

    def revival_cost(self, block_ids: Sequence[int]) -> int:
        """Implicit reservation units ``share`` of these blocks would add:
        refcount-0 (reclaimable) blocks revive into ``_cached_live``.
        Admission gates must charge this alongside the tail reservation —
        otherwise sharing a parked chain could push ``reserved +
        cached_live`` past ``num_blocks`` and break the allocate-cannot-
        fail guarantee."""
        return sum(1 for b in block_ids if self._refs[b] == 0)

    def head_digests(self) -> frozenset:
        """Depth-1 digests currently indexed — the compact per-instance
        advertisement dispatch tie-breaking consumes (DESIGN.md §Prefix
        cache)."""
        return frozenset(self._head_digests)

    # ---- host tier: tiered lookup + promote (DESIGN.md §Multi-tier KV) ------
    def lookup_tiered(self, digests: Sequence[int]) -> Tuple[List[int],
                                                             List[int]]:
        """Longest chain across BOTH tiers: the device-resident prefix
        (block ids, shareable for free) followed by the contiguous
        host-resident continuation (digests, promotable at a copy cost).
        Stops at the first digest found in neither tier, so each half is
        a consistent chain run and the table layout stays
        [shared device blocks][promoted blocks][private tail]."""
        dev = self.lookup(digests)
        host: List[int] = []
        if self._host is not None:
            for h in digests[len(dev):]:
                if h not in self._host:
                    break
                host.append(h)
        return dev, host

    def host_head_digests(self) -> frozenset:
        """Depth-1 digests resident only in the host tier — advertised
        with a 'host' tier tag so routing prices the promote copy."""
        return (self._host.head_digests() if self._host is not None
                else frozenset())

    def host_pop(self, digest: int):
        """Remove a host-tier entry for promotion and return its payload.
        The caller scatters it into a freshly allocated device block and
        re-publishes the digest there (single-tier residence)."""
        assert self._host is not None
        self.cache_promotions += 1
        return self._host.pop(digest)

    def host_materialize(self, fn) -> int:
        """Flush payloads still pending host materialization (the engine
        calls this once per step, after its single d2h)."""
        return self._host.materialize(fn) if self._host is not None else 0

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
        for b, n in self._parked.items():
            assert n > 0 and self._refs[b] >= n, \
                f"parked block {b} under-referenced"
            assert b not in self._free_set and b not in self._reclaimable
        # device index carries a parent link for every digest it holds
        assert set(self._parent_of) == set(self._index)
        if self._host is not None:
            # host-tier analogue of the device invariant: bounded capacity,
            # single-tier residence, every chain link's parent reachable
            self._host.check(self._tier_resident)
            assert not (self._host.digests() & set(self._index)), \
                "digest resident in both tiers"

    def check_drained(self) -> None:
        """A drained allocator holds NOTHING on behalf of requests: no
        reservations, no parked blocks, no referenced blocks. Reclaimable
        cached chains (refcount 0, content-indexed) are fine — they are
        free capacity wearing a name (DESIGN.md §Fault tolerance: the
        drain-time leak check every server test runs)."""
        self.check_invariants()
        assert self._reserved == 0, \
            f"leaked reservations: {self._reserved} blocks"
        assert not self._parked, f"leaked parked blocks: {self._parked}"
        assert self.allocated_blocks == 0, \
            f"leaked refcounts: {self.allocated_blocks} blocks still live"
