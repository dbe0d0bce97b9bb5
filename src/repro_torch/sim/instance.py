"""Simulated inference instance: iteration-level continuous batching —
the port's copy of ``repro.sim.instance``, whole.

Mirrors the serving engine's execution model (§2.2 + DESIGN.md §Chunked
prefill): at each iteration the instance admits waiting requests under
its token-memory budget (batch cap 1024) and advances every
fully-prefilled request by one token. With ``prefill_budget`` set, the
iteration is **mixed** exactly like ``serving.Engine``: up to that many
prompt-chunk tokens (oldest request first) prefill beside the full decode
batch, priced by ``costmodel.mixed_iter_time`` — a long prompt stretches
across many iterations instead of freezing the batch, and its request
produces its first token only when the last chunk lands. With
``prefill_budget=None`` the legacy whole-prompt model applies: admission
prefills the entire prompt in the admission iteration
(``costmodel.prefill_time``) — the §2.1 head-of-line baseline.

Simplifications vs. vLLM (noted in DESIGN.md): admission reserves the
prompt only (no preemption/swap on overflow — outputs are finite and the
budget check keeps overflow marginal).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.core.migration import MigrationManager
from repro_torch.sched.slo import (aging_promotion, insert_sorted, priority_of,
                             queue_key, tpot_hopeless)
from repro_torch.serving.block_pool import blocks_for
from repro_torch.sim.costmodel import (HardwareProfile, decode_iter_time,
                                 demote_time, mixed_iter_time, prefill_time,
                                 promote_time)
from repro_torch.sim.workload import Request

BATCH_CAP = 1024   # vLLM official default (paper §6.1)
KV_BLOCK_SIZE = 16  # paged-cache allocation unit (mirrors serving.Engine)


@dataclasses.dataclass
class SimRequest:
    req: Request
    length: int                      # current sequence length
    generated: int = 0
    # prefill progress (chunked instances): prompt tokens written to
    # cache. Monolithic instances set it to input_len at admission; a
    # migrated half-prefilled request carries it to the receiver.
    ctx_done: int = 0
    # prompt tokens backed by the instance's shared prefix store
    # (block-aligned, mirrors ServeRequest.cached_tokens): these blocks
    # are counted once per group, not once per sharer, and their prefill
    # never runs. Reset to 0 on migration — a shared prefix re-imports
    # as private (DESIGN.md §Prefix cache).
    cached_tokens: int = 0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    migrating: bool = False
    rejected: bool = False           # oversized for any instance: failed
    # fault tolerance (DESIGN.md §Fault tolerance): failed = retry budget
    # exhausted after its instance died (excluded from `served` like
    # rejected); redispatches = dead-instance recoveries this request
    # survived (each replays prompt + generated-so-far elsewhere)
    failed: bool = False
    redispatches: int = 0
    # per-instance output-token counts (paper Fig. 16 CV metric)
    tokens_by_instance: Dict[int, int] = dataclasses.field(default_factory=dict)
    # batch-feature accumulators for QoE profiling (avg loads over lifetime)
    feat_sum: List[float] = dataclasses.field(
        default_factory=lambda: [0.0] * 5)
    feat_iters: int = 0
    # --- SLO scheduling & preemption (mirrors ServeRequest) ---
    # recompute-preemption resume state: rows chunked prefill must rebuild
    # (= prompt + generated-so-far minus the pending last token) before
    # decoding continues. None = not resuming.
    resume_target: Optional[int] = None
    # waiting-queue sort key (repro_torch.sched.slo.queue_key)
    sched_key: Optional[tuple] = None
    preemptions: int = 0
    # starvation/aging guard (mirrors ServeRequest.preempted_step): sim
    # time of the recompute preemption that re-enqueued this request
    preempted_t: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.generated >= self.req.output_len

    @property
    def prefill_target_len(self) -> int:
        """Rows prefill must write before decode (re)starts."""
        return (self.resume_target if self.resume_target is not None
                else self.req.input_len)

    @property
    def prefilling(self) -> bool:
        return self.ctx_done < self.prefill_target_len

    @property
    def kv_len(self) -> int:
        """Cache rows that physically exist: the written prompt part plus
        every generated token (= ``length`` once prefill is done). This —
        not the full ``length`` — is what pins memory and what a
        migration ships. Mid-recompute only the rebuilt rows exist."""
        if self.resume_target is not None:
            return self.ctx_done
        return self.ctx_done + self.generated

    @property
    def normalized_latency(self) -> float:
        assert self.finish_t is not None
        return (self.finish_t - self.req.arrival) / max(self.req.output_len, 1)

    @property
    def ttft(self) -> float:
        assert self.first_token_t is not None
        return self.first_token_t - self.req.arrival

    @property
    def tpot(self) -> float:
        assert self.finish_t is not None and self.first_token_t is not None
        return ((self.finish_t - self.first_token_t)
                / max(self.req.output_len - 1, 1))


class Instance:
    def __init__(self, inst_id: int, profile: HardwareProfile,
                 capacity_tokens: float, events, *,
                 batch_cap: int = BATCH_CAP,
                 block_size: int = KV_BLOCK_SIZE,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = True,
                 preemption: bool = False,
                 host_kv_blocks: int = 0):
        self.id = inst_id
        self.profile = profile
        self.block_size = block_size
        # chunked mixed iterations (DESIGN.md §Chunked prefill); None =
        # legacy monolithic prefill-at-admission
        self.prefill_budget = prefill_budget
        self._iter_chunks: List = []     # (sr, chunk_len) planned this iter
        # group-granular prefix-cache mirror (DESIGN.md §Prefix cache):
        # prefix_group -> shareable blocks, published when a group member
        # finishes prefill. Mirrors the engine's content-hashed index at
        # the granularity the workload generator defines; needs chunked
        # iterations (warm admissions resume mid-prompt). Unreferenced
        # entries cost nothing (the real allocator parks them reclaimable
        # = free); sim runs never model reclaim-under-pressure.
        self.prefix_cache = prefix_cache and prefill_budget is not None
        self._prefix_store: Dict[int, int] = {}
        # multi-tier KV mirror (DESIGN.md §Multi-tier KV): with a host
        # budget, published groups whose blocks have NO live sharer pin
        # device capacity (the engine's refcount-0 parked chains) until
        # memory-pressure demotes them — group-granular — into
        # ``_host_store`` (insertion order = LRU, capacity-bounded in
        # blocks). A later hit promotes the group back, charging the h2d
        # staging time. host_kv_blocks == 0 keeps the legacy model
        # bit-for-bit: idle published groups cost nothing and are never
        # demoted (the sim's old no-reclaim simplification).
        self.host_kv_blocks = int(host_kv_blocks) if self.prefix_cache else 0
        self._host_store: Dict[int, int] = {}
        self.cache_demotions = 0
        self.cache_drops = 0
        self.cache_promotions = 0
        self.promoted_blocks_total = 0
        self._tier_io_s = 0.0    # staged copies charged to this iteration
        # capacity is block-granular: what a paged allocator can actually
        # hand out (tokens that don't fill a block can't back any request)
        self.capacity_blocks = int(capacity_tokens // block_size)
        self.capacity = float(self.capacity_blocks * block_size)
        self.events = events
        self.batch_cap = batch_cap
        self.waiting: Deque[SimRequest] = deque()
        self.running: List[SimRequest] = []
        # SLO-tiered preemptive scheduling (mirrors serving.Engine): off =
        # bit-parity FCFS legacy. Parked requests hold KV (counted by
        # kv_blocks) but no batch seat.
        self.slo_sched = bool(preemption)
        self.parked: List[SimRequest] = []
        self._seq = 0
        self.preemptions = 0
        self.preempt_recomputes = 0
        self.resumes = 0
        # TPOT-deadline admission (mirrors serving.Engine.tpot_skipped)
        self.tpot_skipped = 0
        self._tpot_hopeless_ids: set = set()
        self.iterating = False
        self.migrations = MigrationManager()
        self.inbound_reserved = 0.0      # tokens reserved for inbound transfers
        # ---- fault state (DESIGN.md §Fault tolerance) ----
        self.alive = True
        # epoch fences stale events: crash bumps it, and a pre-crash
        # iteration-end callback from the event queue no-ops instead of
        # mutating the revived instance
        self.epoch = 0
        self.slowdown = 1.0              # iteration-duration multiplier
        self._down_since: Optional[float] = None
        self.downtime_total = 0.0
        # hooks set by the cluster/policy
        self.on_iteration_end: Optional[Callable] = None
        self.on_request_done: Optional[Callable] = None
        # accounting
        self.busy_until = 0.0
        self.tokens_out = 0
        self.throughput_est = 1000.0     # tokens/s EMA (bid payloads)

    # ---- load views -------------------------------------------------------
    def kv_blocks(self) -> int:
        """Physical cache blocks allocated to running requests + inbound
        transfers: each request pins ceil(length/BS) blocks — the paged
        allocator's true memory pressure (matches serving.Engine), which is
        what bid-ask and refinement accounting see. Waiting requests hold
        NO cache (vLLM semantics) — counting them against the budget
        deadlocks admission under tight memory."""
        bs = self.block_size
        # inbound_reserved is a sum of already block-rounded per-transfer
        # amounts (cluster reserves block_tokens(length) per migration), so
        # dividing the total keeps per-transfer granularity. Resident
        # requests pin kv_len (not length): a half-prefilled prompt pins
        # only its written blocks — and a group's shared prefix blocks
        # pin ONCE, no matter how many sharers reference them (the deepest
        # live sharer defines the resident depth, mirroring the refcounted
        # allocator where blocks beyond it are refcount-0 reclaimable).
        shared_depth: Dict[int, int] = {}
        private = 0
        for r in self.running + self.parked:    # parked KV stays pinned
            cb = r.cached_tokens // bs
            private += blocks_for(r.kv_len, bs) - cb
            if cb:
                g = r.req.prefix_group
                shared_depth[g] = max(shared_depth.get(g, 0), cb)
        if self.host_kv_blocks > 0:
            # tiered model: a published group's FULL chain stays device-
            # resident (the engine's refcount-0 parked blocks) until a
            # memory-pressure demote moves it to the host tier — so idle
            # prefixes genuinely pin capacity, exactly what makes
            # demotion fire under the same pressure the engine feels
            for g, blocks in self._prefix_store.items():
                shared_depth[g] = max(shared_depth.get(g, 0), blocks)
        return (private + sum(shared_depth.values())
                + blocks_for(self.inbound_reserved, bs))

    def kv_tokens(self) -> float:
        """Block-rounded tokens of cache memory held (allocation
        granularity, not raw sequence lengths)."""
        return float(self.kv_blocks() * self.block_size)

    def block_tokens(self, tokens: float) -> float:
        """Round a token count up to the allocator's block granularity."""
        return float(blocks_for(tokens, self.block_size) * self.block_size)

    def mem_tokens(self) -> float:
        return self.kv_tokens()

    def free_tokens(self) -> float:
        return float((self.capacity_blocks - self.kv_blocks())
                     * self.block_size)

    def queued_tokens(self) -> float:
        """UN-PREFILLED, UNCACHED prompt tokens: whole waiting prompts
        (minus their prefix-store hit, estimated at enqueue) plus the
        unwritten remainder of running requests mid-chunked-prefill
        (mirrors ``serving.Engine.queued_tokens``)."""
        return float(sum(r.prefill_target_len - r.cached_tokens
                         for r in self.waiting)
                     + sum(r.prefill_target_len - r.ctx_done
                           for r in self.running if r.prefilling))

    def load(self) -> float:
        """Token-level load (LoadTracker metric): KV pressure + queue."""
        return self.kv_tokens() + self.queued_tokens()

    def request_view(self) -> List:
        """(input_len, current_len) pairs for refinement exchanges."""
        return [(float(r.req.input_len), float(r.length))
                for r in self.running]

    # ---- prefix cache (DESIGN.md §Prefix cache) ----------------------------
    def cached_tokens_for(self, sr: SimRequest) -> int:
        """Prompt tokens this instance's prefix stores — device OR host
        tier — could serve right now (block-aligned; capped so >= 1
        token always re-prefils — mirrors the engine's capped tiered
        chain lookup). A host-tier hit skips the same prefill work; it
        just pays the promote staging time at admission."""
        g = sr.req.prefix_group
        if not self.prefix_cache or g < 0:
            return 0
        blocks = self._prefix_store.get(g)
        if blocks is None:
            blocks = self._host_store.get(g)
        if blocks is None:
            return 0
        cap = (sr.req.input_len - 1) // self.block_size
        return min(blocks, cap) * self.block_size

    def host_blocks_for(self, sr: SimRequest) -> int:
        """Blocks a hit by ``sr`` would have to PROMOTE from the host
        tier (0 for device-resident or missing groups) — the quantity
        tier-aware routing prices via ``promote_cost_tokens``."""
        g = sr.req.prefix_group
        if not self.prefix_cache or g < 0 or g not in self._host_store:
            return 0
        cap = (sr.req.input_len - 1) // self.block_size
        return min(self._host_store[g], cap)

    def prefix_digests(self) -> frozenset:
        """Published prefix groups (either tier) — the sim's analogue of
        the engine's head-digest advertisement."""
        return frozenset(self._prefix_store) | frozenset(self._host_store)

    def tiered_digests(self) -> Dict[int, str]:
        """group -> "device"|"host" (single-tier residence: a group lives
        in exactly one store). Mirrors ``Engine.tiered_digests``."""
        out = {g: "device" for g in self._prefix_store}
        for g in self._host_store:
            out.setdefault(g, "host")
        return out

    def _live_shared_depth(self, group: int) -> int:
        """Deepest live sharer's cached blocks for ``group`` — prefix
        blocks beyond it have refcount 0 in the engine (parked), so an
        admission that uses them must pay their revival."""
        bs = self.block_size
        return max((r.cached_tokens // bs for r in self.running + self.parked
                    if r.req.prefix_group == group), default=0)

    def _publish_prefix(self, sr: SimRequest) -> None:
        """A group member finished prefill: its shared prefix becomes
        servable (first publisher wins; its own prefix blocks convert
        from private to shared accounting, mirroring the engine where
        sharers reference the publisher's physical blocks)."""
        g = sr.req.prefix_group
        if not self.prefix_cache or g < 0 or g in self._prefix_store:
            return
        blocks = sr.req.prefix_len // self.block_size
        if blocks <= 0:
            return
        self._prefix_store[g] = blocks
        self._host_store.pop(g, None)   # single-tier residence
        sr.cached_tokens = max(sr.cached_tokens, blocks * self.block_size)

    # ---- multi-tier KV (DESIGN.md §Multi-tier KV) --------------------------
    def _demote_idle_prefixes(self, keep_group: int) -> bool:
        """Memory-pressure reclaim mirror: the engine's allocator, out of
        free blocks, reclaims refcount-0 cached chains — demoting them
        to the host tier. Group-granular here: every published group
        with no live sharer (except the admission candidate's own) moves
        to the host store, freeing its device blocks. Returns True if
        anything was demoted (caller retries the admission gate, exactly
        like the allocator's reclaim-then-allocate)."""
        if self.host_kv_blocks <= 0:
            return False
        freed = False
        for g in list(self._prefix_store):
            if g == keep_group:
                continue
            if any(r.req.prefix_group == g and r.cached_tokens > 0
                   for r in self.running + self.parked):
                continue               # live sharers pin the chain
            self._host_put(g, self._prefix_store.pop(g))
            freed = True
        return freed

    def _host_put(self, g: int, blocks: int) -> None:
        """Insert a demoted group into the capacity-bounded host store
        (LRU eviction destroys whole groups — the store's analogue of the
        engine's subtree drops)."""
        if blocks > self.host_kv_blocks:
            self.cache_drops += 1      # can never fit: destroyed outright
            return
        while (sum(self._host_store.values()) + blocks
               > self.host_kv_blocks):
            self._host_store.pop(next(iter(self._host_store)))
            self.cache_drops += 1
        self._host_store[g] = blocks
        self.cache_demotions += 1
        self._tier_io_s += demote_time(blocks, self.profile,
                                       self.block_size)

    def _promote_group(self, sr: SimRequest) -> None:
        """An admission hit a host-resident group: stage its blocks back
        to the device tier, charging the h2d copy to this iteration (the
        engine overlaps the copy with the running mixed iteration; the
        sim charges the same staging time into the iteration length)."""
        if self.host_blocks_for(sr) <= 0:
            return
        g = sr.req.prefix_group
        blocks = self._host_store.pop(g)
        self._prefix_store[g] = blocks
        self.cache_promotions += 1
        self.promoted_blocks_total += blocks
        self._tier_io_s += promote_time(blocks, self.profile,
                                        self.block_size)

    # ---- request intake ---------------------------------------------------
    def enqueue(self, sr: SimRequest, t: float) -> None:
        # prefix-hit hint for queued_tokens/load while the request waits
        # (refreshed authoritatively at admission)
        sr.cached_tokens = self.cached_tokens_for(sr)
        if self.slo_sched:
            self._seq += 1
            sr.sched_key = queue_key(
                sr.req.slo_class, sr.req.arrival,
                sr.req.input_len + sr.req.output_len, self._seq)
            insert_sorted(self.waiting, sr)
        else:
            self.waiting.append(sr)
        self.kick(t)

    def adopt_running(self, sr: SimRequest, t: float) -> None:
        """Receive a migrated (still-decoding) request."""
        self.running.append(sr)
        self.kick(t)

    # ---- faults (DESIGN.md §Fault tolerance) --------------------------------
    def crash(self, t: float) -> None:
        """Hard-kill: all resident state is lost. The control plane's
        liveness machinery discovers the death (heartbeats stop) and
        recovers the residents; ``clear_crashed`` wipes the carcass."""
        self.alive = False
        self.epoch += 1                  # fence queued iteration-end events
        self.iterating = False
        self._down_since = t

    def revive(self, t: float) -> None:
        """Rejoin empty (state was wiped at death)."""
        self.alive = True
        if self._down_since is not None:
            self.downtime_total += t - self._down_since
            self._down_since = None

    def downtime_s(self, now: float) -> float:
        extra = (now - self._down_since) if self._down_since is not None \
            else 0.0
        return self.downtime_total + extra

    def clear_crashed(self) -> None:
        """Wipe every resident structure (ClusterOps.instance_down): the
        KV, queues and transfer reservations died with the process."""
        self.waiting.clear()
        self.running.clear()
        self.parked.clear()
        self._prefix_store.clear()
        self._host_store.clear()
        self._tier_io_s = 0.0
        self._iter_chunks = []
        self.inbound_reserved = 0.0
        self.migrations = MigrationManager()
        self.iterating = False

    # ---- iteration machinery ----------------------------------------------
    def kick(self, t: float) -> None:
        if not self.alive:
            return
        if self.iterating or (not self.waiting and not self.running
                              and not self.parked):
            return
        self.iterating = True
        self._start_iteration(t)

    def _start_iteration(self, t: float) -> None:
        admitted: List[SimRequest] = []
        if self.slo_sched:
            self._age_waiting(t)
            self._resume_ready()
        chunks: List = []                       # (sr, chunk_len) this iter
        budget = self.prefill_budget
        if budget is not None:
            # resume in-progress chunked prefills, oldest admitted first
            for r in self.running:
                if budget <= 0:
                    break
                if not r.prefilling:
                    continue
                c = min(r.prefill_target_len - r.ctx_done, budget)
                chunks.append((r, c))
                budget -= c
        # unwritten backlog of already-admitted prompts: their rows are
        # not in kv_blocks yet (chunks land at iteration END), but they
        # WILL materialize — admission must reserve for them or chunked
        # instances could blow past capacity (the engine reserves worst
        # case at admission; this is the sim's equivalent gate)
        pending = sum(r.prefill_target_len - r.ctx_done
                      for r in self.running if r.prefilling)
        while self.waiting:
            if len(self.running) >= self.batch_cap:
                # full batch: a higher-class head may park the lowest-
                # class resident decode (KV pinned, seat freed)
                if not (self.slo_sched
                        and not self._tpot_guard(self.waiting[0], t)
                        and self._preempt_seat(self.waiting[0])):
                    break
                continue
            if self.waiting[0].length + 1 > self.capacity:
                # request can never fit this instance: reject (real
                # engines fail such requests instead of wedging FCFS)
                sr = self.waiting.popleft()
                sr.rejected = True
                sr.finish_t = t
                sr.first_token_t = t
                if self.on_request_done:
                    self.on_request_done(self, sr, t)
                continue
            if budget is not None and budget <= 0:
                break
            # cached admission (DESIGN.md §Prefix cache): the shared
            # prefix is already resident, so only the uncached tail needs
            # room — and only it ever prefills (ctx_done starts there).
            # Prefix blocks with NO live sharer are parked (free
            # capacity), so admitting revives them: charge the revival
            # like the engine's revival_cost, or the sim would admit past
            # capacity where the server refuses.
            head = self.waiting[0]
            cached = self.cached_tokens_for(head)
            if self.host_kv_blocks > 0:
                # tiered accounting: device-resident chains already pin
                # their blocks in kv_blocks (no revival charge), but a
                # host-tier hit must find device room for the blocks it
                # promotes
                revived = self.host_blocks_for(head) * self.block_size
            else:
                revived = max(0, cached - self._live_shared_depth(
                    head.req.prefix_group) * self.block_size)
            if self.free_tokens() < (
                    self.block_tokens(head.length - cached)
                    + revived + pending):
                # memory-blocked: first reclaim like the engine — demote
                # idle published chains to the host tier and retry —
                # then recompute-preempt the lowest-class victim's KV
                if self._demote_idle_prefixes(head.req.prefix_group):
                    continue
                if not (self.slo_sched and not self._tpot_guard(head, t)
                        and self._preempt_mem(head, t)):
                    break
                continue
            sr = self.waiting.popleft()
            self._promote_group(sr)        # host hit: stage blocks back
            sr.cached_tokens = cached
            sr.ctx_done = max(sr.ctx_done, cached)
            self.running.append(sr)
            admitted.append(sr)
            if budget is None:
                sr.resume_target = None             # monolithic re-prefill
                sr.ctx_done = sr.req.input_len      # monolithic prefill
            else:
                pending += sr.prefill_target_len - sr.ctx_done
                c = min(sr.prefill_target_len - sr.ctx_done, budget)
                chunks.append((sr, c))
                budget -= c
        if self.slo_sched:
            self._resume_ready()
        if self.prefill_budget is None:
            decoding = [r for r in self.running if r not in admitted]
            dur = sum(prefill_time(r.length, self.profile) for r in admitted)
            if decoding:
                dur += decode_iter_time([r.length for r in decoding],
                                        self.profile)
        else:
            # mixed iteration: the decode batch (every fully-prefilled
            # request) + the packed prompt chunks, one fused step
            decoding = [r for r in self.running if not r.prefilling]
            dur = mixed_iter_time([(c, r.ctx_done) for r, c in chunks],
                                  [r.length for r in decoding], self.profile)
        if not self.running:
            self.iterating = False
            return
        dur *= self.slowdown             # slow-instance degradation fault
        dur += self._tier_io_s           # staged tier copies land this iter
        self._tier_io_s = 0.0
        self._iter_chunks = chunks
        self._iter_start = t
        self.busy_until = t + dur
        ep = self.epoch                  # fence: a crash invalidates this

        def fire():
            if ep == self.epoch:         # instance crashed mid-iteration?
                self._end_iteration(t + dur, admitted)
        self.events.push(t + dur, fire)

    # ---- SLO preemption (mirrors serving.Engine; DESIGN.md §SLO sched) -----
    def _victims(self, pr: int) -> List[SimRequest]:
        """Preemptable residents for a priority-``pr`` preemptor: strictly
        lower class, fully prefilled, >= 1 generated token, not mid-
        migration (the fabric owns those)."""
        return [r for r in self.running
                if not r.prefilling and not r.migrating and r.generated > 0
                and priority_of(r.req.slo_class) > pr]

    def _preempt_seat(self, head: SimRequest) -> bool:
        """Full batch: park the lowest-class largest victim — KV blocks
        stay pinned (kv_blocks counts parked), only the seat frees."""
        cands = self._victims(priority_of(head.req.slo_class))
        if not cands:
            return False
        v = max(cands, key=lambda r: (priority_of(r.req.slo_class),
                                      r.kv_len))
        self.running.remove(v)
        self._seq += 1
        # size 0: a parked request outranks an equal-deadline waiting one
        v.sched_key = queue_key(v.req.slo_class, v.req.arrival, 0.0,
                                self._seq)
        self.parked.append(v)
        v.preemptions += 1
        self.preemptions += 1
        return True

    def _preempt_mem(self, head: SimRequest, t: float) -> bool:
        """Memory-blocked admission: drop the lowest-class largest
        victim's KV and re-enqueue it as a recompute resume — running
        victims first, then parked ones (whose pinned blocks are
        otherwise unreachable)."""
        pr = priority_of(head.req.slo_class)
        cands = self._victims(pr)
        if cands:
            v = max(cands, key=lambda r: (priority_of(r.req.slo_class),
                                          r.kv_len))
            self.running.remove(v)
            self._recompute_preempt(v, t)
            return True
        pcands = [r for r in self.parked
                  if priority_of(r.req.slo_class) > pr]
        if not pcands:
            return False
        v = max(pcands, key=lambda r: (priority_of(r.req.slo_class),
                                       r.kv_len))
        self.parked.remove(v)
        self._recompute_preempt(v, t)
        return True

    def _recompute_preempt(self, v: SimRequest, t: float) -> None:
        """Drop a victim's KV; prefill must rebuild prompt + generated
        rows minus the pending last token (mirrors the engine's
        ``_requeue_recompute``)."""
        target = v.ctx_done + v.generated - 1
        v.resume_target = max(target, 1)
        v.ctx_done = 0
        v.cached_tokens = 0
        v.preemptions += 1
        v.preempted_t = t              # aging clock starts now
        self.preemptions += 1
        self.preempt_recomputes += 1
        self._seq += 1
        v.sched_key = queue_key(v.req.slo_class, v.req.arrival,
                                v.req.input_len + v.req.output_len,
                                self._seq)
        insert_sorted(self.waiting, v)

    def _age_waiting(self, t: float) -> None:
        """Starvation/aging guard (mirrors Engine._age_waiting): promote
        recompute-preempted waiters one class per TTFT budget waited."""
        changed = False
        for r in self.waiting:
            if r.preempted_t is None:
                continue
            promote = aging_promotion(r.req.slo_class, r.preempted_t, t)
            if promote <= 0:
                continue
            key = queue_key(r.req.slo_class, r.req.arrival,
                            r.req.input_len + r.req.output_len,
                            r.sched_key[3], promote=promote)
            if key != r.sched_key:
                r.sched_key = key
                changed = True
        if changed:
            ordered = sorted(self.waiting, key=lambda q: q.sched_key)
            self.waiting.clear()
            self.waiting.extend(ordered)

    def _tpot_guard(self, head: SimRequest, t: float) -> bool:
        """TPOT-deadline admission (mirrors Engine._preempt_for's guard):
        a resumed decode whose TPOT deadline is already unrecoverable
        must not preempt healthy traffic — counted once per request."""
        if head.generated <= 0 or head.first_token_t is None:
            return False
        if not tpot_hopeless(head.req.slo_class, head.first_token_t, t,
                             head.req.output_len):
            return False
        if head.req.req_id not in self._tpot_hopeless_ids:
            self._tpot_hopeless_ids.add(head.req.req_id)
            self.tpot_skipped += 1
        return True

    def _resume_ready(self) -> None:
        """Restore parked requests into free batch seats, unless a
        waiting request outranks the best parked one."""
        while self.parked and len(self.running) < self.batch_cap:
            v = min(self.parked, key=lambda r: r.sched_key)
            if self.waiting and self.waiting[0].sched_key < v.sched_key:
                return
            self.parked.remove(v)
            self.running.append(v)
            self.resumes += 1

    def _end_iteration(self, t: float, admitted: List[SimRequest]) -> None:
        # the iteration's prompt chunks land: progress advances, and a
        # request whose LAST chunk landed joins the producers this very
        # iteration (its first token — mirrors serving.Engine). A request
        # the migration fabric removed from `running` mid-iteration is
        # skipped: its shipped KV is what the receiver adopted, so the
        # source must not claim rows that never transferred. (A request
        # still resident but `migrating` DOES advance — that is live
        # migration's source-keeps-working semantics; the multi-round
        # copy model ships the delta.)
        for r, c in self._iter_chunks:
            if r in self.running:
                r.ctx_done += c
                if r.resume_target is not None:
                    if r.ctx_done >= r.resume_target:
                        # recompute resume complete: rows rebuilt, decode
                        # continues (no re-publish, no new first token)
                        r.resume_target = None
                        r.ctx_done = r.req.input_len
                        self.resumes += 1
                elif not r.prefilling:  # prompt done: prefix now servable
                    self._publish_prefix(r)
        self._iter_chunks = []
        producers = [r for r in self.running if not r.prefilling]
        n = len(producers)
        sumI = sum(r.req.input_len for r in producers)
        sumI2 = sum(r.req.input_len ** 2 for r in producers)
        sumL = sum(r.length for r in producers)
        finished: List[SimRequest] = []
        produced = 0
        for r in producers:
            if r.first_token_t is None:
                r.first_token_t = t
            r.generated += 1
            r.length += 1
            produced += 1
            r.tokens_by_instance[self.id] = \
                r.tokens_by_instance.get(self.id, 0) + 1
            # batch-load features for QoE profiling
            r.feat_sum[0] += 1.0
            r.feat_sum[1] += n
            r.feat_sum[2] += sumI
            r.feat_sum[3] += sumI2
            r.feat_sum[4] += sumL
            r.feat_iters += 1
            if r.done:
                r.finish_t = t
                finished.append(r)
        self.tokens_out += produced
        for r in finished:
            self.running.remove(r)
            if self.on_request_done:
                self.on_request_done(self, r, t)
        dur = max(t - self._iter_start, 1e-9)
        if produced:
            # EMA throughput estimate (bid-ask earliest_start payload)
            self.throughput_est = (0.8 * self.throughput_est
                                   + 0.2 * produced / dur)
        if self.on_iteration_end:
            self.on_iteration_end(self, t)
        self.iterating = False
        self.kick(t)
