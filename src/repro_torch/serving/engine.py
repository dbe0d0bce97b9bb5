"""Single-instance inference engine — the port of
``repro.serving.engine``. Its default path is a paged, device-resident KV
pool:

one global block pool ``[L, num_blocks + 1, BS, Hkv, Dh]`` (the extra
block is the *garbage block*: dead batch slots and padded table rows write
and read there by construction, so the fixed-width batch cannot corrupt
live blocks), a per-request block table managed by ``BlockAllocator``, and
admission by worst-case block reservations.

Every ``step()`` is one **mixed** continuous-batching iteration: up to
``prefill_token_budget`` prompt-chunk tokens (resuming partial prompts
oldest-first, then admitting FCFS) run beside the whole ``max_slots``-wide
decode batch. On the ``fused`` attention backend that is ONE
attention-bearing forward (one fused kernel launch per layer); on
``grid``, ``flat`` and ``dense`` it is two: the chunks' forward (the
chunked prefill kernel, or dense's gather + SDPA), then the decode forward
(the grid or flat decode kernel, or dense's), in which a request whose
last chunk just landed already decodes. Steps without chunks decode
(``step(burst=n)`` runs up to ``n`` decode iterations before the host
looks at the tokens). Block tables,
lengths and last tokens live on the device, greedy argmax runs there, and
each step makes exactly ONE device-to-host transfer (:func:`d2h`), none
on a step that only prefills. Host-to-device uploads go through pinned
buffers and never block the host. The prefix cache shares the full
prompt blocks of earlier requests at admission. A warm request then
decodes the cold request's greedy tokens; in bf16 on the card that holds
bit for bit only where its tail chunk has the shapes of the cold run's
final chunk (cuBLAS may round another row count differently). In f32
with TF32 off such rounding differences are small enough that
``chip_smoke.py`` phase 5 sees the cold tokens at shapes that differ.

Live migration exports a request's KV as the reference's contiguous
``[L, 1, written, Hkv, Dh]`` piece (mid-prefill: its ``ctx_done`` rows,
resumed by chunking on the receiver) and imports such pieces, whatever
engine or framework wrote them. The wire stays full-width: an int8 engine
dequantizes on export and quantizes on import, so bf16 and int8 engines
interoperate.

``kv_dtype="int8"`` keeps the pool as int8 rows with f32 scales (about
half the bytes; fused and dense backends). ``host_kv_budget`` adds the
host-RAM tier: reclaimed prefix blocks demote to pinned host memory (an async
device-side copy issued before the allocation that overwrites them,
waited for only at the end of the step) and promote back with one upload
at admission. ``preemption=True`` keeps the waiting queue in SLO order
and lets a blocked higher-class request park a lower-class decode (a
slot shortage) or drop and recompute its KV (a memory shortage).

Every engine mode of the reference but tensor parallelism is ported:
``paged=False`` keeps KV in a monolithic slab ``[L, max_slots, max_seq,
Hkv, Dh]`` (decoded in place by the contiguous decode kernel, padded),
the only layout of a sliding-window decoder (a ring of ``min(max_seq,
W)`` rows a slot) and of rwkv6 (its recurrent state, a slot a row; these
models have no paged path, so the slab, the host loop and whole-prompt
prefill are their defaults),
``device_resident=False`` runs the host-driven loop (one decode forward
over the live rows, tables and tokens uploaded from host state),
``chunked_prefill=False`` prefills whole prompts at admission (the
contiguous causal prefill kernel; the §2.1 head-of-line baseline, where a
long prompt stalls every decode for its step) and ``prefix_cache=False``
turns the prefix index off. Every loop makes one device-to-host transfer
a step: a first token sampled at admission stays on the device until it.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.migration import (gather_kv_blocks, kv_bytes,
                                        scatter_kv_blocks, tree_leaves,
                                        tree_map)
from repro_torch.kernels.cost import pow2_bucket
from repro_torch.models.attention import (KV_DTYPES, QuantKVCache,
                                          dequantize_piece, quantize_piece,
                                          resolve_paged_backend)
from repro_torch.models.model import Model
from repro_torch.sched.policy import park_or_recompute
from repro_torch.sched.slo import (aging_promotion, insert_sorted,
                                   priority_of, queue_key, tpot_hopeless)
from repro_torch.serving.block_pool import (BlockAllocator, blocks_for,
                                            chain_hash, prompt_chain)
from repro_torch.serving.request import ServeRequest, State

DEFAULT_BLOCK_SIZE = 16
# Per-iteration prompt-chunk token budget of the mixed scheduler.
DEFAULT_PREFILL_BUDGET = 256

# Running count of device->host transfers by all engines of the process.
D2H_CALLS = 0

# Weakrefs to every engine constructed in this process (drain checks).
_LIVE_ENGINES: List["weakref.ref"] = []


def d2h(x: torch.Tensor) -> np.ndarray:
    """The engine's ONLY device-to-host transfer. Every token that reaches
    Python crosses here, so ``D2H_CALLS`` (and a test shim patching this
    function) counts host round trips exactly. A CUDA sync-debug mode is
    relaxed for this one copy and nowhere else."""
    global D2H_CALLS
    D2H_CALLS += 1
    if x.device.type != "cuda":
        return x.numpy()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return x.cpu().numpy()
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# Running count of attention-bearing forwards (each is one kernel launch
# per layer, none on dense): a fused mixed step makes exactly ONE, a grid,
# flat or dense one two.
ATTN_CALLS = 0


def attn_call(fn, *args, **kwargs):
    """Issue one attention-bearing forward (and count it)."""
    global ATTN_CALLS
    ATTN_CALLS += 1
    return fn(*args, **kwargs)


def h2d(arr, device: torch.device) -> torch.Tensor:
    """Host-to-device upload (of a numpy array or a CPU tensor) that never
    blocks the host: on CUDA through a pinned staging copy (the caching
    host allocator keeps it alive until the copy has run)."""
    t = (arr if isinstance(arr, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(arr)))
    if device.type == "cuda":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _PendingDemote(NamedTuple):
    """A demoted block's payload while its device-to-host copy may still
    be in flight: host leaves ``[L, 1, BS, ...]`` (pinned on CUDA) and the
    event recorded after the copy (None on the CPU)."""
    leaves: tuple
    event: Optional["torch.cuda.Event"]


def _materialize(payload):
    """A host-tier payload whose copy has landed: waits for a pending
    demote's event (an explicit wait, outside the step's one d2h) and
    returns its leaves."""
    if isinstance(payload, _PendingDemote):
        if payload.event is not None:
            payload.event.synchronize()
        return payload.leaves
    return payload


@dataclasses.dataclass
class _Parked:
    """A park-preempted request: off its batch slot, KV blocks (and the
    covering reservation) intact. ``_unpark`` restores it into any free
    slot with bit-identical continuation."""
    req: ServeRequest
    table: List[int]
    shared: int          # shared prefix-head blocks (released owned=False)
    rblocks: int         # reservation units the request still holds
    slot_len: int


_next_pow2 = pow2_bucket


def _pow2_floor(n: int) -> int:
    assert n >= 1
    return 1 << (n.bit_length() - 1)


class Engine:
    def __init__(self, engine_id: int, model: Model, params, *,
                 max_slots: int = 8, max_seq: int = 512,
                 token_budget: Optional[int] = None,
                 paged: Optional[bool] = None,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 device_resident: Optional[bool] = None,
                 prefill_token_budget: Optional[int] = None,
                 chunked_prefill: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 attn_backend: Optional[str] = None,
                 kv_dtype: str = "bf16", host_kv_budget: int = 0,
                 preemption: Optional[bool] = None,
                 slo_time_scale: float = 1.0):
        """The engine runs on the device of ``params["embed"]``; several
        engines may share one ``params`` (each owns only its KV cache).
        ``paged`` (default on) keeps KV in the block pool, off in the
        monolithic slab ``[L, max_slots, max_seq, Hkv, Dh]``;
        ``device_resident`` (default on; paged only) runs the
        device-resident step, off the host loop; ``chunked_prefill``
        (default on; paged only) packs prompt chunks into mixed steps, off
        prefills whole prompts at admission; ``prefix_cache`` (default:
        as ``chunked_prefill``, which it needs) shares cached prompt
        blocks. ``attn_backend`` is ``"fused"`` (default), ``"flat"``,
        ``"grid"`` or ``"dense"``; ``kv_dtype`` ``"bf16"`` (the model's
        dtype) or ``"int8"`` (paged, fused or dense); ``host_kv_budget``
        the host-RAM tier's tokens (0: off); ``preemption`` SLO preemption
        (off unless asked, as in the reference's direct construction).
        The decoder families (dense, MoE, VLM) and rwkv6 (``ssm``) are
        served; a sliding window or rwkv6 has the slab only. A VLM's fused
        mixed step is refused here, where the reference fails at its first
        step (M-RoPE is RoPE-only on that path)."""
        if model.cfg.family not in ("dense", "moe", "vlm", "ssm"):
            raise ValueError("engine supports decoder-only families")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
        self.attn_backend = resolve_paged_backend(attn_backend)
        if kv_dtype == "int8" and self.attn_backend not in ("fused",
                                                             "dense"):
            raise ValueError("int8 KV needs the 'fused' or 'dense' "
                             "attention backend")
        self.id = engine_id
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.token_budget = token_budget or max_slots * max_seq
        self.paged = model.supports_paged if paged is None else bool(paged)
        self.kv_dtype = kv_dtype
        if self.paged:
            if not model.supports_paged:
                raise ValueError(f"{model.cfg.name} has no paged path")
            self.block_size = block_size
            self.num_blocks = self.token_budget // block_size
            assert self.num_blocks > 0, "token_budget < one block"
            # capacity is block-granular
            self.token_budget = self.num_blocks * block_size
            # host-RAM KV tier: reclaimed cached chains demote to a
            # capacity-bounded host store instead of dying (0 = off)
            self.host_kv_budget = int(host_kv_budget or 0)
            self.allocator = BlockAllocator(
                self.num_blocks, block_size,
                host_blocks=self.host_kv_budget // block_size)
            if self.allocator.host_tier_enabled:
                self.allocator.set_demote_fetch(self._demote_snapshot)
            # +1 garbage block (id num_blocks, never allocated)
            self.garbage_block = self.num_blocks
            self.cache = model.init_paged_cache(
                self.num_blocks + 1, block_size, device=self.device,
                kv_dtype=kv_dtype)
            # pool bytes per block, scales included
            self._bytes_per_block = kv_bytes(self.cache) / (self.num_blocks
                                                             + 1)
            self.block_tables: List[List[int]] = [[] for _ in
                                                  range(max_slots)]
            self._slot_rblocks = [0] * max_slots   # reserved blocks per slot
            self._slot_shared = [0] * max_slots    # shared table-head blocks
            self.device_resident = (True if device_resident is None
                                    else bool(device_resident))
        else:
            if kv_dtype != "bf16":
                raise ValueError("quantized KV needs the paged block pool")
            # one max_seq row per slot; the host loop drives it
            self.block_size = 0
            self.device_resident = False
            self.cache = model.init_cache(max_slots, max_seq,
                                          device=self.device)
            self._bytes_per_slot = kv_bytes(self.cache) / max_slots
        if self.device_resident:
            # device mirrors of the decode batch: tables (pow2 width),
            # cache lengths (0 = dead slot) and last tokens
            self._nbt_cap = 1
            self._dev_bt = torch.full((max_slots, 1), self.garbage_block,
                                      dtype=torch.int32, device=self.device)
            self._dev_len = torch.zeros(max_slots, dtype=torch.int32,
                                        device=self.device)
            self._dev_tok = torch.zeros(max_slots, dtype=torch.int32,
                                        device=self.device)
        # first tokens sampled this step, on the device until its transfer
        self._pending_first: List[Tuple[ServeRequest, torch.Tensor]] = []
        # chunked prefill: prompts advance by chunks beside the decode
        # batch; off, admission prefills each whole prompt (the §2.1
        # head-of-line baseline)
        chunk_ok = self.paged
        self.chunked_prefill = (chunk_ok if chunked_prefill is None
                                else bool(chunked_prefill))
        if self.chunked_prefill and not chunk_ok:
            raise ValueError("chunked prefill needs the paged block pool")
        # fused: chunks and decodes share ONE forward; grid, flat and
        # dense (and the host loop): two forwards (chunks, then decodes)
        self.fused_mixed = (self.chunked_prefill and self.device_resident
                            and self.attn_backend == "fused")
        if self.fused_mixed and model.cfg.use_mrope:
            raise ValueError("paged mixed step: RoPE / learned-pos only")
        # the prefix cache starts warm requests mid-prompt, so it needs
        # chunked prefill
        self.prefix_cache = (self.chunked_prefill if prefix_cache is None
                             else bool(prefix_cache and self.chunked_prefill))
        self.prefill_token_budget = (prefill_token_budget
                                     or DEFAULT_PREFILL_BUDGET)
        self._prefill_order: List[int] = []   # slots mid-prefill, oldest 1st
        self.slot_len = np.zeros(max_slots, np.int32)       # tokens in cache
        self.slots: List[Optional[ServeRequest]] = [None] * max_slots
        self.slot_reserved = np.zeros(max_slots, np.int64)  # worst-case tokens
        self.waiting: Deque[ServeRequest] = deque()
        # SLO-tiered preemptive scheduling: the waiting queue sorted by
        # sched.slo.queue_key; a blocked higher-class request may park
        # (slot shortage) or recompute-preempt (memory shortage) the
        # lowest-class resident decode
        self.slo_sched = bool(preemption)
        self.slo_time_scale = float(slo_time_scale)
        self.parked: List[_Parked] = []
        self._seq = 0                # submission tie-break for queue_key
        self.preemptions = 0         # victim pauses (park + recompute)
        self.preempt_recomputes = 0  # victims whose KV was dropped
        self.resumes = 0             # park restores + recompute completions
        # resumed decodes whose TPOT is already unrecoverable may not
        # preempt healthy traffic (counted once per request)
        self.tpot_skipped = 0
        self._tpot_hopeless_ids: set = set()
        self.steps = 0
        self.tokens_out = 0
        self.peak_kv_bytes = 0.0     # most KV bytes pinned after a step
        # host-tier blocks promoted back onto the device at admission
        self.promoted_blocks_total = 0
        # prefill cost counters: block-work run by prefill (Σ per chunk
        # ceil((ctx+clen)/BS), or the prompt's blocks), prompt tokens
        # prefilled, and prompt tokens served by the prefix index
        self.prefill_work_blocks = 0
        self.prefill_tokens_done = 0
        self.cached_prompt_tokens_total = 0
        # last step's grid accounting: flat_items = the TPU work bucket,
        # real_items = Σ ceil(total/BS), padded_items = B·max ceil(total/BS)
        self.last_grid: Dict[str, int] = {}
        self._faulted = False        # set by a server that crashed it
        _LIVE_ENGINES.append(weakref.ref(self))

    # ---- drain-time leak check -------------------------------------------
    def check_drained(self, strict: bool = True) -> None:
        """Assert this engine holds no request state. ``strict`` requires
        empty slots, queue and prefill order and an allocator with nothing
        reserved (a drained server); non-strict only checks the
        allocator's invariants (engines may still hold live requests)."""
        if strict:
            assert all(r is None for r in self.slots), \
                f"engine {self.id}: undrained slots"
            assert not self.waiting, f"engine {self.id}: undrained queue"
            assert not self.parked, f"engine {self.id}: undrained parked"
            assert not self._prefill_order, \
                f"engine {self.id}: dangling prefill order"
        if self.paged:
            self.allocator.check_invariants()
            if strict:
                self.allocator.check_drained()
        elif strict:
            assert int(self.slot_reserved.sum()) == 0, \
                f"engine {self.id}: leaked slot reservations"
            assert int(self.slot_len.sum()) == 0, \
                f"engine {self.id}: leaked slot lengths"

    def shutdown(self) -> None:
        """Asserts the engine drained clean, then drops its KV cache."""
        self.check_drained()
        self.cache = None
        if self.paged:
            self.block_tables = [[] for _ in self.block_tables]

    # ---- load views (what the control plane reads) ---------------------------
    def active(self) -> List[ServeRequest]:
        return [r for r in self.slots if r is not None]

    def used_tokens(self) -> int:
        """Tokens of cache memory pinned by running requests (paged:
        allocated blocks x block size; slab: live cache rows)."""
        if self.paged:
            return self.allocator.allocated_tokens()
        return int(self.slot_len.sum())

    def reserved_tokens(self) -> int:
        """Worst-case committed footprint of every admitted request: what
        admission gates on."""
        if self.paged:
            return self.allocator.reserved_blocks * self.block_size
        return int(self.slot_reserved.sum())

    def queued_tokens(self) -> int:
        """Un-prefilled, uncached prompt tokens: whole waiting prompts
        (minus their prefix-cache hit, estimated at submit) plus the
        unwritten remainder of requests mid-prefill. The written part is
        pinned cache (``used_tokens``): no token counts twice."""
        q = sum(r.prefill_target_len - r.cached_tokens for r in self.waiting)
        q += sum(r.prefill_target_len - r.ctx_done
                 for r in self.active() if r.prefilling)
        return int(q)

    def free_tokens(self) -> int:
        """Unpinned cache budget; the admission invariant keeps it >= 0."""
        return self.token_budget - self.used_tokens()

    def load(self) -> float:
        """Scheduling pressure: pinned cache + queued prompt tokens."""
        return float(self.used_tokens() + self.queued_tokens())

    def kv_bytes_pinned(self) -> float:
        """Cache bytes pinned right now (paged: allocated blocks; slab:
        the max_seq rows of occupied slots)."""
        if self.paged:
            return self.allocator.allocated_blocks * self._bytes_per_block
        return sum(r is not None for r in self.slots) * self._bytes_per_slot

    def request_view(self) -> List[Tuple[float, float]]:
        """(input_len, current_len) of every slotted request."""
        return [(float(len(r.prompt)), float(r.length)) for r in self.active()]

    # ---- prefix cache ------------------------------------------------------
    def _req_digests(self, req: ServeRequest) -> List[int]:
        """Chain digests of the prompt's full blocks, capped at
        ``(len-1)//BS`` so a fully cached prompt still computes >= 1 token;
        memoized on the request (the prompt is immutable)."""
        cache = req.prefix_digests_memo
        if cache is None or cache[0] != self.block_size:
            cache = (self.block_size, prompt_chain(
                req.prompt, self.block_size,
                limit=(len(req.prompt) - 1) // self.block_size))
            req.prefix_digests_memo = cache
        return cache[1]

    def _cached_chain(self, req: ServeRequest) -> List[int]:
        """Longest device-resident block chain for this prompt ([] with
        the prefix cache off)."""
        if not self.prefix_cache:
            return []
        return self.allocator.lookup(self._req_digests(req))

    def _tiered_chain(self, req: ServeRequest):
        """(device block ids, host digest continuation): the two-tier chain
        hit admission consumes — device blocks are shared for free, host
        digests promote at a copy cost."""
        if not self.prefix_cache:
            return [], []
        return self.allocator.lookup_tiered(self._req_digests(req))

    def prefix_hint(self, req: ServeRequest):
        """(head_digest, cached_tokens, host_blocks) for dispatch: the
        digest of the prompt's first full block (None for sub-block
        prompts), the tokens resident here across both tiers, and how many
        of those blocks are host-resident (routing prices their promote
        copy). The digest is content-derived, so it is the same on every
        engine."""
        if not self.prefix_cache or len(req.prompt) <= self.block_size:
            return None, 0, 0
        digests = self._req_digests(req)
        dev, host = self.allocator.lookup_tiered(digests)
        return digests[0], (len(dev) + len(host)) * self.block_size, len(host)

    def prefix_digests(self) -> frozenset:
        """Head digests of every cached chain (either tier) — the compact
        advertisement within-stage dispatch tie-breaks on."""
        if not self.prefix_cache:
            return frozenset()
        return (self.allocator.head_digests()
                | self.allocator.host_head_digests())

    def tiered_digests(self) -> Dict[int, str]:
        """Head digest -> tier tag ('device' | 'host'): the control plane's
        warm filter prefers device-warm instances (a host hit pays the
        promote copy)."""
        if not self.prefix_cache:
            return {}
        out = {h: "device" for h in self.allocator.head_digests()}
        for h in self.allocator.host_head_digests():
            out.setdefault(h, "host")
        return out

    # ---- host-RAM KV tier ---------------------------------------------------
    def _demote_snapshot(self, block_id: int) -> _PendingDemote:
        """Payload fetch the allocator calls when it reclaims a cached
        block with the host tier on: an ASYNC copy of the block's leaves
        (``[L, 1, BS, ...]``; int8 pools carry their scale leaves) into
        pinned host memory, then an event. Stream order makes the copy
        read the block BEFORE the allocation that triggered the reclaim
        overwrites it; only :meth:`_flush_demotes` (after the step's one
        d2h) or a promote of the same block waits for the event."""
        leaves = []
        for a in self.cache:
            src = a[:, block_id:block_id + 1]
            if self.device.type == "cuda":
                dst = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
                dst.copy_(src, non_blocking=True)
            else:
                dst = src.clone()
            leaves.append(dst)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _PendingDemote(type(self.cache)(*leaves), event)

    def _flush_demotes(self) -> None:
        """Wait for this step's demote copies and keep their host leaves.
        Not routed through :func:`d2h`: the one-d2h contract is about the
        step's tokens; these copies were issued earlier and overlapped
        the iteration that evicted them."""
        if self.paged and self.allocator.host_tier_enabled:
            self.allocator.host_materialize(_materialize)

    def _promote_blocks(self, req: ServeRequest, shared: List[int],
                        promo: List[int]) -> List[int]:
        """Promote a host-tier chain continuation onto the device: allocate
        owned blocks (covered by the request's admission reservation),
        upload all payloads in ONE pinned h2d (every leaf's bytes and the
        block ids packed into one buffer), scatter them with one call, and
        re-publish each digest with its chain links."""
        # pop payloads BEFORE allocating: the allocation may reclaim (and
        # demote) other device blocks, and the resulting host-capacity
        # pressure must never evict the very entries being promoted
        payloads = [_materialize(self.allocator.host_pop(h)) for h in promo]
        ids = self.allocator.allocate(len(promo))
        host = [torch.as_tensor(np.asarray(ids, np.int64))] + [
            torch.cat([p[i] for p in payloads], dim=1)
            for i in range(len(self.cache))]
        buf = h2d(torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                             for t in host]), self.device)
        dev, at = [], 0
        for t in host:
            n = t.numel() * t.element_size()
            dev.append(buf[at:at + n].view(t.dtype).view(t.shape))
            at += n
        scatter_kv_blocks(self.cache, type(self.cache)(*dev[1:]), dev[0])
        digests = self._req_digests(req)
        d0 = len(shared)
        for j, (b, h) in enumerate(zip(ids, promo)):
            parent = digests[d0 + j - 1] if d0 + j > 0 else 0
            self.allocator.publish(b, h, head=(d0 + j == 0), parent=parent)
        self.promoted_blocks_total += len(ids)
        return ids

    @property
    def cache_demotions(self) -> int:
        return self.allocator.cache_demotions if self.paged else 0

    @property
    def cache_drops(self) -> int:
        return self.allocator.cache_drops if self.paged else 0

    @property
    def cache_promotions(self) -> int:
        return self.allocator.cache_promotions if self.paged else 0

    def _publish_prompt(self, req: ServeRequest, slot: int) -> None:
        """Prefill finished: publish the prompt's FULL blocks into the
        prefix index (first writer wins; the partial tail block is never
        published)."""
        table = self.block_tables[slot]
        digests = list(self._req_digests(req))
        n_full = len(req.prompt) // self.block_size
        if len(digests) < n_full:           # len(prompt) % BS == 0
            parent = digests[-1] if digests else 0
            start = len(digests) * self.block_size
            digests.append(chain_hash(
                parent, req.prompt[start:start + self.block_size]))
        for j, h in enumerate(digests[:n_full]):
            self.allocator.publish(table[j], h, head=(j == 0),
                                   parent=digests[j - 1] if j else 0)

    # ---- intake -------------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        req.state = State.WAITING
        # prefix-hit estimate for queued_tokens/load while the request
        # waits (refreshed authoritatively at admission); both tiers
        # count: a host-resident chain still spares the prefill work
        dev, host = self._tiered_chain(req)
        req.cached_tokens = (len(dev) + len(host)) * self.block_size
        if self.slo_sched:
            self._seq += 1
            req.sched_key = queue_key(req.slo_class, req.arrival_step,
                                      self._worst_tokens(req), self._seq,
                                      time_scale=self.slo_time_scale)
            insert_sorted(self.waiting, req)
        else:
            self.waiting.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _worst_tokens(self, req: ServeRequest) -> int:
        """Upper bound on this request's final cache length."""
        return min(len(req.prompt) + req.max_new_tokens, self.max_seq)

    def can_accept(self, req: ServeRequest) -> bool:
        """Slot + worst-case budget check, for admission AND inbound
        migration. Paged admission reserves only the uncached tail, but
        sharing a reclaimable (refcount-0) chain revives it, so the gate
        charges that revival too. A migrated-in (RUNNING) request
        re-imports as private, reserves its true length, and its remaining
        generation must fit ``max_seq``."""
        if self._free_slot() is None or len(req.prompt) + 1 > self.max_seq:
            return False
        if req.state is State.RUNNING:
            remaining = max(req.max_new_tokens - len(req.generated), 0)
            if req.length + remaining > self.max_seq:
                return False
        if not self.paged:
            return self.reserved_tokens() + self._worst_tokens(req) \
                <= self.token_budget
        need = blocks_for(self._worst_tokens(req), self.block_size)
        if req.state is not State.RUNNING:
            chain = self._cached_chain(req)
            need += self.allocator.revival_cost(chain) - len(chain)
        return self.allocator.can_reserve(need)

    def _reject_head(self) -> ServeRequest:
        """Fail the waiting queue's head, whose prompt can never fit this
        engine, instead of letting it wedge the queue."""
        req = self.waiting.popleft()
        req.rejected = True
        req.state = State.FINISHED
        req.first_token_step = req.finish_step = self.steps
        return req

    def _admit(self) -> Tuple[List[ServeRequest], List[ServeRequest]]:
        """Whole-prompt admission: admit FCFS (SLO order with preemption)
        while capacity lasts, prefilling each prompt at once. Under SLO
        scheduling the waiting queue ages first and parked requests resume
        around the admissions. Returns (rejected, admitted)."""
        rejected: List[ServeRequest] = []
        admitted: List[ServeRequest] = []
        if self.slo_sched:
            self._age_waiting()
            self._resume_ready()
        while self.waiting:
            req = self.waiting[0]
            if len(req.prompt) + 1 > self.max_seq:
                rejected.append(self._reject_head())
                continue
            if not self.can_accept(req):
                if self.slo_sched and self._preempt_for(req):
                    continue
                break
            slot = self._free_slot()
            self.waiting.popleft()
            self._prefill_into_slot(req, slot)
            admitted.append(req)
        if self.slo_sched:
            self._resume_ready()
        return rejected, admitted

    def _reserve(self, req: ServeRequest, slot: int,
                 cached_blocks: int = 0) -> None:
        worst = self._worst_tokens(req)
        if self.paged:
            rb = blocks_for(worst, self.block_size) - cached_blocks
            self.allocator.reserve(rb)
            self._slot_rblocks[slot] = rb
        self.slot_reserved[slot] = worst

    # ---- device mirrors -------------------------------------------------------
    def _ensure_nbt_cap(self, need: int) -> None:
        """Grow the device table width to a pow2 >= need (capped at the
        max_seq block count)."""
        if need <= self._nbt_cap:
            return
        new = min(_next_pow2(need), blocks_for(self.max_seq, self.block_size))
        assert new >= need
        self._dev_bt = F.pad(self._dev_bt, (0, new - self._nbt_cap),
                             value=self.garbage_block)
        self._nbt_cap = new

    def _dev_set_table(self, slot: int, ids: List[int]) -> None:
        row = np.full((self._nbt_cap,), self.garbage_block, np.int32)
        row[:len(ids)] = ids
        self._dev_bt[slot] = h2d(row, self.device)

    def _dev_clear_slot(self, slot: int) -> None:
        # fill_ takes the scalar as a kernel argument; item assignment of
        # a Python number would upload it with a blocking copy
        self._dev_bt[slot].fill_(self.garbage_block)
        self._dev_len[slot].fill_(0)

    # ---- whole-prompt prefill ------------------------------------------------
    def _prefill_into_slot(self, req: ServeRequest, slot: int) -> None:
        """Prefill a whole prompt into ``slot``: the host loop's and the
        slab's path (the device loop pads to a pow2 bucket instead). The
        prompt-length piece lands in fresh blocks (paged) or in the slot's
        slab row, zero past the prompt. The first token stays on the
        device until the step's single transfer."""
        if self.paged and self.device_resident:
            self._prefill_into_slot_device(req, slot)
            return
        self._reserve(req, slot)
        T = len(req.prompt)
        tokens = h2d(np.asarray(req.prompt, np.int32)[None], self.device)
        # the slab's piece arrives laid out as its row (a window's ring);
        # the pool takes the prompt-length piece
        logits, piece = attn_call(self.model.prefill, self.params, tokens,
                                  cache_len=None if self.paged
                                  else self.max_seq)
        if self.paged:
            ids = self.allocator.allocate(blocks_for(T, self.block_size))
            self.block_tables[slot] = ids
            self._write_prompt_blocks(piece, ids)
            self.prefill_work_blocks += len(ids)
            self.prefill_tokens_done += T
        else:
            self._write_slot(piece, slot)
        self._seat_prefilled(req, slot, T,
                             torch.argmax(logits[0]).to(torch.int32))

    def _prefill_into_slot_device(self, req: ServeRequest,
                                  slot: int) -> None:
        """The device loop's whole-prompt prefill: the prompt padded to a
        pow2 bucket (the padding tail is computed; causality keeps the
        first T rows exact), its T rows written into fresh blocks
        (quantized on write for an int8 pool), the device mirrors armed
        and the first token deferred to the step's single transfer."""
        self._reserve(req, slot)
        T = len(req.prompt)
        P = min(_next_pow2(T), _next_pow2(self.max_seq))
        toks = np.zeros((1, P), np.int32)
        toks[0, :T] = req.prompt
        logits, piece = attn_call(self.model.prefill_bucketed, self.params,
                                  h2d(toks, self.device), T)
        ids = self.allocator.allocate(blocks_for(T, self.block_size))
        self.block_tables[slot] = ids
        self._write_prompt_blocks(type(piece)(*(a[:, :, :T] for a in piece)),
                                  ids)
        self.prefill_work_blocks += len(ids)
        self.prefill_tokens_done += T
        tok_dev = torch.argmax(logits[0]).to(torch.int32)
        self._ensure_nbt_cap(len(ids))
        self._dev_set_table(slot, ids)
        self._dev_len[slot].fill_(T + 1)
        self._dev_tok[slot] = tok_dev
        self._seat_prefilled(req, slot, T, tok_dev)

    def _seat_prefilled(self, req: ServeRequest, slot: int, T: int,
                        tok_dev: torch.Tensor) -> None:
        """A whole prompt of T tokens is in ``slot``: seat the request,
        its first token (``tok_dev``, on the device) pending."""
        self._pending_first.append((req, tok_dev))
        req.ctx_done = T
        req.first_token_step = self.steps
        req.state = State.RUNNING
        req.engine_id = self.id
        req.slot = slot
        req.tokens_by_engine[self.id] = req.tokens_by_engine.get(self.id, 0) + 1
        self.slots[slot] = req
        self.slot_len[slot] = T + 1
        self.tokens_out += 1

    def _write_slot(self, piece, slot: int) -> None:
        """Write a ``[L, 1, ...]`` piece into slab row ``slot``, leaf by
        leaf of its pytree: a leaf whose axis 2 is shorter than the slab's
        (a trimmed migration piece) fills the row's head and zeroes the
        rest; any other (a prefill piece laid out as the row, a window's
        ring, rwkv6's state) is copied whole."""
        for a, p in zip(tree_leaves(self.cache), tree_leaves(piece)):
            if p.shape[2:] == a.shape[2:]:
                a[:, slot].copy_(p[:, 0])
                continue
            n = p.shape[2]
            a[:, slot, :n].copy_(p[:, 0])
            a[:, slot, n:].zero_()

    # ---- chunked prefill: the mixed iteration's prompt side -----------------
    def _run_chunked_prefill(self) -> Tuple[List[ServeRequest],
                                            List[ServeRequest]]:
        """The two-call path's chunk forward (grid, flat, dense): plan,
        run every planned chunk in ONE prefill forward, and finish them.
        Returns (rejected, completed) — completed requests' first tokens
        stay on the device until the step's single transfer."""
        rejected, plan = self._plan_chunks()
        completed: List[ServeRequest] = []
        if plan:
            arrays = self._prepare_chunk_arrays(plan)
            logits, self.cache = attn_call(
                self.model.prefill_chunk, self.params, self.cache, *arrays,
                attn_backend=self.attn_backend)
            self._finish_chunks(
                plan, torch.argmax(logits, dim=-1).to(torch.int32), completed)
        return rejected, completed

    def _plan_chunks(self) -> Tuple[List[ServeRequest],
                                    List[Tuple[int, int]]]:
        """Admission + chunk planning of the mixed iteration — host
        bookkeeping only. Returns (rejected, plan), plan = [(slot,
        chunk_len)] under the prefill token budget."""
        rejected: List[ServeRequest] = []
        if self.slo_sched:
            self._resume_ready()
        budget = self.prefill_token_budget
        plan: List[Tuple[int, int]] = []
        for slot in list(self._prefill_order):      # oldest admitted first
            if budget <= 0:
                break
            req = self.slots[slot]
            clen = min(req.prefill_target_len - req.ctx_done, budget)
            plan.append((slot, clen))
            budget -= clen
        while self.waiting and budget > 0:
            req = self.waiting[0]
            if len(req.prompt) + 1 > self.max_seq:  # can NEVER fit: fail
                rejected.append(self._reject_head())
                continue
            if not self.can_accept(req):
                if self.slo_sched and self._preempt_for(req):
                    continue
                break
            slot = self._free_slot()
            self.waiting.popleft()
            # the longest cached chain across both tiers: device blocks
            # are shared (refcount++, no copies), a host-tier continuation
            # PROMOTES into owned blocks under this request's reservation;
            # chunking starts at ctx_done = cached_tokens
            shared, promo = self._tiered_chain(req)
            self._reserve(req, slot, cached_blocks=len(shared))
            self._slot_shared[slot] = len(shared)
            if shared:
                self.allocator.share(shared)
            promoted = (self._promote_blocks(req, shared, promo)
                        if promo else [])
            req.cached_tokens = (len(shared) + len(promoted)) \
                * self.block_size
            self.cached_prompt_tokens_total += req.cached_tokens
            req.state = State.RUNNING
            req.engine_id = self.id
            req.slot = slot
            req.ctx_done = req.cached_tokens
            self.block_tables[slot] = list(shared) + promoted
            self.slots[slot] = req
            self.slot_len[slot] = req.ctx_done
            self._prefill_order.append(slot)
            clen = min(req.prefill_target_len - req.ctx_done, budget)
            plan.append((slot, clen))
            budget -= clen
        if self.slo_sched:
            self._resume_ready()
        return rejected, plan

    def _prepare_chunk_arrays(self, plan: List[Tuple[int, int]]):
        """Device arrays for all of the step's planned chunks, padded to a
        common pow2 chunk bucket and a common pow2 table width. Each
        chunk's blocks are allocated here (covered by its reservation);
        table tails are the garbage block, so padding rows never touch
        live data. Returns ``(tokens [B, C], tables [B, nbt], ctx [B],
        clen [B])``."""
        B = len(plan)
        C = _next_pow2(max(clen for _, clen in plan))
        nbt = 1
        for slot, clen in plan:
            req = self.slots[slot]
            need = blocks_for(req.ctx_done + clen, self.block_size)
            table = self.block_tables[slot]
            if need > len(table):
                table.extend(self.allocator.allocate(need - len(table)))
            nbt = max(nbt, blocks_for(req.ctx_done + C, self.block_size))
            self.prefill_work_blocks += need
            self.prefill_tokens_done += clen
        nbt = _next_pow2(nbt)
        toks = np.zeros((B, C), np.int32)
        bt = np.full((B, nbt), self.garbage_block, np.int32)
        ctxs = np.zeros((B,), np.int32)
        clens = np.zeros((B,), np.int32)
        for j, (slot, clen) in enumerate(plan):
            req = self.slots[slot]
            ctx = req.ctx_done
            # recompute-preempted and redispatched requests rebuild KV for
            # the resume prefix (prompt + generated-so-far but the last)
            src = (req.resume_tokens if req.resume_tokens is not None
                   else req.prompt)
            toks[j, :clen] = src[ctx:ctx + clen]
            table = self.block_tables[slot]
            bt[j, :len(table)] = table
            ctxs[j] = ctx
            clens[j] = clen
        return tuple(h2d(a, self.device) for a in (toks, bt, ctxs, clens))

    def _finish_chunks(self, plan: List[Tuple[int, int]],
                       first_toks: torch.Tensor,
                       completed: List[ServeRequest]) -> None:
        """Advance ``ctx_done``; for requests whose LAST chunk just landed,
        publish the prompt (with the prefix cache on) and keep the first
        token (``first_toks[j]``) on the device until the step's single
        d2h. On the fused path the completing slot was dead during this
        step's forward, so it first decodes next step; on the two-call
        paths the decode forward that follows already includes it."""
        for j, (slot, clen) in enumerate(plan):
            req = self.slots[slot]
            T = req.prefill_target_len
            req.ctx_done += clen
            self.slot_len[slot] = req.ctx_done
            if req.ctx_done < T:
                continue
            if req.prefill_target is not None:
                # resume complete: rows 0..T-1 rebuilt, decoding continues
                # from generated[-1] at position T; the chunk's last logits
                # reproduce that token and are discarded
                self._finish_resume(req, slot, T)
                continue
            if self.prefix_cache:
                self._publish_prompt(req, slot)
            self._prefill_order.remove(slot)
            tok_dev = first_toks[j]
            req.first_token_step = self.steps
            req.tokens_by_engine[self.id] = \
                req.tokens_by_engine.get(self.id, 0) + 1
            self.tokens_out += 1
            self.slot_len[slot] = T + 1
            if self.device_resident:
                table = self.block_tables[slot]
                self._ensure_nbt_cap(len(table))
                self._dev_set_table(slot, table)
                self._dev_len[slot].fill_(T + 1)
                self._dev_tok[slot] = tok_dev
            self._pending_first.append((req, tok_dev))
            completed.append(req)

    # ---- SLO preemption ------------------------------------------------------
    def _victim_slots(self, pr: int) -> List[int]:
        """Preemptable slots for a priority-``pr`` preemptor: strictly
        lower class (uniform-class traffic never preempts), fully
        prefilled, with >= 1 synced generated token (a first token still
        on the device gives no continuation point yet)."""
        return [i for i, r in enumerate(self.slots)
                if r is not None and not r.prefilling and r.generated
                and priority_of(r.slo_class) > pr]

    def _mem_shortfall(self, req: ServeRequest) -> int:
        """Blocks the allocator is short of admitting ``req`` (<= 0: the
        blocker is a slot, not memory)."""
        if not self.paged:
            return 0
        need = blocks_for(self._worst_tokens(req), self.block_size)
        if req.state is not State.RUNNING:
            chain = self._cached_chain(req)
            need += self.allocator.revival_cost(chain) - len(chain)
        return need - self.allocator.headroom_blocks

    def _preempt_for(self, req: ServeRequest) -> bool:
        """Make room for a blocked higher-class request by preempting the
        lowest-class, largest resident victim: park it (slot shortage) or
        drop and recompute its KV (memory shortage). Returns True if a
        victim was preempted; the caller re-checks admission. A slab
        slot IS its memory (nothing to park), and without chunked prefill
        a recomputed victim has no path to rebuild its KV: both refuse."""
        if not self.paged:
            return False
        if (req.generated and req.first_token_step is not None
                and tpot_hopeless(req.slo_class, req.first_token_step,
                                  self.steps, req.max_new_tokens,
                                  time_scale=self.slo_time_scale)):
            # TPOT-deadline admission: a resumed decode past recovery
            # waits for organic capacity instead of preempting
            if req.req_id not in self._tpot_hopeless_ids:
                self._tpot_hopeless_ids.add(req.req_id)
                self.tpot_skipped += 1
            return False
        pr = priority_of(req.slo_class)
        short = self._mem_shortfall(req)
        cands = self._victim_slots(pr)
        if not cands:
            # memory may be pinned only by parked lower-class requests
            return short > 0 and self._preempt_parked(pr)
        slot = max(cands, key=lambda i: (
            priority_of(self.slots[i].slo_class), len(self.block_tables[i])))
        mode = park_or_recompute(must_free_blocks=max(short, 0),
                                 kv_tokens=int(self.slot_len[slot]) - 1)
        if mode == "recompute":
            if not self.chunked_prefill:
                return False
            self._preempt_recompute(slot)
        else:
            self._preempt_park(slot)
        return True

    def _preempt_park(self, slot: int) -> None:
        """Pause a resident decode keeping its KV: its blocks pin via
        ``BlockAllocator.park`` and its reservation stays, so resume is a
        bookkeeping restore with a bit-identical continuation."""
        req = self.slots[slot]
        table = self.block_tables[slot]
        self.allocator.park(table)
        self._seq += 1
        # size 0: a parked request outranks an equal-deadline waiting one
        req.sched_key = queue_key(req.slo_class, req.arrival_step, 0.0,
                                  self._seq, time_scale=self.slo_time_scale)
        self.parked.append(_Parked(req, table, self._slot_shared[slot],
                                   self._slot_rblocks[slot],
                                   int(self.slot_len[slot])))
        self._slot_shared[slot] = 0
        self._slot_rblocks[slot] = 0
        self.block_tables[slot] = []
        if self.device_resident:
            self._dev_clear_slot(slot)
        self.slots[slot] = None
        self.slot_len[slot] = 0
        self.slot_reserved[slot] = 0
        req.slot = None
        req.state = State.PREEMPTED
        req.preemptions += 1
        self.preemptions += 1

    def _preempt_recompute(self, slot: int) -> None:
        """Drop a resident decode's KV (blocks + reservation) and re-enqueue
        it to rebuild by chunked prefill over its resume prefix."""
        req = self.slots[slot]
        written = int(self.slot_len[slot]) - 1
        self._release(slot)
        self._requeue_recompute(req, written)

    def _preempt_parked(self, pr: int) -> bool:
        """Recompute-preempt the largest parked request of a class below
        ``pr``: the only way to free memory held by parked victims."""
        if not self.chunked_prefill:
            return False
        cands = [p for p in self.parked if priority_of(p.req.slo_class) > pr]
        if not cands:
            return False
        rec = max(cands, key=lambda p: (priority_of(p.req.slo_class),
                                        len(p.table)))
        self.parked.remove(rec)
        self.allocator.unpark(rec.table)
        if rec.shared:
            self.allocator.release(rec.table[:rec.shared], owned=False)
            self.allocator.release(rec.table[rec.shared:], owned=True)
        else:
            self.allocator.release(rec.table, owned=True)
        self.allocator.unreserve(rec.rblocks)
        self._requeue_recompute(rec.req, rec.slot_len - 1)
        return True

    def _requeue_recompute(self, req: ServeRequest, written: int) -> None:
        """Re-enqueue a preempted decode as a resume job: prefill rebuilds
        ``written`` rows (prompt + generated[:-1]); the last sampled token
        then decodes at position ``written`` as it would have unpreempted."""
        req.prefill_target = written
        req.resume_tokens = np.concatenate(
            [np.asarray(req.prompt, np.int32),
             np.asarray(req.generated[:-1], np.int32)])
        assert len(req.resume_tokens) == written
        req.ctx_done = 0
        req.cached_tokens = 0
        req.slot = None
        req.state = State.WAITING
        req.preemptions += 1
        req.preempted_step = self.steps      # aging clock starts now
        self.preemptions += 1
        self.preempt_recomputes += 1
        self._seq += 1
        req.sched_key = queue_key(req.slo_class, req.arrival_step,
                                  self._worst_tokens(req), self._seq,
                                  time_scale=self.slo_time_scale)
        insert_sorted(self.waiting, req)

    def _age_waiting(self) -> None:
        """Starvation guard: a recompute-preempted request still waiting
        climbs one priority class per TTFT budget elapsed since its
        preemption (``sched.slo.aging_promotion``); its key keeps its
        deadline, size and sequence components. It runs where the
        reference runs it: on whole-prompt admission (:meth:`_admit`); the
        chunked path does not age, in the reference or here."""
        changed = False
        for req in self.waiting:
            if req.preempted_step is None:
                continue
            promote = aging_promotion(req.slo_class, req.preempted_step,
                                      self.steps,
                                      time_scale=self.slo_time_scale)
            if promote <= 0:
                continue
            key = queue_key(req.slo_class, req.arrival_step,
                            self._worst_tokens(req), req.sched_key[3],
                            time_scale=self.slo_time_scale, promote=promote)
            if key != req.sched_key:
                req.sched_key = key
                changed = True
        if changed:
            ordered = sorted(self.waiting, key=lambda r: r.sched_key)
            self.waiting.clear()
            self.waiting.extend(ordered)

    def _resume_ready(self) -> None:
        """Restore parked requests into free slots — unless a waiting
        request outranks the best parked one."""
        while self.parked:
            slot = self._free_slot()
            if slot is None:
                return
            rec = min(self.parked, key=lambda p: p.req.sched_key)
            if self.waiting and self.waiting[0].sched_key < rec.req.sched_key:
                return
            self.parked.remove(rec)
            self._unpark(rec, slot)

    def _unpark(self, rec: _Parked, slot: int) -> None:
        req = rec.req
        self.allocator.unpark(rec.table)
        self.block_tables[slot] = rec.table
        self._slot_shared[slot] = rec.shared
        self._slot_rblocks[slot] = rec.rblocks
        self.slots[slot] = req
        self.slot_len[slot] = rec.slot_len
        self.slot_reserved[slot] = self._worst_tokens(req)
        req.slot = slot
        req.state = State.RUNNING
        self.resumes += 1
        if self.device_resident:
            self._ensure_nbt_cap(len(rec.table))
            self._dev_set_table(slot, rec.table)
            self._dev_len[slot].fill_(rec.slot_len)
            self._dev_tok[slot].fill_(int(req.generated[-1]))

    def _finish_resume(self, req: ServeRequest, slot: int, T: int) -> None:
        """A recompute resume's last chunk landed: rows 0..T-1 are back;
        re-arm decode so ``generated[-1]`` writes row T next. No token is
        sampled and nothing is re-published."""
        self._prefill_order.remove(slot)
        req.prefill_target = None
        req.resume_tokens = None
        req.ctx_done = len(req.prompt)
        self.slot_len[slot] = T + 1
        self.resumes += 1
        if self.device_resident:
            table = self.block_tables[slot]
            self._ensure_nbt_cap(len(table))
            self._dev_set_table(slot, table)
            self._dev_len[slot].fill_(T + 1)
            self._dev_tok[slot].fill_(int(req.generated[-1]))

    # ---- one continuous-batching iteration ----------------------------------
    @torch.no_grad()
    def step(self, burst: int = 1) -> List[ServeRequest]:
        """Advance the engine and return the requests that finished.

        Paged engines run the device-resident step unless built with
        ``device_resident=False``; the host loop (and the slab, which has
        only it) decodes the live rows from host state. ``burst > 1``
        (device-resident only) runs up to that many decode iterations
        before the step's single transfer, clamped so no request can reach
        its token-count or max_seq finish before the last one; a step with
        waiting or mid-prefill requests never bursts."""
        if self.paged and self.device_resident:
            return self._step_device(burst)
        return self._step_host()

    def _prompt_side(self, finished: List[ServeRequest],
                     prefill_done: List[ServeRequest]) -> None:
        """The step's prompt work on every path but the fused one: the
        chunk forward, or whole-prompt admission. Rejected requests join
        ``finished``; a request whose one token is its first finishes at
        prefill (into ``prefill_done``; its token lands after the sync)."""
        rejected, prefilled = (self._run_chunked_prefill()
                               if self.chunked_prefill else self._admit())
        finished.extend(rejected)
        for r in prefilled:
            if r.max_new_tokens <= 1:
                prefill_done.append(r)
                self._release(r.slot)

    def _step_device(self, burst: int) -> List[ServeRequest]:
        self.steps += 1
        base = self.steps
        finished: List[ServeRequest] = []
        self._pending_first = []
        prefill_done: List[ServeRequest] = []
        chunk_plan: List[Tuple[int, int]] = []
        if self.fused_mixed:
            # plan + admit only: the chunks run INSIDE the fused forward
            rejected, chunk_plan = self._plan_chunks()
            finished.extend(rejected)
        else:
            self._prompt_side(finished, prefill_done)
        # requests still mid-prefill hold their slot but do NOT decode:
        # their device row is all-garbage and their length 0
        live = [(i, r) for i, r in enumerate(self.slots)
                if r is not None and not r.prefilling]
        h = 0
        toks = None
        if chunk_plan:
            # ---- ONE fused forward: decode batch + prompt chunks ----
            h = 1
            for i, _ in live:   # pre-grow decode tables for this write
                need = blocks_for(int(self.slot_len[i]), self.block_size)
                table = self.block_tables[i]
                if need > len(table):
                    table.extend(self.allocator.allocate(need - len(table)))
                    self._ensure_nbt_cap(need)
                    self._dev_set_table(i, table)
            ck_toks, bt_ck, ctxs, clens = \
                self._prepare_chunk_arrays(chunk_plan)
            dec_blocks = [blocks_for(int(self.slot_len[i]), self.block_size)
                          for i, _ in live]
            ck_blocks = [blocks_for(self.slots[s].ctx_done + c,
                                    self.block_size) for s, c in chunk_plan]
            num_work = ((_next_pow2(sum(dec_blocks)) if live else 0)
                        + _next_pow2(sum(ck_blocks)))
            self.last_grid = {
                "backend": "fused",
                "flat_items": num_work,
                "real_items": sum(dec_blocks) + sum(ck_blocks),
                "padded_items": (len(dec_blocks) + len(ck_blocks))
                * max(dec_blocks + ck_blocks),
            }
            new_tok, ck_tok = attn_call(self._mixed, num_work, ck_toks,
                                        bt_ck, ctxs, clens)
            if live:
                toks = new_tok[None]    # one horizon row for the step sync
            else:
                h = 0
            chunk_completed: List[ServeRequest] = []
            self._finish_chunks(chunk_plan, ck_tok, chunk_completed)
            for r in chunk_completed:
                if r.max_new_tokens <= 1:       # finishes at prefill; its
                    prefill_done.append(r)      # token lands after the sync
                    self._release(r.slot)
        elif live:
            # nobody may cross a count/capacity finish before the burst's
            # last iteration (eos finishes are cut after the transfer); a
            # first token still on the device counts as generated
            pend = {id(r) for r, _ in self._pending_first}
            cap = 1 if (self.waiting or self._prefill_order
                        or self.parked) else burst
            h = _pow2_floor(max(1, min(
                [cap] + [min(r.max_new_tokens - len(r.generated)
                             - (id(r) in pend),
                             self.max_seq - int(self.slot_len[i]))
                         for i, r in live])))
            # pre-grow tables for every write of the burst (positions
            # slot_len-1 .. slot_len+h-2), covered by the reservations
            for i, _ in live:
                need = blocks_for(int(self.slot_len[i]) + h - 1,
                                  self.block_size)
                table = self.block_tables[i]
                if need > len(table):
                    table.extend(self.allocator.allocate(need - len(table)))
                    self._ensure_nbt_cap(need)
                    self._dev_set_table(i, table)
            real = sum(blocks_for(int(self.slot_len[i]) + h - 1,
                                  self.block_size) for i, _ in live)
            # num_work shapes only the work-list kernels (flat, fused)
            num_work = (_next_pow2(real)
                        if self.attn_backend in ("flat", "fused") else 0)
            dec_blocks = [blocks_for(int(self.slot_len[i]), self.block_size)
                          for i, _ in live]
            self.last_grid = {
                "backend": self.attn_backend,
                "flat_items": _next_pow2(real),
                "real_items": sum(dec_blocks),
                "padded_items": len(live) * max(dec_blocks),
            }
            toks = torch.stack([attn_call(self._decode, num_work)
                                for _ in range(h)])
        self._land_tokens(base, h, toks, live, [i for i, _ in live],
                          prefill_done, finished)
        return finished

    def _step_host(self) -> List[ServeRequest]:
        """The host-driven loop (the slab's, and paged engines' with
        ``device_resident=False``): the prompt side, then one decode
        forward over the live rows only, its tokens and positions
        uploaded from host state (a first token still on the device feeds
        its row directly), and one transfer."""
        self.steps += 1
        finished: List[ServeRequest] = []
        self._pending_first = []
        prefill_done: List[ServeRequest] = []
        self._prompt_side(finished, prefill_done)
        live = [(i, r) for i, r in enumerate(self.slots)
                if r is not None and not r.prefilling]
        toks = None
        if live:
            pend = {id(r): t for r, t in self._pending_first}
            last_tok = h2d(np.asarray(
                [r.generated[-1] if r.generated else 0 for _, r in live],
                np.int32), self.device)
            for j, (_, r) in enumerate(live):
                if id(r) in pend:
                    last_tok[j] = pend[id(r)]
            pos = h2d(np.asarray([self.slot_len[i] - 1 for i, _ in live],
                                 np.int32), self.device)
            decode = (self._decode_paged_live if self.paged
                      else self._decode_mono_live)
            logits = decode(live, last_tok, pos)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)[None]
        self._land_tokens(self.steps, 1 if live else 0, toks, live,
                          range(len(live)), prefill_done, finished)
        return finished

    def _land_tokens(self, base: int, h: int, toks, live, cols,
                     prefill_done: List[ServeRequest],
                     finished: List[ServeRequest]) -> None:
        """The step's single device-to-host transfer, then its
        bookkeeping: pending first tokens append, requests done at prefill
        finish, and each of the ``h`` decode rows of ``toks`` (live
        request ``k`` in column ``cols[k]``) advances its request — an
        admitted request whose FIRST token was eos is done before them
        (its decodes wrote only its own rows)."""
        pending = list(self._pending_first)
        parts = [torch.stack([t for _, t in pending])] if pending else []
        if toks is not None:
            parts.append(toks.reshape(-1))
        host = d2h(torch.cat(parts)) if parts else np.zeros(0, np.int32)
        first = host[:len(pending)]
        rest = host[len(pending):].reshape(h, -1) if h else None
        for (r, _), tok in zip(pending, first):
            r.generated.append(int(tok))
        for r in prefill_done:
            r.state = State.FINISHED
            r.finish_step = base
            finished.append(r)
        for i, r in live:
            if r.state is State.RUNNING and r.done:
                r.state = State.FINISHED
                r.finish_step = base
                finished.append(r)
                self._release(i)
        for s in range(h):
            for (i, r), c in zip(live, cols):
                if r.state is State.FINISHED:
                    continue
                r.generated.append(int(rest[s, c]))
                r.tokens_by_engine[self.id] = \
                    r.tokens_by_engine.get(self.id, 0) + 1
                self.tokens_out += 1
                self.slot_len[i] += 1
                if r.done or self.slot_len[i] >= self.max_seq:
                    r.state = State.FINISHED
                    r.finish_step = base + s
                    finished.append(r)
                    self._release(i)
        self.steps = base + max(h - 1, 0)
        self._flush_demotes()
        self.peak_kv_bytes = max(self.peak_kv_bytes, self.kv_bytes_pinned())
        assert self.free_tokens() >= 0, "admission let the budget go negative"

    def _mixed(self, num_work: int, ck_tokens, bt_ck, ctx, clen):
        """The fused forward of a mixed iteration; advances the device
        mirrors. Returns (decode tokens [max_slots], chunk first tokens)."""
        live = self._dev_len > 0
        pos = self._dev_len - 1            # dead slots: -1 -> 0 attn length
        dec_logits, ck_logits, self.cache = self.model.mixed_step(
            self.params, self.cache, self._dev_tok, ck_tokens, self._dev_bt,
            bt_ck, pos, ctx, clen, attn_num_work=num_work)
        new_tok = torch.argmax(dec_logits, dim=-1).to(torch.int32)
        self._dev_tok = torch.where(live, new_tok, self._dev_tok)
        self._dev_len = torch.where(live, self._dev_len + 1, self._dev_len)
        return new_tok, torch.argmax(ck_logits, dim=-1).to(torch.int32)

    def _decode(self, num_work: int) -> torch.Tensor:
        """One decode iteration of the whole batch on the device mirrors.
        Returns the sampled tokens [max_slots]."""
        live = self._dev_len > 0
        pos = self._dev_len - 1
        logits, self.cache = self.model.decode_step_paged(
            self.params, self.cache, self._dev_tok, self._dev_bt, pos,
            attn_backend=self.attn_backend, attn_num_work=num_work)
        new_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._dev_tok = torch.where(live, new_tok, self._dev_tok)
        self._dev_len = torch.where(live, self._dev_len + 1, self._dev_len)
        return new_tok

    def _decode_paged_live(self, live, last_tok: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
        """The host loop's paged decode of the live rows on the engine's
        backend: tables grown to back each write (covered by the
        reservations) and padded with the garbage block to a pow2 width
        (capped at the max_seq block count). Returns logits [B, V]."""
        for i, _ in live:
            need = blocks_for(int(self.slot_len[i]), self.block_size)
            table = self.block_tables[i]
            if need > len(table):
                table.extend(self.allocator.allocate(need - len(table)))
        nbt = max(len(self.block_tables[i]) for i, _ in live)
        nbt = min(_next_pow2(nbt), blocks_for(self.max_seq, self.block_size))
        bt = np.full((len(live), nbt), self.garbage_block, np.int32)
        for j, (i, _) in enumerate(live):
            bt[j, :len(self.block_tables[i])] = self.block_tables[i]
        logits, self.cache = attn_call(
            self.model.decode_step_paged, self.params, self.cache, last_tok,
            h2d(bt, self.device), pos, attn_backend=self.attn_backend)
        return logits

    def _decode_mono_live(self, live, last_tok: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
        """The slab's decode of the live rows in place: projections and
        MLP on the live rows only, each K/V write and attention on its
        own slab row (no gather, no scatter back). Returns logits
        [B, V]."""
        rows = h2d(np.asarray([i for i, _ in live], np.int32), self.device)
        logits, self.cache = attn_call(self.model.decode_step, self.params,
                                       self.cache, last_tok, pos, rows=rows)
        return logits

    def _release(self, slot: int) -> None:
        if slot in self._prefill_order:     # evicted mid-prefill
            self._prefill_order.remove(slot)
        if self.paged:
            # shared prefix blocks drop a borrowed reference; the private
            # remainder releases as owner (published blocks at refcount 0
            # stay cached, warm for the next identical prefix)
            s = self._slot_shared[slot]
            self._slot_shared[slot] = 0
            table = self.block_tables[slot]
            if s:
                self.allocator.release(table[:s], owned=False)
                self.allocator.release(table[s:], owned=True)
            else:
                self.allocator.release(table, owned=True)
            self.block_tables[slot] = []
            self.allocator.unreserve(self._slot_rblocks[slot])
            self._slot_rblocks[slot] = 0
            if self.device_resident:
                self._dev_clear_slot(slot)
        self.slot_reserved[slot] = 0
        self.slots[slot] = None
        self.slot_len[slot] = 0

    # ---- migration -----------------------------------------------------------
    def export_slot(self, slot: int):
        """(request, KV piece, piece bytes) for live migration. The piece
        is the wire format: contiguous ``[L, 1, written, Hkv, Dh]`` leaves
        gathered from the request's blocks, or copied from its slab row
        (trimmed to ``written``), so paged and slab engines interoperate;
        a window's ring and rwkv6's state ship whole, untrimmed (the
        reference's rule).
        ``written = slot_len - 1`` for a decoding request (its newest
        sampled token's KV is written by the next decode, on whichever
        engine runs it); a request still mid-prefill ships its
        ``ctx_done`` rows and the receiver resumes chunking."""
        req = self.slots[slot]
        assert req is not None
        length = int(self.slot_len[slot]) - (0 if req.prefilling else 1)
        if not self.paged:
            # a copy: the slab row is rewritten in place once it is reused
            cfg = self.model.cfg
            trim = cfg.family != "ssm" and not cfg.sliding_window
            piece = tree_map(
                lambda a: (a[:, slot:slot + 1, :length] if trim
                           else a[:, slot:slot + 1]).clone(), self.cache)
            return req, piece, kv_bytes(piece)
        ids = h2d(np.asarray(self.block_tables[slot], np.int64), self.device)
        gathered = gather_kv_blocks(self.cache, ids)
        piece = type(gathered)(*(
            a.reshape(a.shape[0], 1, -1, *a.shape[3:])[:, :, :length]
            for a in gathered))
        if isinstance(piece, QuantKVCache):
            # the wire stays full-width: bf16 and int8 engines interoperate
            piece = dequantize_piece(piece, self.model.cfg.dtype)
        return req, piece, kv_bytes(piece)

    def evict_slot(self, slot: int) -> None:
        self._release(slot)

    def import_request(self, req: ServeRequest, piece) -> bool:
        """Adopt a migrated request and its KV piece — still decoding, or
        still mid-prefill (the piece then holds its ``ctx_done`` rows and
        this engine resumes chunking). Refuses (``can_accept``) when no
        slot is free, the remaining generation cannot fit ``max_seq`` or
        the worst-case footprint exceeds the free budget, and a partial
        prompt when this engine cannot chunk. A migrated shared prefix
        re-imports as private: the receiver allocates fresh blocks and
        reserves the true length."""
        if req.prefilling and not self.chunked_prefill:
            return False        # nowhere to resume the prompt from
        if not self.can_accept(req):
            return False
        slot = self._free_slot()
        req.cached_tokens = 0
        self._reserve(req, slot)
        # cache length: the written rows (mid-prefill), or the rows plus
        # the newest token, whose KV the next decode writes
        length = req.ctx_done if req.prefilling else req.length
        if not self.paged:
            self._write_slot(tree_map(lambda p: p.to(self.device), piece),
                             slot)
        else:
            ids = self.allocator.allocate(blocks_for(length,
                                                     self.block_size))
            self.block_tables[slot] = ids
            if ids:
                self._write_prompt_blocks(piece, ids)
        if req.prefilling:
            # device mirrors stay cleared (all-garbage table, length 0):
            # the decode batch treats a mid-prefill slot as dead
            self._prefill_order.append(slot)
        elif self.device_resident:
            # an adopted decode carries >= 1 generated token: the mirrors
            # seed from host values (fill_, no blocking upload)
            self._ensure_nbt_cap(len(ids))
            self._dev_set_table(slot, ids)
            self._dev_len[slot].fill_(length)
            self._dev_tok[slot].fill_(int(req.generated[-1]))
        req.engine_id = self.id
        req.slot = slot
        req.state = State.RUNNING
        # the adopting engine appears in the per-engine token ledger even
        # before its first token (load-balance accounting, Fig. 16)
        req.tokens_by_engine.setdefault(self.id, 0)
        self.slots[slot] = req
        self.slot_len[slot] = length
        self._flush_demotes()       # the import's allocation may demote
        return True

    def _write_prompt_blocks(self, piece, block_ids: List[int]):
        """Scatter a contiguous piece (leaves ``[L, 1, T, ...]``, T <=
        len(block_ids) * BS) into physical blocks ``block_ids``; a
        full-width piece headed for an int8 pool is quantized first (its
        zero padding then has int8 0 and scale 0)."""
        nb, BS = len(block_ids), self.block_size
        piece = type(piece)(*(p.to(self.device) for p in piece))
        if (isinstance(self.cache, QuantKVCache)
                and not isinstance(piece, QuantKVCache)):
            piece = quantize_piece(piece)

        def pack(p):
            p = F.pad(p, [0, 0] * (p.dim() - 3) + [0, nb * BS - p.shape[2]])
            return p[:, 0].reshape(p.shape[0], nb, BS, *p.shape[3:])
        scatter_kv_blocks(self.cache, type(piece)(*(pack(p) for p in piece)),
                          h2d(np.asarray(block_ids, np.int64), self.device))
