"""Serving request lifecycle — the port's own copy of
``repro.serving.request`` (framework-free, so it is copied, not
imported): the engine's state, the fields the control plane and the
server's summary read, the resume state of recompute preemption and
dead-engine redispatch, and the fault-recovery flags.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np


class State(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    MIGRATING = "migrating"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class ServeRequest:
    req_id: int
    prompt: np.ndarray                # int32 [T]
    max_new_tokens: int
    arrival_step: int = 0
    state: State = State.WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    engine_id: Optional[int] = None
    slot: Optional[int] = None
    eos_token: Optional[int] = None
    rejected: bool = False            # prompt can never fit the engine
    # fault tolerance : failed = recovery
    # budget exhausted after its engine died (excluded from served
    # metrics like rejected); redispatches = dead-engine recoveries this
    # request survived (each replays prompt + generated-so-far elsewhere)
    failed: bool = False
    redispatches: int = 0
    # prefill progress (chunked engines): prompt tokens whose KV is
    # written. Whole-prompt paths set it to len(prompt) at prefill; a
    # migrated half-prefilled request carries it to the receiver, which
    # resumes chunking from here.
    ctx_done: int = 0
    # prefix-cache state (DESIGN.md §Prefix cache): prompt tokens served
    # from this engine's shared block index — always block-aligned, <=
    # ctx_done once running. A migrated shared prefix re-imports as
    # private, so import_request resets this to 0.
    cached_tokens: int = 0
    # workload identity of a shared prefix (set by requests_from_trace for
    # traces carrying prefix groups). The REAL engine never reads these —
    # it matches on token content — but the FakeEngine parity harness and
    # dispatch-digest tests key on them.
    prefix_group: int = -1
    prefix_len: int = 0
    # (block_size, chain digests) memo — the prompt is immutable, so its
    # digest chain is computed once, not per hint probe/admission check
    prefix_digests_memo: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    # per-engine token counts (load-balance accounting, Fig. 16)
    tokens_by_engine: Dict[int, int] = dataclasses.field(default_factory=dict)
    # --- SLO scheduling & preemption (DESIGN.md §SLO scheduling) ---
    # service class (repro_torch.sched.slo.SLO_CLASSES; unknown -> standard)
    slo_class: str = "standard"
    # recompute-preemption resume state: when set, prefill rebuilds KV for
    # resume_tokens[:prefill_target] (= prompt + generated[:-1]) instead of
    # the bare prompt, then decoding continues from generated[-1].
    resume_tokens: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    prefill_target: Optional[int] = None
    # waiting-queue sort key (repro_torch.sched.slo.queue_key), stamped at submit
    sched_key: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    preemptions: int = 0
    # starvation/aging guard (DESIGN.md §SLO scheduling): step at which a
    # recompute preemption re-enqueued this request; while it waits its
    # queue key is promoted one class per elapsed TTFT budget
    # (sched.slo.aging_promotion). None = never recompute-preempted.
    preempted_step: Optional[int] = None

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def prefill_target_len(self) -> int:
        """Rows prefill must write before decode (re)starts: the prompt
        for fresh requests, the resume prefix for recompute-preempted."""
        return (self.prefill_target if self.prefill_target is not None
                else len(self.prompt))

    @property
    def prefilling(self) -> bool:
        return self.ctx_done < self.prefill_target_len

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(self.generated and self.eos_token is not None
                    and self.generated[-1] == self.eos_token)
