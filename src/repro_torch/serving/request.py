"""Serving request lifecycle — the port's own copy of the part of
``repro.serving.request`` that the engine runs (framework-free, so it is
copied, not imported): the engine's state plus the fields the cluster's
control plane and summary read. Preemption and fault recovery state come
with the slice that ports those paths.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np


class State(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
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
    # prefill progress (chunked engines): prompt tokens whose KV is written
    ctx_done: int = 0
    # prefix-cache state: prompt tokens served from this engine's shared
    # block index — always block-aligned, <= ctx_done once running. A
    # migrated shared prefix re-imports as private (import resets it to 0)
    cached_tokens: int = 0
    # workload identity of a shared prefix (set by requests_from_trace for
    # traces carrying prefix groups); the engine matches on token content
    prefix_group: int = -1
    prefix_len: int = 0
    # (block_size, chain digests) memo — the prompt is immutable, so its
    # digest chain is computed once, not per admission check
    prefix_digests_memo: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    # per-engine token counts (load-balance accounting, Fig. 16)
    tokens_by_engine: Dict[int, int] = dataclasses.field(default_factory=dict)
    # SLO service class (repro_torch.sched.slo.SLO_CLASSES): interactive
    # arrivals route least-queued, bid-ask orders by class priority
    slo_class: str = "standard"

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def prefill_target_len(self) -> int:
        """Rows prefill must write before decode starts: the prompt."""
        return len(self.prompt)

    @property
    def prefilling(self) -> bool:
        return self.ctx_done < self.prefill_target_len

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(self.generated and self.eos_token is not None
                    and self.generated[-1] == self.eos_token)
