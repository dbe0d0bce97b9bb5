"""The port's copy of ``repro.control.bidask``, whole (framework-free).

Decentralized bid-ask load (re)balancing (paper §4.4).

Market-style pairwise negotiation: an overloaded *sender* asks; candidate
*receivers* bid with (current load, earliest transmission start time); the
sender filters out the higher-load half, keeps the three earliest starters,
and takes the first reply. Won requests sit in the receiver's priority
queue (priority = sender load); a starvation counter triggers sender-side
backpressure after ``starvation_threshold`` failed pulls.

The protocol is implemented as pure decision functions + small state
machines so the discrete-event simulator and the real in-process server
drive the same code.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

OVERLOAD_FACTOR = 1.25          # §4.4: 25% above stage average triggers
STARVATION_THRESHOLD = 3
KEEP_EARLIEST = 3


@dataclasses.dataclass(frozen=True)
class Bid:
    receiver_id: int
    load: float                  # receiver's current load
    earliest_start: float        # buffered work / measured throughput
    reply_order: int             # arrival order of the reply


@dataclasses.dataclass
class MigRequest:
    req_id: int
    seq_len: int                 # tokens to transfer (KV volume)
    src: int
    priority: float = 0.0        # sender load at ask time
    dst: Optional[int] = None
    # SLO class priority (repro_torch.sched.slo: 0=interactive .. 2=batch).
    # Receivers pull lower values first so an interactive migration is
    # never parked behind a batch transfer of higher sender load.
    slo_priority: int = 1


def select_receiver(bids: Sequence[Bid]) -> Optional[int]:
    """§4.4 selection: drop the higher-load half, keep the 3 earliest
    transmission starts, pick the first replier."""
    if not bids:
        return None
    by_load = sorted(bids, key=lambda b: (b.load, b.reply_order))
    keep = by_load[:max(1, (len(by_load) + 1) // 2)]
    by_start = sorted(keep, key=lambda b: (b.earliest_start, b.reply_order))
    finalists = by_start[:KEEP_EARLIEST]
    return min(finalists, key=lambda b: b.reply_order).receiver_id


def is_overloaded(own_load: float, peer_loads: Sequence[float],
                  factor: float = OVERLOAD_FACTOR) -> bool:
    """Overloaded-outlier test: load ≥ factor × stage average."""
    loads = list(peer_loads) + [own_load]
    avg = sum(loads) / len(loads)
    return avg > 0 and own_load >= factor * avg


class SenderState:
    """Buffers requests awaiting migration; at most one in flight."""

    def __init__(self, instance_id: int):
        self.instance_id = instance_id
        self.buffer: Dict[int, MigRequest] = {}
        self.transmitting: Optional[int] = None
        self.starved: List[int] = []      # receiver-flagged, send-next queue

    def load(self) -> float:
        """Piggybacked on asks; also the priority receivers queue with."""
        return float(sum(r.seq_len for r in self.buffer.values()))

    def offer(self, req: MigRequest) -> MigRequest:
        req.priority = self.load() + req.seq_len
        self.buffer[req.req_id] = req
        return req

    def can_transmit(self, req_id: int) -> bool:
        if self.transmitting is not None:
            return False
        if self.starved and req_id != self.starved[0]:
            return False              # backpressure: starved request first
        return req_id in self.buffer

    def begin(self, req_id: int) -> MigRequest:
        assert self.can_transmit(req_id)
        self.transmitting = req_id
        if self.starved and self.starved[0] == req_id:
            self.starved.pop(0)
        return self.buffer[req_id]

    def finish(self, req_id: int) -> None:
        assert self.transmitting == req_id
        self.transmitting = None
        self.buffer.pop(req_id, None)

    def abort(self, req_id: int) -> None:
        """Roll back a ``begin`` whose transfer never started; the request
        stays buffered for a later retry."""
        assert self.transmitting == req_id
        self.transmitting = None

    def mark_starved(self, req_id: int) -> None:
        if req_id in self.buffer and req_id not in self.starved:
            self.starved.append(req_id)

    def drop(self, req_id: int) -> None:
        """Remove a request that will never transmit (finished or evicted
        before its transfer began). Clearing it from ``starved`` matters:
        a stale head entry would block every other transmission."""
        self.buffer.pop(req_id, None)
        if req_id in self.starved:
            self.starved.remove(req_id)


class ReceiverState:
    """Priority queue of won requests; pulls highest-priority first."""

    def __init__(self, instance_id: int, throughput: float = 1.0):
        self.instance_id = instance_id
        self.throughput = max(throughput, 1e-9)
        self._heap: List[Tuple[int, float, int, int, MigRequest]] = []
        self._tie = itertools.count()
        self.fails: Dict[int, int] = {}
        self.waiting_for: Optional[int] = None   # starvation: block on req

    def buffered_tokens(self) -> float:
        return float(sum(item[-1].seq_len for item in self._heap))

    def earliest_start(self) -> float:
        """Bid payload: buffered work / measured throughput."""
        return self.buffered_tokens() / self.throughput

    def win(self, req: MigRequest) -> None:
        req.dst = self.instance_id
        heapq.heappush(self._heap, (req.slo_priority, -req.priority,
                                    req.req_id, next(self._tie), req))

    def __len__(self) -> int:
        return len(self._heap)

    def next_pull(self, sender_busy) -> Tuple[Optional[MigRequest], Optional[int]]:
        """Dequeue the highest-priority transferable request.

        ``sender_busy(src_id)``: whether that sender is mid-transfer.
        Returns (request to start now | None, starved req_id to notify | None).
        Skipped requests accumulate failures; past the threshold the
        receiver blocks and notifies the sender (§4.4 starvation rule).
        """
        if self.waiting_for is not None:
            return None, None
        skipped = []
        starved: Optional[int] = None
        chosen: Optional[MigRequest] = None
        while self._heap:
            item = heapq.heappop(self._heap)
            req = item[-1]
            if not sender_busy(req.src):
                chosen = req
                break
            self.fails[req.req_id] = self.fails.get(req.req_id, 0) + 1
            if self.fails[req.req_id] > STARVATION_THRESHOLD and starved is None:
                starved = req.req_id
                self.waiting_for = req.req_id
                skipped.append(item)
                break
            skipped.append(item)
        for item in skipped:
            heapq.heappush(self._heap, item)
        return chosen, starved

    def take(self, req_id: int) -> Optional[MigRequest]:
        """Remove a specific request (starvation hand-off arriving)."""
        for i, item in enumerate(self._heap):
            if item[-1].req_id == req_id:
                self._heap.pop(i)
                heapq.heapify(self._heap)
                if self.waiting_for == req_id:
                    self.waiting_for = None
                self.fails.pop(req_id, None)
                return item[-1]
        return None

    def complete(self, req_id: int) -> None:
        self.fails.pop(req_id, None)
        if self.waiting_for == req_id:
            self.waiting_for = None

    def drain(self) -> List[MigRequest]:
        """Empty the queue (receiver died): every won offer is returned
        so the caller can unwind the matching sender state, and all
        starvation bookkeeping resets with the instance."""
        out = [item[-1] for item in self._heap]
        self._heap.clear()
        self.fails.clear()
        self.waiting_for = None
        return out
