"""Discrete-event core: a heap-ordered event queue with stable ties —
the port's copy of ``repro.sim.events``, whole."""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Tuple


class EventQueue:
    def __init__(self):
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._tie = itertools.count()
        self.now = 0.0

    def push(self, time: float, fn: Callable[[], None]) -> None:
        assert time >= self.now - 1e-12, (time, self.now)
        heapq.heappush(self._heap, (time, next(self._tie), fn))

    def run_until(self, t_end: float) -> None:
        while self._heap and self._heap[0][0] <= t_end:
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            fn()
        self.now = max(self.now, t_end)

    def __len__(self) -> int:
        return len(self._heap)
