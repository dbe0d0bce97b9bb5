"""SLO service classes — the port's copy of the part of
``repro.sched.slo`` that the control plane, the server summary and the
launcher's class mix use (framework-free).

Three service classes, each with a TTFT and a TPOT deadline in abstract
seconds; the server measures time in steps and converts with a
``slo_time_scale`` (steps per abstract second). The waiting-queue order,
aging and TPOT admission of the reference come with SLO preemption.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One service class: smaller ``priority`` is served first."""
    name: str
    priority: int
    ttft_slo: float      # time-to-first-token budget (abstract seconds)
    tpot_slo: float      # per-output-token budget (abstract seconds)


SLO_CLASSES: Dict[str, SLOSpec] = {
    "interactive": SLOSpec("interactive", 0, ttft_slo=0.5, tpot_slo=0.05),
    "standard": SLOSpec("standard", 1, ttft_slo=2.0, tpot_slo=0.2),
    "batch": SLOSpec("batch", 2, ttft_slo=30.0, tpot_slo=2.0),
}
DEFAULT_CLASS = "standard"


def slo_of(slo_class: str) -> SLOSpec:
    """Spec for a class name; unknown names fall back to ``standard``."""
    return SLO_CLASSES.get(slo_class, SLO_CLASSES[DEFAULT_CLASS])


def priority_of(slo_class: str) -> int:
    return slo_of(slo_class).priority


def parse_class_mix(text: str) -> Tuple[Tuple[str, float], ...]:
    """Parse ``"interactive=0.5,standard=0.3,batch=0.2"`` (``:`` also
    accepted as the separator) into normalized (class, weight) pairs.
    Raises on unknown classes or no mass."""
    pairs = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        sep = "=" if "=" in part else ":"
        name, _, w = part.partition(sep)
        name = name.strip()
        if name not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {name!r} "
                             f"(known: {sorted(SLO_CLASSES)})")
        pairs.append((name, float(w) if w else 1.0))
    total = sum(w for _, w in pairs)
    if not pairs or total <= 0:
        raise ValueError(f"empty or zero-mass class mix: {text!r}")
    return tuple((n, w / total) for n, w in pairs)


def assign_classes(n: int, mix: Sequence[Tuple[str, float]], rng) -> List[str]:
    """Draw ``n`` class labels i.i.d. from a (class, weight) mix."""
    names = [m[0] for m in mix]
    probs = [m[1] for m in mix]
    total = sum(probs)
    probs = [p / total for p in probs]
    idx = rng.choice(len(names), size=n, p=probs)
    return [names[int(i)] for i in idx]
