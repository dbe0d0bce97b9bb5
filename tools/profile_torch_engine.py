#!/usr/bin/env python3
"""Where a step of the port's engine spends its time on the card.

    python3 tools/profile_torch_engine.py [--steps 3]

Serves the trace of ``chip_smoke.py`` phase 4 (full-width llama3.2-3b,
bf16, 8 requests with prompts of 16..5897 tokens) twice, on fresh engines
with the same weights. Two windows of ``--steps`` engine steps are looked
at: mixed steps from the point where the longest prompt reaches ctx 2560,
and decode-only steps near the end of the trace. The first pass times the
windows with no profiler ever started in the process (recording host
activity slows the host, and the profiler may stay attached after it
stops); the second profiles the same steps with ``torch.profiler``. For
each window it prints the unprofiled host wall per step, the wall under
the profiler, the device busy time per step (the union of kernel
intervals in the trace), the busy share of the unprofiled wall, and
device time by kernel, largest first. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def busy_ms(events):
    """Union of the device intervals of ``events`` (ms)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def timed(torch, eng, steps):
    """Host wall time of ``steps`` engine steps (ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profiled(torch, eng, steps):
    """(host wall ms, device kernel events) of ``steps`` profiled steps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = timed(torch, eng, steps)
    return ms, [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]


def serve(torch, np, model, params, window):
    """Serve the trace on a fresh engine; ``window(eng)`` runs each
    window's steps. Returns the windows' labels."""
    from chip_smoke import NEW_TOKENS, PROMPTS, SEED
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import ServeRequest
    eng = Engine(0, model, params, max_slots=8, max_seq=8192)
    rng = np.random.default_rng(SEED)
    reqs = [ServeRequest(i, rng.integers(0, model.cfg.vocab_size, n)
                         .astype(np.int32), m)
            for i, (n, m) in enumerate(zip(PROMPTS, NEW_TOKENS))]
    for r in reqs:
        eng.submit(r)
    longest = reqs[-1]
    while longest.ctx_done < 2560:      # each mixed step: one 256 chunk
        eng.step()
    labels = [f"mixed steps, longest prompt from ctx {longest.ctx_done}"]
    window(eng)
    while any(r.prefilling for r in reqs) or len(longest.generated) < 4:
        eng.step()
    labels.append(f"decode-only steps, context from {eng.slot_len.max()}")
    window(eng)
    while not all(r.state.name == "FINISHED" for r in reqs):
        eng.step()
    eng.shutdown()
    return labels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import SEED
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    print(torch.cuda.get_device_name(0), torch.__version__)
    cfg = dataclasses.replace(get_config("llama3.2-3b"), dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    steps = args.steps
    walls = []
    serve(torch, np, model, params,
          lambda eng: walls.append(timed(torch, eng, steps)))
    traces = []
    labels = serve(torch, np, model, params,
                   lambda eng: traces.append(profiled(torch, eng, steps)))
    for label, wall, (prof_ms, kernels) in zip(labels, walls, traces):
        busy = busy_ms(kernels)
        by_name = {}
        for e in kernels:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
        print(f"== {label}: {steps} steps, host wall {wall / steps:.2f} "
              f"ms/step unprofiled ({prof_ms / steps:.2f} under the "
              f"profiler), device busy {busy / steps:.2f} ms/step "
              f"({100 * busy / wall:.1f}% of the unprofiled wall), "
              f"{len(kernels) / steps:.0f} kernels/step")
        for name, (n, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:12]:
            print(f"  {t / steps:9.3f} ms/step  {n / steps:6.0f} "
                  f"launches/step  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
