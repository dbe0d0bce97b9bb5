#!/usr/bin/env python3
"""Where a step of the port's cluster spends its time on the card with
int8 pools, SLO preemption, the host KV tier and faults on.

    python3 tools/profile_torch_chaos.py [--window 18 --steps 8]

Serves the trace of ``chip_smoke.py`` phase 8 (4 engines on one card,
full-width bf16 llama3.2-3b with one shared seeded weight set, int8
pools, preemption over an interactive/standard/batch mix, a host tier on
every engine, engine 1 crashed at step 10 and rejoined at step 40, 30%
of transfers lost) twice without a profiler and prints for each pass the
server steps, the host wall, tokens/s, the mean server step, the event
counts and TTFT/E2E in steps. The scheduling decisions depend on token
counts only, so every pass makes the same ones. Then it serves the trace
once more and profiles ``--steps`` server steps from step ``--window``
with ``torch.profiler``: device busy time per step (the union of kernel
and copy intervals), its share of the unprofiled wall of the same steps
(first pass), kernels per step, device time by group (the int8 attention
kernel, GEMMs, the demote device-to-host and promote host-to-device
copies, the rest) and the largest kernels. Needs one CUDA card.
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
sys.path.insert(0, str(ROOT / "tools"))


def build(np, model, params, made):
    """The chip_smoke phase-8 cluster, trace submitted."""
    from chip_smoke import (CHAOS_ENGINE, CHAOS_FAULTS, CHAOS_TRACE, SEED,
                            _chaos_requests, chaos_server)
    from repro_torch.core import qoe as qoe_mod
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import request as request_mod
    from repro_torch.serving import server as server_mod
    srv = chaos_server(np, model, params, server_mod, serve_mod, qoe_mod,
                       engine_mod, CHAOS_FAULTS, 4, 8192, CHAOS_ENGINE, made)
    for r, at in _chaos_requests(np, request_mod, CHAOS_TRACE,
                                 model.cfg.vocab_size, SEED + 5):
        srv.submit_at(r, at)
    return srv


def drain(torch, srv, step_ms, stop=None):
    """Step until drained (or until step ``stop``), appending each server
    step's host wall (ms, ending in a synchronize)."""
    while len(srv.finished) < srv.submitted and srv.steps != stop:
        t = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)


def group(name: str) -> str:
    low = name.lower()
    if "mixed_attention" in low:
        return "int8 attention kernel"
    if "memcpy dtoh" in low:
        return "device-to-host copies (demotes, tokens)"
    if "memcpy htod" in low:
        return "host-to-device copies (promotes, tables)"
    if any(k in low for k in ("gemm", "nvjet", "sm90_xmma", "cutlass")):
        return "GEMMs"
    return "other kernels"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--window", type=int, default=18,
                    help="first profiled server step")
    ap.add_argument("--steps", type=int, default=8,
                    help="profiled server steps")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import SEED, chaos_events
    from profile_torch_engine import busy_ms
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from torch.profiler import ProfilerActivity, profile
    print(torch.cuda.get_device_name(0), torch.__version__)
    cfg = dataclasses.replace(get_config("llama3.2-3b"), dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    first_wall = None
    for _ in range(2):
        made = []
        srv = build(np, model, params, made)
        step_ms = []
        t0 = time.perf_counter()
        drain(torch, srv, step_ms)
        wall = time.perf_counter() - t0
        first_wall = first_wall or step_ms
        s = srv.summary()
        ntok = sum(e.tokens_out for e in made)
        print(f"== {srv.steps} steps, {wall:.3f} s, {ntok / wall:.1f} "
              f"tokens/s, server step ms mean "
              f"{sum(step_ms) / len(step_ms):.2f}, TTFT steps p50/p99 "
              f"{s['ttft_steps_p50']}/{s['ttft_steps_p99']}, E2E steps "
              f"p50/p99 {s['e2e_steps_p50']}/{s['e2e_steps_p99']}; events "
              f"{chaos_events(srv, made)}")
        for eng in srv.engines:
            if eng.id not in srv.crashed:
                eng.shutdown()
    lo, hi = args.window, args.window + args.steps
    made = []
    srv = build(np, model, params, made)
    drain(torch, srv, [], stop=lo)
    step_ms = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drain(torch, srv, step_ms, stop=hi)
    drain(torch, srv, [])
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(events)
    wall = sum(first_wall[lo:hi])
    n = len(step_ms)
    print(f"== server steps {lo + 1}..{hi}: host wall {wall / n:.2f} "
          f"ms/step unprofiled ({sum(step_ms) / n:.2f} under the "
          f"profiler), device busy {busy / n:.2f} ms/step "
          f"({100 * busy / wall:.1f}% of the unprofiled wall), "
          f"{len(events) / n:.0f} kernels and copies/step")
    groups, by_name = {}, {}
    for e in events:
        t = e.time_range.elapsed_us() / 1e3
        g = group(e.name)
        c0, t0 = groups.get(g, (0, 0.0))
        groups[g] = (c0 + 1, t0 + t)
        c1, t1 = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c1 + 1, t1 + t)
    for g, (c, t) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"  {t / n:9.3f} ms/step  {c / n:6.0f}/step  {g}")
    for name, (c, t) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:10]:
        print(f"  {t / n:9.3f} ms/step  {c / n:6.0f} launches/step  "
              f"{name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
