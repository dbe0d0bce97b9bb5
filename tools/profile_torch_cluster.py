#!/usr/bin/env python3
"""Where a step of the port's 4-engine cluster spends its time on the
card, on the ``flat`` and the ``fused`` attention backends.

    python3 tools/profile_torch_cluster.py [--window 10 --steps 3]

Serves the trace of ``chip_smoke.py`` phase 6 (``MILSServer`` with 4
engines on one card, full-width bf16 llama3.2-3b with one shared seeded
weight set, 16 requests with prompts of 16..6000 tokens) four times
without a profiler, in the order flat, fused, fused, flat, and prints for
each pass the server steps, the host wall, tokens/s, the mean server step
and TTFT/E2E in steps. Then it serves the trace once more per backend and
profiles ``--steps`` server steps from step ``--window`` with
``torch.profiler``: device busy time per step (the union of kernel
intervals), its share of the unprofiled wall of the same steps (from the
first unprofiled pass of that backend), kernels per step, and device time
by kernel, largest first. Needs one CUDA card.
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

BACKENDS = ("flat", "fused", "fused", "flat")


def build(np, model, params, backend):
    """The chip_smoke phase-6 cluster on ``backend``, trace submitted."""
    from chip_smoke import CLUSTER_TRACE, SEED, _submit_trace
    from repro_torch.core.qoe import QoEModel
    from repro_torch.launch.serve import DEFAULT_QOE, default_plan
    from repro_torch.serving import request as request_mod
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.server import MILSServer, ServerConfig
    srv = MILSServer(model, params, default_plan(4, 8192),
                     QoEModel(np.array(DEFAULT_QOE)), ServerConfig(seed=SEED),
                     engine_factory=lambda i: Engine(
                         i, model, params, max_slots=8, max_seq=8192,
                         token_budget=32768, attn_backend=backend))
    _submit_trace(np, request_mod, srv, CLUSTER_TRACE, model.cfg.vocab_size,
                  SEED + 2)
    return srv


def drain(torch, srv, step_ms, stop=None):
    """Step until drained (or until step ``stop``), appending each server
    step's host wall (ms, ending in a synchronize)."""
    while len(srv.finished) < srv.submitted and srv.steps != stop:
        t = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--window", type=int, default=10,
                    help="first profiled server step")
    ap.add_argument("--steps", type=int, default=3,
                    help="profiled server steps")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import SEED
    from profile_torch_engine import busy_ms
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from torch.profiler import ProfilerActivity, profile
    print(torch.cuda.get_device_name(0), torch.__version__)
    cfg = dataclasses.replace(get_config("llama3.2-3b"), dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(SEED, device="cuda")
    first_walls = {}
    for backend in BACKENDS:
        srv = build(np, model, params, backend)
        step_ms = []
        t0 = time.perf_counter()
        drain(torch, srv, step_ms)
        wall = time.perf_counter() - t0
        first_walls.setdefault(backend, step_ms)
        s = srv.summary()
        print(f"== {backend}: {srv.steps} steps, {wall:.3f} s, "
              f"{s['tokens_out'] / wall:.1f} tokens/s, server step ms mean "
              f"{sum(step_ms) / len(step_ms):.2f} (without the first: "
              f"{sum(step_ms[1:]) / (len(step_ms) - 1):.2f}), "
              f"{srv.migrations} migrations, TTFT steps p50/p99 "
              f"{s['ttft_steps_p50']}/{s['ttft_steps_p99']}, E2E steps "
              f"p50/p99 {s['e2e_steps_p50']}/{s['e2e_steps_p99']}")
        for eng in srv.engines:
            eng.shutdown()
    lo, hi = args.window, args.window + args.steps
    for backend in ("flat", "fused"):
        srv = build(np, model, params, backend)
        drain(torch, srv, [], stop=lo)
        step_ms = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            drain(torch, srv, step_ms, stop=hi)
        drain(torch, srv, [])
        for eng in srv.engines:
            eng.shutdown()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = busy_ms(kernels)
        wall = sum(first_walls[backend][lo:hi])
        n = len(step_ms)
        print(f"== {backend}, server steps {lo + 1}..{hi}: host wall "
              f"{wall / n:.2f} ms/step unprofiled ({sum(step_ms) / n:.2f} "
              f"under the profiler), device busy {busy / n:.2f} ms/step "
              f"({100 * busy / wall:.1f}% of the unprofiled wall), "
              f"{len(kernels) / n:.0f} kernels/step")
        by_name = {}
        for e in kernels:
            c, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
        for name, (c, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:10]:
            print(f"  {t / n:9.3f} ms/step  {c / n:6.0f} launches/step  "
                  f"{name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
