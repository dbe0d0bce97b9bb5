#!/usr/bin/env python3
"""The dry run's llama3.2-3b programs on the card: ``chip_smoke.py``'s
phase 25 alone, with the rows of phase 3 it adds.

    python3 tools/dryrun_on_card.py [--json PATH]

Needs one CUDA card (and fails without one). Builds the kernels, then
(phase 3's rows) #6 at B 1, T 32768 and #5 padded on 8 rows of 32768
keys and on an 8192-row ring, each beside its plain version, one SDPA
call and its bound; then (phase 25) each case of ``launch.cases`` for
llama3.2-3b at (data 1, model 1), bf16, seeded weights, its global
batch cut to what the card holds: traced on the CPU under fake meta
tensors (``launch.dryrun``), run on the card (a warm run, 3 timed by
CUDA events, one profiled), its time against the roofline of the same
program, its device busy share, its launches, and its FLOPs and bytes
against the trace's. ``--json`` writes both
records (default ``chiprun_out/dryrun_on_card.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=str(ROOT / "chiprun_out" /
                                          "dryrun_on_card.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dryrun_on_card: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import configs as cfg_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import prefill_attention as pk
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build(verbose=False)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    rows = cs.dryrun_kernels(torch, cfg_mod, dk, pk, flush)
    del flush
    t0 = time.perf_counter()
    phase = cs.phase_dryrun(torch)
    print(f"phase 25 took {time.perf_counter() - t0:.1f} s", flush=True)
    out = Path(args.json)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": smi, "kernels": rows,
                               "phase25": phase}, indent=1, default=str))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
