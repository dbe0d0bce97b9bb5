#!/usr/bin/env python3
"""The port's dry-run rows beside the reference's, case by case.

    PYTHONPATH=src python3 tools/dryrun_vs_reference.py \\
        [--cases smollm-360m:decode_32k,qwen2.5-14b:prefill_32k:multi,...] \\
        [--opt] [--json PATH]

For each case (``arch:shape``, ``:multi`` for 2x16x16; the default is
the cases ROADMAP Queue 3 records — qwen3-moe at decode, train and
prefill — llama3.2-3b train_4k, and rwkv6-7b, zamba2-2.7b and
whisper-large-v3 at decode_32k and train_4k, all at 16x16) it runs the
reference's ``repro.launch.dryrun.run_case(arch, shape, multi_pod)`` in
a subprocess of its own — that module forces 512
host devices at import, so it cannot share a process with anything else
— and the port's ``repro_torch.launch.dryrun`` trace of the same case
here, and prints both rows: the counted FLOPs (the reference's compiled
HLO, the port's traced program) over the analytic per-chip share, the
collective wire bytes a chip and their ops by kind, the temp and
argument bytes a chip, and each row's dominant term. Each side prices
its terms on its own chip (the reference a TPU, the port the H100), so
the dominant terms are each program's own; the counts are comparable.

Everything runs on the CPU: the reference lowers and compiles XLA on
512 host devices (seconds to a minute a case), the port traces on fake
tensors. ``--opt`` runs both sides' optimized programs (the reference's
``run_case(..., optimized=True)``, the port's ``build_case(optimized=
True)``: the beyond-paper levers). ``--json`` writes both rows of every
case.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = ("smollm-360m:decode_32k", "qwen2.5-14b:decode_32k",
           "qwen3-moe-30b-a3b:decode_32k", "qwen3-moe-30b-a3b:train_4k",
           "qwen3-moe-30b-a3b:prefill_32k", "qwen2.5-14b:prefill_32k",
           "llama3.2-3b:train_4k", "rwkv6-7b:decode_32k",
           "rwkv6-7b:train_4k", "zamba2-2.7b:decode_32k",
           "zamba2-2.7b:train_4k", "whisper-large-v3:decode_32k",
           "whisper-large-v3:train_4k")

# run in the reference's own process: its row, and its collectives by op
# (the list its run_case parses out of the compiled HLO, kept as it passes)
_REFERENCE = r"""
import json, sys
import repro.launch.dryrun as d
from repro.launch.roofline import collective_wire_bytes
seen = []
parse = d.parse_collectives
def keep(*a, **k):
    out = parse(*a, **k)
    seen.append(out)
    return out
d.parse_collectives = keep
arch, shape, multi = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
row = d.run_case(arch, shape, multi, verbose=False,
                 optimized=sys.argv[4] == "1")
ops = {}
for c in (seen[-1] if seen else []):
    k = ops.setdefault(c["op"], [0, 0.0])
    k[0] += c.get("mult", 1)
    k[1] += collective_wire_bytes([c])
row["collective_ops"] = ops
print("ROW " + json.dumps(row, default=str))
"""


def reference_row(arch: str, shape: str, multi: bool,
                  optimized: bool = False) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, arch, shape, "1" if multi
         else "0", "1" if optimized else "0"], env=env,
        capture_output=True, text=True, timeout=3600)
    for line in out.stdout.splitlines():
        if line.startswith("ROW "):
            return json.loads(line[4:])
    return {"status": "fail", "error": (out.stderr or out.stdout)[-2000:]}


def port_row(arch: str, shape: str, multi: bool,
             optimized: bool = False) -> dict:
    from repro_torch.launch import dryrun
    from repro_torch.launch.cases import build_case
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import collective_wire_bytes
    layout = make_production_mesh(multi_pod=multi)
    case = build_case(arch, shape, layout, optimized)
    traced = dryrun.trace_case(case)
    rl = dryrun.roofline_of(case, traced, "2x16x16" if multi else "16x16",
                            layout)
    ops = defaultdict(lambda: [0, 0.0])
    for r in traced["records"]:
        ops[r["op"]][0] += 1
        ops[r["op"]][1] += collective_wire_bytes([r])
    row = rl.row()
    row.update(status="ok", mechanism=case.mechanism,
               plan=dict(case.plan.blocks), plan_axes=dict(case.plan.axes),
               collective_ops=dict(ops), optimized=optimized,
               levers=list(case.levers.taken()) if case.levers else [])
    return row


def _line(side: str, row: dict) -> str:
    if row.get("status") != "ok":
        return f"  {side:9s} {row.get('status')}: {row.get('error', '')}"
    ratio = row["flops_hlo_per_chip"] / row["flops_per_chip"]
    ops = ", ".join(f"{op} {n} ({b / 1e9:.3f} GB)" for op, (n, b) in
                    sorted(row["collective_ops"].items()))
    return (f"  {side:9s} counted/analytic FLOPs {ratio:.3f}x "
            f"({row['flops_hlo_per_chip']:.4e} / "
            f"{row['flops_per_chip']:.4e}); collectives "
            f"{row['coll_bytes_per_chip'] / 1e9:.3f} GB a chip [{ops}]; "
            f"temp {row['temp_bytes_per_chip'] / 1e9:.2f} GB, args "
            f"{row['arg_bytes_per_chip'] / 1e9:.2f} GB a chip; dominant "
            f"{row['dominant']} (its own chip's terms)"
            + (f"; {row['mechanism']} {row['plan_axes']}"
               if "mechanism" in row else "")
            + (f"; levers {row['levers']}" if row.get("levers") else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=",".join(DEFAULT))
    ap.add_argument("--json", default="")
    ap.add_argument("--opt", action="store_true",
                    help="both sides' optimized programs (the levers)")
    args = ap.parse_args(argv)
    rows = []
    for spec in args.cases.split(","):
        arch, shape, *rest = spec.split(":")
        multi = rest == ["multi"]
        ref = reference_row(arch, shape, multi, args.opt)
        port = port_row(arch, shape, multi, args.opt)
        rows.append({"case": spec, "optimized": args.opt, "reference": ref,
                     "port": port})
        print(f"{arch} {shape} {'2x16x16' if multi else '16x16'}"
              f"{' --opt' if args.opt else ''}")
        print(_line("reference", ref))
        print(_line("port", port), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
