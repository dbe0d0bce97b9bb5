"""The port's cluster experiment (the paper's Figs. 6/7/10) in the
discrete-event simulator, priced on the H100 cost model.

    PYTHONPATH=src python tools/simulate_cluster_torch.py --rate 40 --arch llama3.2-3b

Round-robin, Llumnix-like and CascadeInfer serve the same seeded
ShareGPT-shaped workload on ``--instances`` simulated instances whose
iteration times come from ``repro_torch.kernels.cost.H100``. The numbers
are simulated, not measured on a card. Runs on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.kernels.cost import H100  # noqa: E402
from repro_torch.sim.experiment import compare_policies  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--rate", type=float, default=40.0)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--instances", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    res = compare_policies(args.arch, rate=args.rate, duration=args.duration,
                           E=args.instances, seed=args.seed, chip=H100)
    print(f"simulated on {H100.name} ({args.arch}, {args.instances} "
          f"instances, {args.rate} req/s for {args.duration} s)")
    print(f"{'policy':14s} {'TTFT(s)':>9s} {'p95':>9s} {'TPOT(ms)':>9s} "
          f"{'p95':>9s} {'tok/s':>8s}")
    for kind, r in res.items():
        s = r.summary()
        print(f"{kind:14s} {s['ttft_mean']:9.3f} {s['ttft_p95']:9.3f} "
              f"{s['tpot_mean'] * 1e3:9.2f} {s['tpot_p95'] * 1e3:9.2f} "
              f"{s['throughput_tok_s']:8.0f}")
    base = res["round-robin"].summary()
    ca = res["cascade"].summary()
    print(f"\ncascade vs round-robin: TTFT "
          f"-{(1 - ca['ttft_mean'] / base['ttft_mean']) * 100:.0f}%  "
          f"TPOT -{(1 - ca['tpot_mean'] / base['tpot_mean']) * 100:.0f}%  "
          f"throughput x{ca['throughput_tok_s'] / base['throughput_tok_s']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
