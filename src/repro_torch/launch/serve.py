"""Serving launcher: a CascadeInfer MILS cluster over the port's torch
engines — the port of ``repro.launch.serve``.

Replays a ShareGPT-shaped ``sim.workload`` trace open-loop against the
engines (arrival times mapped to server steps) through the control
plane, then prints the server's summary and its final stage bounds.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch smollm-360m --engines 4 --requests 12

It runs on the card unless ``--device cpu`` is given, on the reduced
config of ``--arch`` unless ``--full-width`` keeps its published widths
and depth. The flags are the reference launcher's under its names and
defaults — int8 KV (``--kv-dtype``), the host KV tier
(``--host-kv-budget``, on at 4096 tokens; 0 without the prefix cache),
SLO preemption (on), the host loop (``--host-loop``), whole-prompt
prefill (``--no-chunked-prefill``), the prefix cache
(``--no-prefix-cache``), the fault model (``--crash``, ``--rejoin``,
``--transfer-loss-p``, ...) — plus ``--device``, ``--full-width``,
``--dtype`` and ``--sliding-window``. An arch without a paged path (rwkv6,
or any decoder given a window) serves from slab engines: the host loop
and whole-prompt prefill, the host tier off. ``--tp 2`` shards every
engine over two ranks, ``--tp 2,1,1,1`` only the first (a heterogeneous
cluster); ``--tp-devices`` lists the ranks' devices (default one card
each, refused when the machine has fewer; ``cuda:0,cuda:0`` puts two
ranks on one card) and ``--tp-backend`` the collectives' (gloo, nccl).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.control.faults import FaultSpec
from repro_torch.core.partition import PipelinePlan, Stage
from repro_torch.core.qoe import QoEModel
from repro_torch.models import build_model
from repro_torch.models.attention import KV_DTYPES, PAGED_BACKENDS
from repro_torch.sched import assign_classes, parse_class_mix
from repro_torch.serving.server import (MILSServer, ServerConfig,
                                        requests_from_trace)
from repro_torch.sim.workload import WorkloadSpec, generate

# the reference launcher's fitted QoE coefficients (F = [1, n, ΣI, ΣI², ΣL])
DEFAULT_QOE = (1e-3, 1e-4, 1e-6, 0.0, 1e-6)


def default_plan(num_engines: int, max_seq: int) -> PipelinePlan:
    """Two length stages splitting the engine pool at ``max_seq / 4``
    (bootstrapping plan; production planning uses ``core.partition`` on
    profiled stats)."""
    if num_engines == 1:
        return PipelinePlan([Stage(0.0, float("inf"), 1)], 0.0)
    half = num_engines // 2
    return PipelinePlan(
        [Stage(0.0, max_seq / 4, num_engines - half),
         Stage(max_seq / 4, float("inf"), half)], 0.0)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--device", default="cuda",
                    help="device of the weights and KV pools (default: the "
                         "card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the arch at its published widths and depth "
                         "(default: its reduced smoke config)")
    ap.add_argument("--sliding-window", type=int, default=None,
                    help="attention window of a decoder (default: the "
                         "config's; starcoder2's published config sets "
                         "4096): its KV then lives in a ring on slab "
                         "engines")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="weights and activations (and bf16 KV pools)")
    ap.add_argument("--engines", type=int, default=4)
    ap.add_argument("--tp", default="1",
                    help="tensor-parallel ranks per engine: one int ('2') "
                         "for every engine, or a comma list ('2,1,1,1') "
                         "for a heterogeneous cluster")
    ap.add_argument("--tp-devices", default=None,
                    help="the ranks' devices, comma-separated (default: "
                         "cuda:0..N-1, refused when fewer cards are "
                         "present, or the CPU with --device cpu); list one "
                         "card twice (cuda:0,cuda:0) to share it")
    ap.add_argument("--tp-backend", default=None, choices=["gloo", "nccl"],
                    help="the forward's collectives (default: nccl on "
                         "cards, gloo on the CPU; two ranks on one card "
                         "need gloo)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--policy", default="cascade",
                    choices=["cascade", "round-robin", "least-loaded"])
    ap.add_argument("--refinement", default="adaptive",
                    choices=["adaptive", "quantity", "memory", "none"])
    ap.add_argument("--balancing", default="full",
                    choices=["full", "inter-stage", "rr"])
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-slots", type=int, default=3)
    ap.add_argument("--attn-backend", default=None,
                    choices=list(PAGED_BACKENDS),
                    help="paged attention backend: 'fused' (default) runs "
                         "one kernel per layer per step; 'flat' and 'grid' "
                         "run the chunked prefill kernel, then their decode "
                         "kernel (flat work list, or one block per request "
                         "and kv head); 'dense' gathers the pool and runs "
                         "a masked SDPA in plain PyTorch, no kernel")
    ap.add_argument("--kv-dtype", default="bf16", choices=list(KV_DTYPES),
                    help="paged KV pool: 'bf16' keeps the model's dtype, "
                         "'int8' halves KV bytes (int8 rows with f32 "
                         "scales; needs the fused or dense backend)")
    ap.add_argument("--host-loop", action="store_true",
                    help="the host-driven engine step loop (default: the "
                         "device-resident one)")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="whole-prompt prefill at admission (the §2.1 "
                         "head-of-line baseline)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="refcounted prefix-shared KV pool (the default)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable prefix sharing (and with it the host KV "
                         "tier)")
    ap.add_argument("--host-kv-budget", type=int, default=4096,
                    help="host-RAM KV tier capacity in tokens per engine: "
                         "evicted prefix chains demote here instead of "
                         "dropping, and hits promote back (0 = off)")
    ap.add_argument("--no-kv-tiering", dest="host_kv_budget",
                    action="store_const", const=0,
                    help="disable the host KV tier (--host-kv-budget 0)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prompt-chunk tokens packed per mixed iteration "
                         "(default 256)")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="workload arrivals/s, replayed at 1 step/s")
    ap.add_argument("--slo-class-mix", default=None,
                    help="SLO service-class mix of the replayed trace, "
                         "e.g. 'interactive:0.5,standard:0.3,batch:0.2' "
                         "(default: all standard)")
    ap.add_argument("--preemption", dest="preemption",
                    action="store_true", default=True,
                    help="SLO-tiered preemptive scheduling (the default)")
    ap.add_argument("--no-preemption", dest="preemption",
                    action="store_false",
                    help="disable preemption: FCFS queues")
    ap.add_argument("--slo-scale", type=float, default=1.0,
                    help="SLO-scale sweep knob (paper §6.4)")
    ap.add_argument("--slo-time-scale", type=float, default=1.0,
                    help="engine steps per abstract SLO second")
    ap.add_argument("--crash", action="append", default=[],
                    metavar="ENGINE:STEP",
                    help="chaos: kill engine ENGINE at step STEP "
                         "(repeatable)")
    ap.add_argument("--rejoin", action="append", default=[],
                    metavar="ENGINE:STEP",
                    help="chaos: revive a crashed engine at step STEP "
                         "(fresh state; its old residents were already "
                         "redispatched)")
    ap.add_argument("--transfer-loss-p", type=float, default=0.0,
                    help="chaos: probability a migration transfer is lost "
                         "on the wire (rolled back after the timeout)")
    ap.add_argument("--transfer-stall-p", type=float, default=0.0,
                    help="chaos: probability a transfer stalls past its "
                         "deadline (treated as lost)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault injector")
    ap.add_argument("--migration-timeout-steps", type=int, default=4,
                    help="steps before an in-flight transfer is rolled "
                         "back to its sender")
    ap.add_argument("--dead-after-steps", type=int, default=6,
                    help="heartbeat-free steps before an engine is "
                         "declared dead and its residents redispatched")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def fault_spec(args: argparse.Namespace) -> Optional[FaultSpec]:
    """The chaos flags as a ``FaultSpec`` (None when none is given)."""
    def events(specs):
        return tuple((int(e), float(t)) for e, t in
                     (item.split(":", 1) for item in specs))
    if not (args.crash or args.rejoin or args.transfer_loss_p > 0
            or args.transfer_stall_p > 0):
        return None
    return FaultSpec(seed=args.fault_seed, crashes=events(args.crash),
                     rejoins=events(args.rejoin),
                     transfer_loss_p=args.transfer_loss_p,
                     transfer_stall_p=args.transfer_stall_p)


def parse_tp(text: str, engines: int) -> List[int]:
    """``--tp``: one int for every engine, or a comma list of one each."""
    tps = [int(x) for x in text.split(",")]
    return tps if len(tps) > 1 else tps * engines


def build_server(args: argparse.Namespace) -> MILSServer:
    """The launcher's cluster: ``--arch`` weights (reduced unless
    ``--full-width``) from seed 0 on ``--device``, shared by ``--engines``
    engines under the default two-stage plan, and the replayed trace on
    its arrival schedule."""
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    if args.sliding_window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=args.sliding_window)
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    # the host tier keeps evicted pool blocks: a slab engine has none
    host_kv = (args.host_kv_budget if args.prefix_cache
               and model.supports_paged else 0)
    srv = MILSServer(model, params, default_plan(args.engines, args.max_seq),
                     QoEModel(np.array(DEFAULT_QOE)),
                     ServerConfig(policy=args.policy,
                                  refinement=args.refinement,
                                  balancing=args.balancing, seed=args.seed,
                                  preemption=args.preemption,
                                  slo_scale=args.slo_scale,
                                  slo_time_scale=args.slo_time_scale,
                                  host_kv_budget=host_kv,
                                  faults=fault_spec(args),
                                  migration_timeout_steps=(
                                      args.migration_timeout_steps),
                                  dead_after_steps=args.dead_after_steps),
                     max_slots=args.max_slots, max_seq=args.max_seq,
                     attn_backend=args.attn_backend, kv_dtype=args.kv_dtype,
                     device_resident=False if args.host_loop else None,
                     prefill_token_budget=args.prefill_budget,
                     chunked_prefill=(False if args.no_chunked_prefill
                                      else None),
                     prefix_cache=args.prefix_cache,
                     tp=parse_tp(args.tp, args.engines),
                     tp_devices=(args.tp_devices.split(",")
                                 if args.tp_devices else None),
                     tp_backend=args.tp_backend)
    spec = WorkloadSpec(rate=args.arrival_rate,
                        duration=args.requests / args.arrival_rate,
                        seed=args.seed)
    trace = generate(spec)[:args.requests]
    if args.slo_class_mix:
        classes = assign_classes(len(trace),
                                 parse_class_mix(args.slo_class_mix),
                                 np.random.default_rng(args.seed))
        trace = [dataclasses.replace(r, slo_class=c)
                 for r, c in zip(trace, classes)]
    for req, step in requests_from_trace(trace, vocab_size=cfg.vocab_size,
                                         max_seq=args.max_seq,
                                         seed=args.seed):
        srv.submit_at(req, step)
    return srv


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    srv = build_server(args)
    try:
        srv.run(max_steps=100 * args.requests)
        print("summary:", {k: round(v, 2) if isinstance(v, float) else v
                           for k, v in srv.summary().items()})
        print("stage bounds:", srv.stage_bounds)
        print("tp:", srv.tps)
    finally:
        srv.close()


if __name__ == "__main__":
    main()
