"""Training launcher — the port of ``repro.launch.train``.

Runs AdamW steps of ``Model.loss`` on the synthetic token stream under
the reference's training layout on a (data, model) group of ranks, and
optionally writes a checkpoint:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch smollm-360m --reduced --steps 20 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --devices cpu,cpu --arch smollm-360m --reduced --model-parallel 2

It runs on the card unless ``--device cpu`` is given. The flags are the
reference's, plus ``--device``, ``--devices`` (one entry per rank, e.g.
``cuda:0,cuda:0`` or ``cpu,cpu``; default every visible card, or one
``cpu`` with ``--device cpu``). ``--model-parallel N`` splits the model
over ``min(N, ranks)`` ranks, as the reference clamps it to its devices;
the rest of the ranks split the batch. More than one rank starts ranks
1..R-1 as ``launch.train_worker`` processes
(``launch.mesh.make_train_mesh``: gloo on the CPU or where ranks share a
card, nccl when each has its own); the mechanism that splits the model
(tensor parallelism, the per-leaf partition, or gather-on-use where no
block's dims divide, ``training.trainer.sharding_mechanism``) is printed
first. ``--ckpt`` gathers the shards
and writes the whole tree, which the reference's ``load_checkpoint``
reads.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.trainer import (ShardedRun, batch_to,
                                          make_train_step,
                                          sharding_mechanism, train_sharded)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="device of the weights and the step (default: the "
                         "card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--devices", default="",
                    help="one device per rank, comma-separated (default: "
                         "every visible card, or one cpu with --device cpu)")
    return ap.parse_args(argv)


def rank_devices(args: argparse.Namespace) -> List[str]:
    if args.devices:
        return args.devices.split(",")
    if args.device == "cpu":
        return ["cpu"]
    return [f"cuda:{i}" for i in range(max(torch.cuda.device_count(), 1))]


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    devices = rank_devices(args)
    R = len(devices)
    model_size = min(args.model_parallel, R)
    if model_size < 1 or R % model_size:
        raise SystemExit(f"--model-parallel {args.model_parallel}: {R} "
                         f"ranks ({','.join(devices)}) do not split into "
                         f"model groups of {model_size}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    data = DataConfig(batch_size=args.batch, seq_len=args.seq)
    log_every = max(args.steps // 10, 1)
    if R > 1:
        return _main_sharded(args, cfg, devices, model_size, opt_cfg, data,
                             log_every)
    print(f"1 rank on {devices[0]}: no sharding")
    model = build_model(cfg)
    step_fn = make_train_step(model, opt_cfg)
    params = model.init(0, device=devices[0])
    opt_state = init_adamw(params)
    it = iter(TokenStream(cfg, data))
    losses = []
    for step in range(1, args.steps + 1):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_to(next(it), devices[0]))
        if step % log_every == 0 or step == 1:
            losses.append(float(m["loss"]))
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"lr {float(m['lr']):.2e}")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, args.steps)
        print("saved", args.ckpt)
    return {"params": params, "losses": losses}


def _main_sharded(args, cfg, devices, model_size, opt_cfg, data,
                  log_every) -> dict:
    from repro_torch.launch.mesh import make_train_mesh
    R = len(devices)
    why = sharding_mechanism(cfg, model_size).why
    mesh = make_train_mesh(model_size, devices)
    print(f"{R} ranks on {','.join(devices)} over {mesh.backend}: "
          f"(data {mesh.data}, model {mesh.model}); {why}", flush=True)
    try:
        res = mesh.run(train_sharded, ShardedRun(
            cfg, args.steps, opt_cfg, data, init=0, log_every=log_every,
            ckpt_path=args.ckpt))
    finally:
        mesh.close()
    if args.ckpt:
        print("saved", args.ckpt)
    hist = res[0]["history"]
    return {"losses": [h["loss"] for h in hist
                       if h["step"] % log_every == 0 or h["step"] == 1],
            "ranks": res}


if __name__ == "__main__":
    main()
