"""Training launcher on one device — the port of ``repro.launch.train``.

Runs AdamW steps of ``Model.loss`` on the synthetic token stream and
optionally writes a checkpoint:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch smollm-360m --reduced --steps 20 --batch 8 --seq 128

It runs on the card unless ``--device cpu`` is given. The flags are the
reference's, plus ``--device``. Tensor parallelism is not ported
(ROADMAP, Queue 1: tensor parallelism): ``--model-parallel`` above 1 is
refused.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.trainer import batch_to, make_train_step


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
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if args.model_parallel > 1:
        raise SystemExit(
            f"--model-parallel {args.model_parallel}: tensor parallelism is "
            "not ported yet (ROADMAP.md, Queue 1, 'Tensor parallelism'); "
            "this launcher trains on one device")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)
    params = model.init(0, device=args.device)
    opt_state = init_adamw(params)
    stream = TokenStream(cfg, DataConfig(batch_size=args.batch,
                                         seq_len=args.seq))
    it = iter(stream)
    losses = []
    for step in range(1, args.steps + 1):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_to(next(it), args.device))
        if step % max(args.steps // 10, 1) == 0 or step == 1:
            losses.append(float(m["loss"]))
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"lr {float(m['lr']):.2e}")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, args.steps)
        print("saved", args.ckpt)
    return {"params": params, "losses": losses}


if __name__ == "__main__":
    main()
