#!/usr/bin/env python3
"""End-to-end training script of the PyTorch port, the twin of
``examples/train_lm.py``: train a ~100M-parameter llama-family model for a
few hundred steps on the synthetic bigram stream and checkpoint it.

    python3 tools/train_lm_torch.py --steps 300 --device cuda
    python3 tools/train_lm_torch.py --device cpu     # a short smoke run

(defaults to a short smoke run of a small proxy; ``--full-size`` is the
~100M model; ``--steps 300`` is the full run). The run fails unless the
last logged loss is below the first.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.migration import tree_leaves  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.trainer import TrainConfig, train  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="chiprun_out/repro_torch_lm.npz")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-size", action="store_true",
                    help="~100M params (slow on CPU); default is a small "
                         "proxy")
    args = ap.parse_args(argv)

    base = get_config("smollm-360m")
    if args.full_size:
        # ~100M-class: 12L x 768d, GQA 12/4, ff 3072, 16k vocab
        cfg = dataclasses.replace(base, num_layers=12, d_model=768,
                                  num_heads=12, num_kv_heads=4, head_dim=64,
                                  d_ff=3072, vocab_size=16384,
                                  name="smollm-100m")
    else:
        cfg = dataclasses.replace(base.reduced(), num_layers=4, d_model=256,
                                  vocab_size=2048, name="smollm-tiny")
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params")
    stream = TokenStream(cfg, DataConfig(batch_size=args.batch,
                                         seq_len=args.seq))
    hist = train(model, params, stream,
                 TrainConfig(steps=args.steps,
                             log_every=max(args.steps // 15, 1),
                             ckpt_path=args.ckpt,
                             opt=AdamWConfig(lr=6e-4,
                                             warmup_steps=args.steps // 10,
                                             total_steps=args.steps)))
    print(f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
          f"checkpoint at {args.ckpt}")
    assert hist["loss"][-1] < hist["loss"][0]
    return hist


if __name__ == "__main__":
    main()
