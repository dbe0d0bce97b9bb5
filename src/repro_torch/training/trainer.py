"""The training loop on one device — the port of
``repro.training.trainer``: ``Model.loss`` -> ``torch.autograd.grad`` ->
:func:`~repro_torch.training.optimizer.adamw_update`, loss / metric
logging, periodic and final checkpoints.

The attention the loss reaches runs forward on its kernel where one
exists (#6, the causal prefill) and differentiates the kernel's plain
version (``models.attention.causal_prefill``); no step reads the device
but the logged steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.migration import tree_leaves
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import TokenStream
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    log_every: int = 20
    ckpt_every: int = 0              # 0 = only at end
    ckpt_path: Optional[str] = None
    remat: bool = False
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    """A ``TokenStream`` batch of numpy arrays -> tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) put back in ``tree``'s dicts."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return {k: _like(tree[k], leaves) for k in sorted(tree)}


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    remat: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient with respect to every leaf of
    ``params`` (a leaf the loss does not reach gets zeros), then one AdamW
    update in place. ``metrics``: the loss, the loss's own metrics
    (``xent``, an MoE's ``aux``), ``lr`` and ``grad_norm``, as tensors on
    the device."""
    def train_step(params, opt_state: AdamWState, batch):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = model.loss(params, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        params, opt_state, info = adamw_update(
            opt_cfg, _like(params, iter(grads)), opt_state, params)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **info}
        return params, opt_state, metrics
    return train_step


def train(model: Model, params, data: TokenStream,
          cfg: TrainConfig) -> Dict[str, List[float]]:
    """``cfg.steps`` steps on ``data``'s batches, on the device the
    params lie on. Logs (and keeps in the history) the loss, lr and
    gradient norm every ``log_every`` steps and at the last; checkpoints
    every ``ckpt_every`` steps and at the end when ``ckpt_path`` is set.
    Returns the history with the trained ``params``."""
    device = tree_leaves(params)[0].device
    opt_state = init_adamw(params)
    step_fn = make_train_step(model, cfg.opt, cfg.remat)
    history: Dict[str, List[float]] = {"loss": [], "lr": [], "grad_norm": []}
    it = iter(data)
    t0 = time.time()
    for step in range(1, cfg.steps + 1):
        params, opt_state, m = step_fn(params, opt_state,
                                       batch_to(next(it), device))
        if step % cfg.log_every == 0 or step == cfg.steps:
            loss = float(m["loss"])
            history["loss"].append(loss)
            history["lr"].append(float(m["lr"]))
            history["grad_norm"].append(float(m["grad_norm"]))
            rate = step / (time.time() - t0)
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"gnorm {float(m['grad_norm']):.3f}  {rate:.2f} it/s")
        if cfg.ckpt_path and cfg.ckpt_every and step % cfg.ckpt_every == 0:
            save_checkpoint(cfg.ckpt_path, params, step)
    if cfg.ckpt_path:
        save_checkpoint(cfg.ckpt_path, params, cfg.steps)
    history["params"] = params          # type: ignore[assignment]
    return history
