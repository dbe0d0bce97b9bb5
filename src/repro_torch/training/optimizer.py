"""AdamW with a linear-warmup cosine schedule over nested dicts of
tensors — the port of ``repro.training.optimizer``, its arithmetic in
f32 step for step: global-norm clipping, bias correction, decoupled
weight decay on matrices only (``ndim >= 2``), the result cast to each
parameter's dtype. ``torch.optim.AdamW`` is not used: it applies the
decay before the moment update and clips nothing.

The update is IN PLACE: the parameters and the f32 moments are updated
where they lie (a functional copy would hold a second set of moments,
25.6 GB at llama3.2-3b) and returned, as the port's caches are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.migration import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar: updates applied
    mu: Any                # f32, shaped like the params
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int tensor), f32:
    linear warmup over ``warmup_steps``, then a cosine down to
    ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_adamw(params) -> AdamWState:
    """Zero f32 moments shaped like ``params``, step 0 on their device."""
    leaf = tree_leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params))


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together, in f32 (leaves in
    ``jax.tree.leaves`` order, as the reference sums them)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step of ``grads`` (shaped like ``params``). Returns
    (params, state, {"lr", "grad_norm"}), params and moments updated in
    place; the scalars stay on the device (no host read). ``gnorm`` is
    the clip's global norm when the caller has it (a sharded step: the
    whole model's, not this shard's); by default ``global_norm(grads)``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:     # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.mu, state.nu), {
        "lr": lr, "grad_norm": gnorm}
