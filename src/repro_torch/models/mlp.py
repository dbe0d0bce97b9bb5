"""Dense feed-forward layer — the port of ``repro.models.mlp.ffn``
(SwiGLU / GELU; MoE is not ported yet)."""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig, act_fn, dense_init


def init_ffn(gen: torch.Generator, cfg: ModelConfig, num_layers: int):
    """Layer-stacked FFN weights ``[L, in, out]``."""
    d, f, L = cfg.d_model, cfg.d_ff, num_layers
    if cfg.act == "swiglu":
        return {
            "w_gate": dense_init(gen, (L, d, f), cfg.dtype, fan_in=d),
            "w_up": dense_init(gen, (L, d, f), cfg.dtype, fan_in=d),
            "w_down": dense_init(gen, (L, f, d), cfg.dtype, fan_in=f),
        }
    dev = gen.device
    return {
        "w_up": dense_init(gen, (L, d, f), cfg.dtype, fan_in=d),
        "b_up": torch.zeros((L, f), dtype=cfg.dtype, device=dev),
        "w_down": dense_init(gen, (L, f, d), cfg.dtype, fan_in=f),
        "b_down": torch.zeros((L, d), dtype=cfg.dtype, device=dev),
    }


def ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    a = act_fn(cfg.act)
    if "w_gate" in p:
        return (a(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return a(x @ p["w_up"] + p["b_up"]) @ p["w_down"] + p["b_down"]
