"""Architecture config registry of the port: the reference's eleven
configs, copied field for field. Every one prices a simulator profile
(``sim.costmodel.profile_from_config``); ``models.build_model`` builds the
dense ones it supports and refuses the other families. An unknown name
raises ``KeyError``. Reduced smoke variants come from ``cfg.reduced()``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

ARCHS: List[str] = [
    "whisper-large-v3",
    "qwen3-moe-30b-a3b",
    "starcoder2-3b",
    "qwen2-vl-7b",
    "rwkv6-7b",
    "minitron-8b",
    "smollm-360m",
    "zamba2-2.7b",
    "arctic-480b",
    "qwen2.5-14b",
    # the paper's own evaluation model (Llama-3.2-3B, §6.1)
    "llama3.2-3b",
]


def _module_name(arch: str) -> str:
    return "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    cfg = importlib.import_module(_module_name(arch)).config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
