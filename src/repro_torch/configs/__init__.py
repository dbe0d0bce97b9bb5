"""Architecture config registry of the port.

Lists only the architectures the port runs; any other name raises
``KeyError`` as the JAX registry does for unknown names. Reduced smoke
variants come from ``cfg.reduced()``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.models.common import ModelConfig

ARCHS: List[str] = [
    "smollm-360m",
    # the paper's own evaluation model (Llama-3.2-3B, §6.1)
    "llama3.2-3b",
]


def _module_name(arch: str) -> str:
    return "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {ARCHS}")
    cfg = importlib.import_module(_module_name(arch)).config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg

