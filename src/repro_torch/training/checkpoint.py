"""Checkpoints: a tree of tensors <-> ``.npz`` with slash-joined key
paths — the port of ``repro.training.checkpoint``, with the same keys
(a dict's keys, a named tuple's field names, a list's indices), so a
checkpoint written by either package loads in the other.

A bf16 leaf is written as f32 (numpy has no bf16; exact, and the
reference's loader casts it back to its leaf's dtype). Loading casts
each array to the dtype of the matching leaf of ``like``, and also reads
the reference's own bf16 arrays (numpy void of 2 bytes: the raw bits).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{slash-joined path: tensor} in ``jax.tree_util`` flattening order."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], join(k)))
    elif hasattr(tree, "_fields"):             # a named tuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), join(k)))
    else:
        for i, v in enumerate(tree):
            out.update(_flatten(v, join(i)))
    return out


def _unflatten(like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, torch.Tensor):
        return flat[prefix]
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, join(k)) for k, v in like.items()}
    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, k), flat, join(k))
                            for k in like._fields))
    return type(like)(_unflatten(v, flat, join(i))
                      for i, v in enumerate(like))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> None:
    """Write ``tree`` (and ``step``, as ``__step__``) to ``path``
    atomically (a temporary file, then a rename)."""
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    if step is not None:
        flat["__step__"] = np.asarray(step)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _to_tensor(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:    # bf16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=leaf.device, dtype=leaf.dtype)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Optional[int]]:
    """Restore into the structure, dtypes and devices of ``like``; returns
    (tree, step). Raises KeyError for a missing leaf and ValueError for a
    shape that differs."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__")) if "__step__" in flat else None
    out = {}
    for key, leaf in _flatten(like).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing {key!r}")
        arr = flat[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        out[key] = _to_tensor(arr, leaf)
    return _unflatten(like, out), step
