"""Numpy bridge between the JAX package's pytrees and the port's tensors.

The port keeps the JAX layout at its public functions (``x @ W`` with
``W [in, out]``, layer-stacked leaves, pools ``[L, NB, BS, Hkv, Dh]``), so
converting is a renaming; migration pieces cross the same way. The
bridge imports no JAX: a caller holding
JAX arrays maps them to numpy first (``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.models.attention import KVCache, QuantKVCache
from repro_torch.models.common import ModelConfig


def _to_tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A copy: the port updates pools in place, and must not write
    through to the caller's arrays."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes: no numpy-native bf16
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _tree_to_torch(tree: Any, dtype, device):
    if isinstance(tree, Mapping):
        return {k: _tree_to_torch(v, dtype, device) for k, v in tree.items()}
    return _to_tensor(tree, dtype, device)


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device="cuda"):
    """JAX decoder params (nested dicts of numpy arrays) -> the port's
    params on ``device`` in ``cfg.dtype``. Checks the top-level layout and
    that every layer leaf is stacked on ``cfg.num_layers``."""
    want = {"embed", "layers", "ln_f"} | (
        set() if cfg.tie_embeddings else {"unembed"})
    if set(tree) != want:
        raise KeyError(f"params keys {sorted(tree)} != {sorted(want)}")
    out = _tree_to_torch(tree, cfg.dtype, device)
    if tuple(out["embed"].shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {tuple(out['embed'].shape)} does not match "
                         f"{cfg.name}")

    def check(layers, path):
        for k, v in layers.items():
            if isinstance(v, dict):
                check(v, f"{path}/{k}")
            elif v.shape[0] != cfg.num_layers:
                raise ValueError(f"{path}/{k}: leading dim {v.shape[0]} != "
                                 f"num_layers {cfg.num_layers}")
    check(out["layers"], "layers")
    return out


def pool_from_numpy(pool: Any, device="cuda", dtype=None):
    """A KV pool or a migration piece of numpy arrays (a JAX ``KVCache``
    ``(k, v)`` or int8 ``QuantKVCache`` ``(k, v, k_scale, v_scale)``
    mapped to numpy; a piece's leaves are the contiguous ``[L, 1,
    written, Hkv, Dh]`` wire format) -> the port's :class:`KVCache` /
    :class:`QuantKVCache` on ``device``. ``dtype`` casts the float K/V
    leaves of a full-width pool; int8 values and f32 scales keep theirs."""
    leaves = tuple(pool)
    if len(leaves) == 4:
        return QuantKVCache(*(_to_tensor(a, None, device) for a in leaves))
    k, v = leaves
    return KVCache(_to_tensor(k, dtype, device), _to_tensor(v, dtype, device))


def pool_to_numpy(pool):
    """The port's pool, or a piece from ``Engine.export_slot`` -> the same
    tuple type of numpy arrays: f32 K/V for a :class:`KVCache` (the JAX
    package's engines import such a piece as ``KVCache(jnp.asarray(k),
    jnp.asarray(v))``), int8 values and f32 scales for a
    :class:`QuantKVCache`."""
    if isinstance(pool, QuantKVCache):
        return QuantKVCache(*(a.detach().cpu().numpy() for a in pool))
    return KVCache(pool.k.detach().float().cpu().numpy(),
                   pool.v.detach().float().cpu().numpy())
