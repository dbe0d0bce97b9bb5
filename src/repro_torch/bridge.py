"""Numpy bridge between the JAX package's pytrees and the port's tensors.

The port keeps the JAX layout at its public functions (``x @ W`` with
``W [in, out]``, layer-stacked leaves, pools ``[L, NB, BS, Hkv, Dh]``), so
converting is a renaming, for every family; migration pieces cross the
same way (rwkv6's recurrent state as a dict of its three leaves). The bridge imports no
JAX: a caller holding
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


# leaves the reference keeps in f32 whatever the model dtype: an MoE's
# router, a Mamba2 block's decay, step bias and skip
F32_LEAVES = ("router", "A_log", "dt_bias", "D_skip")


def _tree_to_torch(tree: Any, dtype, device, key=None):
    if isinstance(tree, Mapping):
        return {k: _tree_to_torch(v, dtype, device, k)
                for k, v in tree.items()}
    return _to_tensor(tree, torch.float32 if key in F32_LEAVES else dtype,
                      device)


def _layer_keys(cfg: ModelConfig) -> set:
    """The keys of a decoder layer: attention and its norms, then the FFN,
    or the MoE (with arctic's dense residual FFN and its norm)."""
    keys = {"ln_attn", "ln_mlp", "attn"}
    if not cfg.num_experts:
        return keys | {"ffn"}
    return keys | {"moe"} | ({"ffn", "ln_res"} if cfg.dense_residual
                             else set())


# the 22 leaves of an rwkv6 layer (``rwkv6.init_layer``)
RWKV_LAYER_KEYS = frozenset((
    "ln_att", "ln_ffn", "mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w_r", "w_k",
    "w_v", "w_g", "w_o", "decay_w0", "decay_A", "decay_B", "bonus_u", "ln_x",
    "mu_ck", "mu_cr", "cw_k", "cw_v", "cw_r"))
# the 9 leaves of a Mamba2 block (``mamba2.init_mamba_block``)
MAMBA_KEYS = frozenset(("ln", "w_in", "conv_w", "conv_b", "A_log",
                        "dt_bias", "D_skip", "ln_gate", "w_out"))
# zamba2's shared attention + FFN block, and whisper's layers
SHARED_KEYS = frozenset(("ln_attn", "ln_mlp", "attn", "ffn"))
ENC_LAYER_KEYS = frozenset(("ln1", "ln2", "attn", "ffn"))
DEC_LAYER_KEYS = frozenset(("ln1", "ln2", "ln3", "self_attn", "cross_attn",
                            "ffn"))


def _layout(cfg: ModelConfig):
    """The family's top-level keys, and for each subtree the keys it must
    have and the leading dims every leaf of it is stacked on."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return ({"embed", "layers", "ln_f", "unembed"},
                {"layers": (RWKV_LAYER_KEYS, (L,))})
    if cfg.family == "hybrid":
        return ({"embed", "mamba", "shared", "ln_f", "unembed"},
                {"mamba": (MAMBA_KEYS, (L // cfg.attn_every,
                                        cfg.attn_every)),
                 "shared": (SHARED_KEYS, ())})
    if cfg.family == "encdec":
        return ({"enc_pos", "enc_layers", "enc_ln", "embed", "dec_pos",
                 "dec_layers", "dec_ln"},
                {"enc_layers": (ENC_LAYER_KEYS, (cfg.encoder_layers,)),
                 "dec_layers": (DEC_LAYER_KEYS, (L,)),
                 "enc_ln": ({"w", "b"}, ()), "dec_ln": ({"w", "b"}, ())})
    return ({"embed", "layers", "ln_f"} | (
        set() if cfg.tie_embeddings else {"unembed"}),
        {"layers": (_layer_keys(cfg), (L,))})


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device="cuda"):
    """JAX params (nested dicts of numpy arrays) of any family -> the
    port's params on ``device`` in ``cfg.dtype``, the reference's dtype for
    every leaf (an MoE router and a Mamba2 block's ``A_log`` / ``dt_bias``
    / ``D_skip`` stay f32, as the reference keeps them). Checks the
    top-level keys, each subtree's keys, and that every leaf of a layer
    stack leads with the stack's dims: ``num_layers`` (whisper's encoder:
    ``encoder_layers``; zamba2's Mamba2 blocks: ``[groups, attn_every]``)."""
    top, subtrees = _layout(cfg)
    if set(tree) != top:
        raise KeyError(f"params keys {sorted(tree)} != {sorted(top)}")
    for name, (keys, _) in subtrees.items():
        if set(tree[name]) != set(keys):
            raise KeyError(f"{name} keys {sorted(tree[name])} != "
                           f"{sorted(keys)}")
    out = _tree_to_torch(tree, cfg.dtype, device)
    if tuple(out["embed"].shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {tuple(out['embed'].shape)} does not match "
                         f"{cfg.name}")

    def check(layers, path, lead):
        for k, v in layers.items():
            if isinstance(v, dict):
                check(v, f"{path}/{k}", lead)
            elif tuple(v.shape[:len(lead)]) != lead:
                raise ValueError(f"{path}/{k}: leading dims "
                                 f"{tuple(v.shape[:len(lead)])} != {lead}")
    for name, (_, lead) in subtrees.items():
        check(out[name], name, lead)
    return out


def pool_from_numpy(pool: Any, device="cuda", dtype=None):
    """A KV pool or a migration piece of numpy arrays (a JAX ``KVCache``
    ``(k, v)`` or int8 ``QuantKVCache`` ``(k, v, k_scale, v_scale)``
    mapped to numpy; a piece's leaves are the contiguous ``[L, 1,
    written, Hkv, Dh]`` wire format, a window's whole ring ``[L, 1, W,
    Hkv, Dh]``) -> the port's :class:`KVCache` / :class:`QuantKVCache` on
    ``device``. ``dtype`` casts the float K/V leaves of a full-width pool;
    int8 values and f32 scales keep theirs. An rwkv6 state (a dict of
    ``S`` / ``att_prev`` / ``ffn_prev``) comes back a dict, each leaf in
    its own dtype."""
    if isinstance(pool, Mapping):
        return {k: _to_tensor(a, None, device) for k, a in pool.items()}
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
    :class:`QuantKVCache`; an rwkv6 state dict -> a dict of f32 arrays
    (the reference's engine casts each leaf to its own on import)."""
    if isinstance(pool, Mapping):
        return {k: a.detach().float().cpu().numpy() for k, a in pool.items()}
    if isinstance(pool, QuantKVCache):
        return QuantKVCache(*(a.detach().cpu().numpy() for a in pool))
    return KVCache(pool.k.detach().float().cpu().numpy(),
                   pool.v.detach().float().cpu().numpy())
