"""Decoder-only transformer stack (dense GQA) on the paged pool — the
port's subset of ``repro.models.transformer``.

Per-layer weights are stacked on a leading ``L`` axis as in the JAX
package; the ``lax.scan`` over layers becomes a Python loop over ``[l]``
slices (views, no copies). The pool ``[L, NB, BS, Hkv, Dh]`` is updated in
place, layer by layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import flat_work_list
from repro_torch.models import attention as attn
from repro_torch.models.attention import (KVCache, layer_pool,
                                         make_paged_pool)
from repro_torch.models.common import (ModelConfig, dense_init, embed_init,
                                       rms_norm)
from repro_torch.models.mlp import ffn, init_ffn


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_decoder(gen: torch.Generator, cfg: ModelConfig):
    """Random weights on ``gen``'s device, drawn directly in the stacked
    layout (no per-layer copies to stack)."""
    d, h, hk, dh, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.num_layers)
    dev, dt = gen.device, cfg.dtype
    att = {
        "wq": dense_init(gen, (L, d, h * dh), dt, fan_in=d),
        "wk": dense_init(gen, (L, d, hk * dh), dt, fan_in=d),
        "wv": dense_init(gen, (L, d, hk * dh), dt, fan_in=d),
        "wo": dense_init(gen, (L, h * dh, d), dt, fan_in=h * dh),
    }
    if cfg.qkv_bias:
        att["bq"] = torch.zeros((L, h * dh), dtype=dt, device=dev)
        att["bk"] = torch.zeros((L, hk * dh), dtype=dt, device=dev)
        att["bv"] = torch.zeros((L, hk * dh), dtype=dt, device=dev)
    p = {
        "embed": embed_init(gen, (cfg.vocab_size, d), dt),
        "layers": {
            "ln_attn": torch.ones((L, d), dtype=dt, device=dev),
            "ln_mlp": torch.ones((L, d), dtype=dt, device=dev),
            "attn": att,
            "ffn": init_ffn(gen, cfg, L),
        },
        "ln_f": torch.ones((d,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (d, cfg.vocab_size), dt)
    return p


def layer_params(layers, l: int):
    """Layer ``l``'s slice of the stacked weights (views)."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in layers.items()}


# --------------------------------------------------------------------------
# Embedding in/out, MLP half of a block
# --------------------------------------------------------------------------
def embed_tokens(p, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["embed"])


def unembed(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    return x @ w


def _mlp_part(pl, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return ffn(pl["ffn"], cfg, rms_norm(x, pl["ln_mlp"], cfg.norm_eps))


# --------------------------------------------------------------------------
# Full-stack passes over the paged pool
# --------------------------------------------------------------------------
def forward_decode_paged(p, cfg: ModelConfig, token: torch.Tensor,
                         pool: KVCache, block_tables: torch.Tensor,
                         pos: torch.Tensor, *, attn_backend: str = "fused",
                         attn_num_work=None):
    """token [B] int; pool leaves [L, NB, BS, Hkv, Dh] (a ``KVCache``, or
    an int8 ``QuantKVCache`` on the fused backend); block_tables
    [B, NBT] int32; pos [B] int32 (-1 = dead slot). Returns
    (logits [B, V], pool) — the pool updated in place. On the ``flat``
    backend the layers share one flat work list."""
    work_list = None
    if attn_backend == "flat":
        B, NBT = block_tables.shape
        work_list = flat_work_list(pos + 1, NBT, pool.k.shape[2],
                                   attn_num_work or B * NBT)
    x = embed_tokens(p, cfg, token[:, None])
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        h = rms_norm(x, pl["ln_attn"], cfg.norm_eps)
        a, _ = attn.attention_decode_paged(
            pl["attn"], cfg, h, layer_pool(pool, l), block_tables,
            pos, attn_backend=attn_backend, attn_num_work=attn_num_work,
            attn_work_list=work_list)
        x = x + a
        x = x + _mlp_part(pl, cfg, x)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x)[:, 0], pool


def forward_mixed(p, cfg: ModelConfig, dec_token: torch.Tensor,
                  ck_tokens: torch.Tensor, pool: KVCache,
                  bt_dec: torch.Tensor, bt_ck: torch.Tensor,
                  pos: torch.Tensor, ctx_len: torch.Tensor,
                  chunk_len: torch.Tensor, *, attn_backend: str = "fused",
                  attn_num_work=None):
    """One whole MIXED iteration through the stack: the decode batch
    (``dec_token [Bd]``, ``pos [Bd]``, -1 = dead slot) advances one token
    while prompt chunks (``ck_tokens [Bp, C]``, ``ctx_len``/``chunk_len``
    [Bp]) prefill beside it — ONE fused attention launch per layer (two
    on the ``flat`` backend).
    Returns ``(dec_logits [Bd, V], ck_logits [Bp, V], pool)``, ck_logits
    at each chunk's last real position."""
    x_dec = embed_tokens(p, cfg, dec_token[:, None])
    x_ck = embed_tokens(p, cfg, ck_tokens)
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        hd = rms_norm(x_dec, pl["ln_attn"], cfg.norm_eps)
        hc = rms_norm(x_ck, pl["ln_attn"], cfg.norm_eps)
        ad, ac, _ = attn.attention_mixed_paged(
            pl["attn"], cfg, hd, hc, layer_pool(pool, l), bt_dec,
            bt_ck, pos, ctx_len, chunk_len, attn_backend=attn_backend,
            attn_num_work=attn_num_work)
        x_dec = x_dec + ad
        x_ck = x_ck + ac
        x_dec = x_dec + _mlp_part(pl, cfg, x_dec)
        x_ck = x_ck + _mlp_part(pl, cfg, x_ck)
    x_dec = rms_norm(x_dec, p["ln_f"], cfg.norm_eps)
    x_ck = rms_norm(_last_real(x_ck, chunk_len), p["ln_f"], cfg.norm_eps)
    return (unembed(p, cfg, x_dec)[:, 0], unembed(p, cfg, x_ck)[:, 0], pool)


def _last_real(x: torch.Tensor, chunk_len: torch.Tensor) -> torch.Tensor:
    """x [B, C, D] -> [B, 1, D] at each chunk's last real row."""
    last = (chunk_len.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    return torch.gather(x, 1, last)


def forward_prefill_chunk(p, cfg: ModelConfig, tokens: torch.Tensor,
                          pool: KVCache, block_tables: torch.Tensor,
                          ctx_len: torch.Tensor, chunk_len: torch.Tensor, *,
                          attn_backend: str = "fused"):
    """Prompt chunks through the stack against the paged pool: tokens
    [B, C] int (rows past ``chunk_len`` are padding), block_tables
    [B, NBT], ctx_len / chunk_len [B] int32. Every layer writes the
    chunk's K/V into its pool slice and attends over the written context
    plus the chunk, so chunk-by-chunk calls reproduce the whole prompt's
    cache rows. Returns (logits [B, V] at each chunk's last real token,
    pool) — on a prompt's final chunk, its first-token distribution."""
    x = embed_tokens(p, cfg, tokens)
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        h = rms_norm(x, pl["ln_attn"], cfg.norm_eps)
        a, _ = attn.attention_prefill_chunk_paged(
            pl["attn"], cfg, h, layer_pool(pool, l), block_tables,
            ctx_len, chunk_len, attn_backend=attn_backend)
        x = x + a
        x = x + _mlp_part(pl, cfg, x)
    x = rms_norm(_last_real(x, chunk_len), p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x)[:, 0], pool


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=None, device="cuda", kv_dtype: str = "bf16"):
    """Global paged KV pool: leaves [L, NB, BS, Hkv, Dh], zeroed
    (``kv_dtype="int8"``: the :class:`~repro_torch.models.attention.
    QuantKVCache` layout, scales [L, NB, BS, Hkv] starting at zero).
    Blocks are owned by requests via the engine's BlockAllocator; the
    model only sees block tables."""
    assert not cfg.sliding_window, "paged cache is full-attention only"
    return make_paged_pool(cfg, num_blocks, block_size, dtype=dtype,
                           device=device, kv_dtype=kv_dtype,
                           layers=cfg.num_layers)
