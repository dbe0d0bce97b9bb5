"""Model record over the port's families — the counterpart of
``repro.models.model``, with the entry-point signatures of its serving
paths (tokens are int tensors, not the reference's batch dicts):

    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    logits, cache = model.prefill(params, tokens, cache_len)   # [B, V]
    slab = model.init_cache(batch, seq, device="cuda")
    logits, slab = model.decode_step(params, slab, token, pos)
    logits, piece = model.prefill_bucketed(params, tokens, true_len)
    pool = model.init_paged_cache(num_blocks, block_size, device="cuda",
                                  kv_dtype="bf16")   # or "int8"
    logits, pool = model.decode_step_paged(params, pool, token, bt, pos)
    logits, pool = model.prefill_chunk(params, pool, tokens, bt, ctx, clen)
    dec_logits, ck_logits, pool = model.mixed_step(
        params, pool, dec_token, ck_tokens, bt_dec, bt_ck, pos, ctx, clen)

Only the dense full-attention decoder is ported so far; ``build_model``
raises for every other family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from repro_torch.models import transformer
from repro_torch.models.attention import KVCache
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # init(rng, device="cuda") -> params; rng is a seed or a torch.Generator
    init: Callable[..., Any]
    # init_paged_cache(num_blocks, block_size, device="cuda", dtype=None,
    #                  kv_dtype="bf16") -> pool [L, NB, BS, Hkv, Dh]
    #     (kv_dtype "int8": a QuantKVCache with scales [L, NB, BS, Hkv])
    init_paged_cache: Callable[..., Any]
    # decode_step_paged(params, pool, token, block_tables, pos, *,
    #                   attn_backend, attn_num_work) -> (logits [B, V], pool)
    decode_step_paged: Callable[..., Any]
    # prefill_chunk(params, pool, tokens, block_tables, ctx_len, chunk_len,
    #               *, attn_backend) -> (last-real-token logits [B, V], pool)
    prefill_chunk: Callable[..., Any]
    # mixed_step(params, pool, dec_token, ck_tokens, bt_dec, bt_ck, pos,
    #            ctx_len, chunk_len, *, attn_backend, attn_num_work)
    #     -> (dec_logits [Bd, V], ck_logits [Bp, V], pool)
    mixed_step: Callable[..., Any]
    # prefill(params, tokens [B, T], cache_len=None)
    #     -> (last-token logits [B, V], slab [L, B, cache_len or T, ...])
    prefill: Callable[..., Any]
    # decode_step(params, slab, token, pos, rows=None) -> (logits, slab)
    decode_step: Callable[..., Any]
    # init_cache(batch, seq, device="cuda", dtype=None) -> zeroed slab
    init_cache: Callable[..., Any]
    # prefill_bucketed(params, tokens [B, P], true_len) -> (logits [B, V]
    #     at position true_len - 1, prompt piece [L, B, P, Hkv, Dh])
    prefill_bucketed: Callable[..., Any]

    @property
    def supports_paged(self) -> bool:
        return self.decode_step_paged is not None


def _relay_kv(piece: KVCache, cache_len: int) -> KVCache:
    """Prompt-length per-layer KV [L, B, T, Hkv, Dh] -> a zeroed decode
    slab [L, B, cache_len, Hkv, Dh] holding it: positions ``T - take ..
    T - 1`` (``take = min(T, cache_len)``) at row ``position %
    cache_len``. The reference's ring layout for sliding windows is not
    ported."""
    L, B, T = piece.k.shape[:3]
    if cache_len == T:
        return piece
    take = min(T, cache_len)
    idx = torch.arange(T - take, T, device=piece.k.device) % cache_len

    def relay(a):
        buf = a.new_zeros((L, B, cache_len) + a.shape[3:])
        buf[:, :, idx] = a[:, :, T - take:]
        return buf

    return KVCache(relay(piece.k), relay(piece.v))


def _decoder_model(cfg: ModelConfig) -> Model:
    def init(rng: Union[int, torch.Generator] = 0, device="cuda"):
        if isinstance(rng, torch.Generator):
            gen = rng
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(rng))
        return transformer.init_decoder(gen, cfg)

    def init_paged_cache(num_blocks: int, block_size: int, device="cuda",
                         dtype=None, kv_dtype: str = "bf16"):
        return transformer.init_paged_cache(cfg, num_blocks, block_size,
                                            dtype=dtype, device=device,
                                            kv_dtype=kv_dtype)

    def decode_step_paged(params, pool, token, block_tables, pos, *,
                          attn_backend="fused", attn_num_work=None):
        return transformer.forward_decode_paged(
            params, cfg, token, pool, block_tables, pos,
            attn_backend=attn_backend, attn_num_work=attn_num_work)

    def prefill_chunk(params, pool, tokens, block_tables, ctx_len, chunk_len,
                      *, attn_backend="fused"):
        return transformer.forward_prefill_chunk(
            params, cfg, tokens, pool, block_tables, ctx_len, chunk_len,
            attn_backend=attn_backend)

    def mixed_step(params, pool, dec_token, ck_tokens, bt_dec, bt_ck, pos,
                   ctx_len, chunk_len, *, attn_backend="fused",
                   attn_num_work=None):
        return transformer.forward_mixed(
            params, cfg, dec_token, ck_tokens, pool, bt_dec, bt_ck, pos,
            ctx_len, chunk_len, attn_backend=attn_backend,
            attn_num_work=attn_num_work)

    def prefill(params, tokens, cache_len: Optional[int] = None):
        logits, cache = transformer.forward_full(params, cfg, tokens,
                                                 return_cache=True,
                                                 last_only=True)
        return logits[:, -1], _relay_kv(cache, cache_len or tokens.shape[1])

    def decode_step(params, cache, token, pos, rows=None):
        return transformer.forward_decode(params, cfg, token, cache, pos,
                                          rows=rows)

    def init_cache(batch: int, seq: int, device="cuda", dtype=None):
        return transformer.init_cache(cfg, batch, seq, dtype=dtype,
                                      device=device)

    def prefill_bucketed(params, tokens, true_len):
        logits, cache = transformer.forward_full(
            params, cfg, tokens, return_cache=True, last_index=true_len - 1)
        return logits[:, 0], cache

    return Model(cfg, init, init_paged_cache, decode_step_paged,
                 prefill_chunk, mixed_step, prefill, decode_step, init_cache,
                 prefill_bucketed)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "dense" and not cfg.sliding_window \
            and not cfg.use_mrope:
        return _decoder_model(cfg)
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} (sliding_window="
        f"{cfg.sliding_window}) is not ported to repro_torch yet")
