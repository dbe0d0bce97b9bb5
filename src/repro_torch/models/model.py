"""Model record over the port's families — the counterpart of
``repro.models.model``, with the entry-point signatures of its paged
serving path:

    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    pool = model.init_paged_cache(num_blocks, block_size, device="cuda")
    logits, pool = model.decode_step_paged(params, pool, token, bt, pos)
    logits, pool = model.prefill_chunk(params, pool, tokens, bt, ctx, clen)
    dec_logits, ck_logits, pool = model.mixed_step(
        params, pool, dec_token, ck_tokens, bt_dec, bt_ck, pos, ctx, clen)

Only the dense full-attention decoder is ported so far; ``build_model``
raises for every other family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # init(rng, device="cuda") -> params; rng is a seed or a torch.Generator
    init: Callable[..., Any]
    # init_paged_cache(num_blocks, block_size, device="cuda")
    #     -> pool [L, NB, BS, Hkv, Dh]
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


def _decoder_model(cfg: ModelConfig) -> Model:
    def init(rng: Union[int, torch.Generator] = 0, device="cuda"):
        if isinstance(rng, torch.Generator):
            gen = rng
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(rng))
        return transformer.init_decoder(gen, cfg)

    def init_paged_cache(num_blocks: int, block_size: int, device="cuda",
                         dtype=None):
        return transformer.init_paged_cache(cfg, num_blocks, block_size,
                                            dtype=dtype, device=device)

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

    return Model(cfg, init, init_paged_cache, decode_step_paged,
                 prefill_chunk, mixed_step)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "dense" and not cfg.sliding_window \
            and not cfg.use_mrope:
        return _decoder_model(cfg)
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} (sliding_window="
        f"{cfg.sliding_window}) is not ported to repro_torch yet")
