"""Mamba2 (SSD) blocks and the Zamba2 hybrid stack — the port of
``repro.models.mamba2``. [arXiv:2411.15242]

Per head h the state ``S`` [P, N] follows

    S_t = exp(dt_t A_h) S_{t-1} + dt_t (x_t ⊗ B_t),   y_t = S_t C_t + D_h x_t

with a scalar ``A`` per head, a short causal depthwise conv on (x, B, C)
and a gated RMSNorm on the way out. Zamba2 is a backbone of Mamba2 blocks
with ONE shared attention + SwiGLU block applied after every
``attn_every`` of them: the weights are shared, each site keeps its own
KV. The reference's simplification is kept: the shared block reads the
hidden state, not concat(hidden, embedding) through a per-site projector.

Layout: the Mamba2 leaves are stacked ``[groups, attn_every, ...]``
(``groups = num_layers // attn_every``, one shared-block site per group);
the decode state is ``{"conv": [G, A, B, K-1, Cd], "ssm": [G, A, B, H, P,
N] f32, "kv": KVCache([G, B, S, Hkv, Dh])}``, updated IN PLACE by
:func:`forward_decode`.

The SSD has two forms. :func:`ssd_sequential` steps token by token (the
reference's ``_ssd_scan``). :func:`ssd_chunked` runs chunks of
``SSD_CHUNK`` tokens in matmuls, any T (the last chunk is shorter, never
padded: a padded step would still decay the state by ``softplus(dt_bias)``),
and is what a sequence on the card runs (:func:`_ssd` picks by device, as
``rwkv6.time_mix_seq`` does). The shared block's head dim (80) has no
attention kernel instance: ``models.attention`` routes it to its plain
paths before any launch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (ModelConfig, card_device,
                                       dense_init, embed_init, rms_norm)
from repro_torch.models.mlp import ffn, init_ffn
from repro_torch.models.transformer import checkpointed

CONV_K = 4
EXPAND = 2
# Tokens per chunk of the chunked SSD on the card: a chunk's intra part is
# a [B, C, C, H] decay tensor and a [B, H, C, C] x [B, H, C, P] product,
# and the state passes T / C times per layer (32 at T 4096).
SSD_CHUNK = 128


def dims(cfg: ModelConfig):
    d_inner = EXPAND * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


# --------------------------------------------------------------------------
# Mamba2 block params
# --------------------------------------------------------------------------
def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, lead=()):
    """One block's weights, or with ``lead`` (e.g. ``(groups,
    attn_every)``) those of that many blocks stacked, drawn in that
    layout. ``A_log``, ``dt_bias`` and ``D_skip`` are f32, as in the
    reference."""
    D, dt, dev = cfg.d_model, cfg.dtype, gen.device
    d_inner, H, P, N = dims(cfg)
    conv_dim = d_inner + 2 * N            # x, B, C share the conv
    lead = tuple(lead)

    def full(shape, value, dtype=dt):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)
    return {
        "ln": full((D,), 1.0),
        "w_in": dense_init(gen, lead + (D, 2 * d_inner + 2 * N + H), dt,
                           fan_in=D),
        "conv_w": dense_init(gen, lead + (CONV_K, conv_dim), dt,
                             fan_in=CONV_K),
        "conv_b": full((conv_dim,), 0.0),
        "A_log": full((H,), 0.0, torch.float32),
        "dt_bias": full((H,), 0.0, torch.float32),
        "D_skip": full((H,), 1.0, torch.float32),
        "ln_gate": full((d_inner,), 1.0),
        "w_out": dense_init(gen, lead + (d_inner, D), dt, fan_in=d_inner),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """The input projection's columns -> (z, x, B, C, dt)."""
    d_inner, H, P, N = dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)


def _conv_seq(pl, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time, f32, then SiLU. xbc [B, T, Cd]."""
    w = pl["conv_w"].float()                                   # [K, Cd]
    T = xbc.shape[1]
    pad = F.pad(xbc.float(), (0, 0, CONV_K - 1, 0))
    out = sum(pad[:, k:k + T] * w[k] for k in range(CONV_K))
    return F.silu(out + pl["conv_b"].float()).to(xbc.dtype)


# --------------------------------------------------------------------------
# The SSD recurrence over a sequence
# --------------------------------------------------------------------------
def ssd_inputs(pl, cfg: ModelConfig, x: torch.Tensor, dt: torch.Tensor):
    """x [B, T, d_inner] -> heads xh [B, T, H, P] in f32; dt [B, T, H] ->
    ``dtf = softplus(dt + dt_bias)`` and the log decay ``la = dtf * A``
    (``A = -exp(A_log)``), f32."""
    d_inner, H, P, N = dims(cfg)
    Bb, T, _ = x.shape
    xh = x.reshape(Bb, T, H, P).float()
    dtf = F.softplus(dt.float() + pl["dt_bias"])
    return xh, dtf, dtf * -torch.exp(pl["A_log"])


def ssd_sequential(xh, Bm, Cm, dtf, la, S0):
    """The recurrence token by token (the reference's ``_ssd_scan``): xh
    [B, T, H, P], Bm / Cm [B, T, N], dtf / la [B, T, H], S0 [B, H, P, N],
    all of one float dtype (f32, or f64 to hold the others to). Returns
    (y [B, T, H, P] without the D skip, S after the last token)."""
    decay = torch.exp(la)
    S = S0
    ys = []
    for t in range(xh.shape[1]):
        S = (decay[:, t, :, None, None] * S
             + dtf[:, t, :, None, None] * xh[:, t, :, :, None]
             * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", S, Cm[:, t]))
    return torch.stack(ys, 1), S


def ssd_chunked(xh, Bm, Cm, dtf, la, S0, chunk: int = SSD_CHUNK):
    """The same recurrence ``chunk`` tokens at a time (Mamba2's chunked
    SSD), the same operands and result as :func:`ssd_sequential`. Within
    a chunk, with ``c_t`` the sum of ``la`` over its tokens up to t:

        y_t = sum_{s<=t} exp(c_t - c_s) (C_t . B_s) dt_s x_s
              + exp(c_t) C_t . S_start
        S_end = exp(c_last) S_start + sum_s exp(c_last - c_s) dt_s x_s B_s^T

    The exponent ``c_t - c_s`` is set to -inf above the diagonal before
    ``exp``, so no entry is inf and backward stays finite. The product
    over (s, head, P) runs as a per-head matmul of the [t, s] weights by
    [s, P]: no [t, s, H, P] tensor is built. Any T: the last chunk is
    shorter, and nothing is padded."""
    Bb, T, H, P = xh.shape
    xdt = xh * dtf[..., None]
    below = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=xh.device).tril()
    S = S0
    ys = []
    for c0 in range(0, T, chunk):
        c1 = min(c0 + chunk, T)
        n = c1 - c0
        xc, Bc, Cc = xdt[:, c0:c1], Bm[:, c0:c1], Cm[:, c0:c1]
        cl = torch.cumsum(la[:, c0:c1], dim=1)                 # [B, n, H]
        diff = cl[:, :, None] - cl[:, None]                    # [B, t, s, H]
        diff = diff.masked_fill(~below[:n, :n, None], float("-inf"))
        CB = torch.einsum("btn,bsn->bts", Cc, Bc)
        w = (CB[..., None] * torch.exp(diff)).permute(0, 3, 1, 2)
        y = w @ xc.permute(0, 2, 1, 3)                         # [B, H, t, P]
        y = y.permute(0, 2, 1, 3) + torch.exp(cl)[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cc, S)
        last = cl[:, -1]                                       # [B, H]
        S_add = torch.einsum("bshp,bsn->bhpn",
                             torch.exp(last[:, None] - cl)[..., None] * xc,
                             Bc)
        S = torch.exp(last)[..., None, None] * S + S_add
        ys.append(y)
    return torch.cat(ys, 1), S


def default_chunk(cfg: ModelConfig, T: int, device) -> int:
    """The SSD form a sequence of T tokens on ``device`` runs: on the card
    (``common.card_device``) chunks of ``cfg.ssm_chunk`` or ``SSD_CHUNK``; elsewhere the
    reference's choice, chunks of ``cfg.ssm_chunk`` when it divides T,
    else 0 (token by token)."""
    c = cfg.ssm_chunk
    if card_device(device):
        return c or SSD_CHUNK
    return c if c and T % c == 0 and T >= c else 0


def _ssd(pl, cfg: ModelConfig, x, Bm, Cm, dt, S0=None,
         chunk: Optional[int] = None):
    """The SSD of a block: x [B, T, d_inner], Bm / Cm [B, T, N], dt
    [B, T, H] -> (y [B, T, d_inner] f32 with the D skip, final S).
    ``chunk``: None = on the card :func:`ssd_chunked` (``cfg.ssm_chunk``
    or ``SSD_CHUNK``), elsewhere the reference's choice (chunked only
    when ``cfg.ssm_chunk`` divides T, else token by token); 0 = token by
    token; n = chunks of n."""
    d_inner, H, P, N = dims(cfg)
    Bb, T, _ = x.shape
    if chunk is None:
        chunk = default_chunk(cfg, T, x.device)
    xh, dtf, la = ssd_inputs(pl, cfg, x, dt)
    if S0 is None:
        S0 = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    fn = ssd_chunked if chunk else ssd_sequential
    args = (chunk,) if chunk else ()
    y, S = fn(xh, Bm.float(), Cm.float(), dtf, la, S0, *args)
    y = y + pl["D_skip"][None, None, :, None] * xh
    return y.reshape(Bb, T, d_inner), S


def _ssd_scan(pl, cfg: ModelConfig, x, Bm, Cm, dt, S0=None):
    """The reference's sequential SSD: (y [B, T, d_inner], S)."""
    return _ssd(pl, cfg, x, Bm, Cm, dt, S0, chunk=0)


def _ssd_chunked(pl, cfg: ModelConfig, x, Bm, Cm, dt, S0=None,
                 chunk: int = SSD_CHUNK):
    """The chunked SSD with the reference's signature, for any T."""
    return _ssd(pl, cfg, x, Bm, Cm, dt, S0, chunk=chunk)


# --------------------------------------------------------------------------
# A block over a sequence, and one decode token
# --------------------------------------------------------------------------
def mamba_seq(pl, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False, chunk: Optional[int] = None):
    """Full-sequence Mamba2 block: x [B, T, D] -> x + block(x); with
    ``return_state`` also the conv state [B, K-1, Cd] (the last K-1 raw
    conv inputs, zero rows before the start) and the SSD state."""
    h = rms_norm(x, pl["ln"], cfg.norm_eps)
    z, xs, Bm, Cm, dt = _split_proj(cfg, h @ pl["w_in"])
    xbc_raw = torch.cat([xs, Bm, Cm], dim=-1)
    xbc = _conv_seq(pl, xbc_raw)
    d_inner, _, _, N = dims(cfg)
    xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    y, S = _ssd(pl, cfg, xs, Bm, Cm, dt, chunk=chunk)
    y = _gated_out(pl, cfg, y, z)
    if return_state:
        conv_state = F.pad(xbc_raw, (0, 0, CONV_K - 1, 0))[:, -(CONV_K - 1):]
        return x + y, conv_state, S
    return x + y


def _gated_out(pl, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor):
    y = rms_norm(y.to(cfg.dtype) * F.silu(z), pl["ln_gate"], cfg.norm_eps)
    return y @ pl["w_out"]


def mamba_step(pl, cfg: ModelConfig, x: torch.Tensor,
               conv_state: torch.Tensor, S: torch.Tensor):
    """One decode token: x [B, D]; conv_state [B, K-1, Cd]; S [B, H, P, N].
    Returns (x + block(x), the new conv state, the new S)."""
    d_inner, H, P, N = dims(cfg)
    h = rms_norm(x, pl["ln"], cfg.norm_eps)
    z, xs, Bm, Cm, dt = _split_proj(cfg, h @ pl["w_in"])
    xbc = torch.cat([xs, Bm, Cm], dim=-1)                      # [B, Cd]
    window = torch.cat([conv_state, xbc[:, None]], dim=1)      # [B, K, Cd]
    conv = torch.einsum("bkc,kc->bc", window.float(), pl["conv_w"].float())
    conv = F.silu(conv + pl["conv_b"].float())
    xs, Bm, Cm = torch.split(conv.to(x.dtype), [d_inner, N, N], dim=-1)
    y, S = _ssd_scan(pl, cfg, xs[:, None], Bm[:, None], Cm[:, None],
                     dt[:, None], S0=S)
    y = _gated_out(pl, cfg, y[:, 0], z)
    return x + y, window[:, 1:], S


# --------------------------------------------------------------------------
# Zamba2 hybrid stack
# --------------------------------------------------------------------------
def _groups(cfg: ModelConfig) -> int:
    assert cfg.attn_every and cfg.num_layers % cfg.attn_every == 0
    return cfg.num_layers // cfg.attn_every


def init_zamba(gen: torch.Generator, cfg: ModelConfig):
    """Random weights on ``gen``'s device: ``embed``, the Mamba2 blocks
    stacked ``[groups, attn_every, ...]``, the ``shared`` attention +
    FFN block (one layer's weights), ``ln_f`` and ``unembed``."""
    dev, dt, D = gen.device, cfg.dtype, cfg.d_model
    return {
        "embed": embed_init(gen, (cfg.vocab_size, D), dt),
        "mamba": init_mamba_block(gen, cfg, (_groups(cfg), cfg.attn_every)),
        "shared": {
            "ln_attn": torch.ones((D,), dtype=dt, device=dev),
            "ln_mlp": torch.ones((D,), dtype=dt, device=dev),
            "attn": attn.init_attention(gen, cfg),
            "ffn": init_ffn(gen, cfg, None),
        },
        "ln_f": torch.ones((D,), dtype=dt, device=dev),
        "unembed": dense_init(gen, (D, cfg.vocab_size), dt),
    }


def block_params(mamba, g: int, a: int):
    """Block ``a`` of group ``g`` of the stacked Mamba2 leaves (views)."""
    return {k: v[g, a] for k, v in mamba.items()}


def _shared_full(ps, cfg: ModelConfig, x, positions):
    h = rms_norm(x, ps["ln_attn"], cfg.norm_eps)
    a, (k, v) = attn.attention_prefill(ps["attn"], cfg, h, positions)
    x = x + a
    x = x + ffn(ps["ffn"], cfg, rms_norm(x, ps["ln_mlp"], cfg.norm_eps))
    return x, KVCache(k, v)


def _shared_decode(ps, cfg: ModelConfig, x, cache_site: KVCache, pos,
                   seq_group=None):
    """The shared block on one token x [B, 1, D] against one site's KV
    [B, S, Hkv, Dh] (written in place; with ``seq_group`` this rank's
    rows of a sequence split over that group)."""
    h = rms_norm(x, ps["ln_attn"], cfg.norm_eps)
    a, cache_site = attn.attention_decode(ps["attn"], cfg, h, cache_site,
                                          pos, seq_group=seq_group)
    x = x + a
    x = x + ffn(ps["ffn"], cfg, rms_norm(x, ps["ln_mlp"], cfg.norm_eps))
    return x, cache_site


def forward_full(p, cfg: ModelConfig, tokens: torch.Tensor,
                 remat: bool = False, return_cache: bool = False):
    """The train pass over tokens [B, T]. Returns (logits [B, T, V], the
    sites' prompt KV ``KVCache([G, B, T, Hkv, Dh])`` or None, aux 0).
    ``remat`` recomputes each group (its Mamba2 blocks and its shared
    site) in backward."""
    x = F.embedding(tokens.long(), p["embed"])
    B, T = tokens.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)

    def group(x, g):
        for a in range(cfg.attn_every):
            x = mamba_seq(block_params(p["mamba"], g, a), cfg, x)
        return _shared_full(p["shared"], cfg, x, positions)
    kvs = []
    for g in range(_groups(cfg)):
        x, kv = checkpointed(group, remat, x, g)
        if return_cache:
            kvs.append(kv)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    cache = (KVCache(torch.stack([kv.k for kv in kvs]),
                     torch.stack([kv.v for kv in kvs]))
             if return_cache else None)
    return (x @ p["unembed"], cache,
            torch.zeros((), dtype=torch.float32, device=x.device))


# --------------------------------------------------------------------------
# Serving: prefill into the decode state, one token at a time after it
# --------------------------------------------------------------------------
def init_state(cfg: ModelConfig, batch: int, seq: int, device="cuda",
               dtype=None) -> Dict:
    """Zeroed decode state: the conv state ``[G, A, batch, K-1, Cd]`` and
    each site's KV ``[G, batch, S, Hkv, Dh]`` in ``dtype`` (default the
    model's; ``S = seq``, or ``min(seq, window)`` under a sliding
    window), the SSD state ``[G, A, batch, H, P, N]`` in f32."""
    d_inner, H, P, N = dims(cfg)
    G, A = _groups(cfg), cfg.attn_every
    dt = dtype or cfg.dtype
    S = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    kv = (G, batch, S, cfg.num_kv_heads, cfg.head_dim)
    return {
        "conv": torch.zeros((G, A, batch, CONV_K - 1, d_inner + 2 * N),
                            dtype=dt, device=device),
        "ssm": torch.zeros((G, A, batch, H, P, N), dtype=torch.float32,
                           device=device),
        "kv": KVCache(torch.zeros(kv, dtype=dt, device=device),
                      torch.zeros(kv, dtype=dt, device=device)),
    }


def prefill(p, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: Optional[int] = None):
    """Run the prompt tokens [B, T]. Returns (last-token logits [B, V],
    the decode state): each block's conv and SSD states, and each site's
    prompt KV relayed into its own buffer of ``cache_len`` rows (default
    T) in the ring layout decode uses (position p at row ``p % W``; the
    last ``min(T, W)`` positions are kept)."""
    B, T = tokens.shape
    S = cache_len or T
    x = F.embedding(tokens.long(), p["embed"])
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    state = init_state(cfg, B, S, device=x.device, dtype=x.dtype)
    W = state["kv"].k.shape[2]
    take = min(T, W)
    rows = torch.arange(T - take, T, device=x.device) % W
    for g in range(_groups(cfg)):
        for a in range(cfg.attn_every):
            x, conv, Ss = mamba_seq(block_params(p["mamba"], g, a), cfg, x,
                                    return_state=True)
            state["conv"][g, a].copy_(conv)
            state["ssm"][g, a].copy_(Ss)
        x, kv = _shared_full(p["shared"], cfg, x, positions)
        state["kv"].k[g][:, rows] = kv.k[:, T - take:]
        state["kv"].v[g][:, rows] = kv.v[:, T - take:]
    x = rms_norm(x[:, -1], p["ln_f"], cfg.norm_eps)
    return x @ p["unembed"], state


def forward_decode(p, cfg: ModelConfig, token: torch.Tensor, state,
                   pos: torch.Tensor, seq_group=None):
    """token [B] int; pos [B] int32 tokens already in the sites' KV (with
    ``seq_group``, this rank's rows of KV whose sequence is split over
    that group: context parallelism). Returns (logits [B, V], state), the
    state updated IN PLACE."""
    x = F.embedding(token.long(), p["embed"])
    kv = state["kv"]
    for g in range(_groups(cfg)):
        for a in range(cfg.attn_every):
            x, conv, S = mamba_step(block_params(p["mamba"], g, a), cfg, x,
                                    state["conv"][g, a], state["ssm"][g, a])
            state["conv"][g, a].copy_(conv)
            state["ssm"][g, a].copy_(S)
        x2, _ = _shared_decode(p["shared"], cfg, x[:, None],
                               KVCache(kv.k[g], kv.v[g]), pos, seq_group)
        x = x2[:, 0]
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return x @ p["unembed"], state
