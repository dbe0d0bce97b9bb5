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

**On a training mesh's model group** (the plan's ``mamba`` block,
``training.trainer.sharding_mechanism``) every Mamba2 leaf
``launch.shardings.param_spec`` splits stays split, and the SSD runs on
the rank's heads. ``w_in``'s cut of ``[z | x | B | C | dt]`` and
``conv_w`` / ``conv_b``'s cut of ``[x | B | C]`` fall on none of those
edges, so the rank projects its columns and one all-gather joins them
(as ``attention._project_qkv_whole`` joins q / k / v); it convolves the
channels its ``conv_w`` columns hold (the conv is depthwise) and a
second all-gather joins those. Its heads then take their ``z``, ``x``
and ``dt`` columns and the whole ``B`` / ``C``; ``A_log``, ``dt_bias``
and ``D_skip`` (replicated: ``MAMBA_SHARED``, whose rank gradient the
trainer sums over the group) are sliced to them. The gated RMSNorm
normalises over the whole ``d_inner``: each rank's per-token sum of
squares is all-reduced in f32 before its ``ln_gate`` columns, and
``w_out``'s rows give a partial product, all-reduced. Under autograd the
block's input and each joined value enter through ``copy_to_tp``. The
decode state keeps the reference's layout (``launch.shardings.
cache_shardings``, through ``common.state_piece``): as a rule ``conv``
on its channels (the same cut as ``conv_w``'s) and ``ssm`` on its
heads, the shared block's KV as the decoders' (``attention.
cache_dims``); where the rule lays a leaf out elsewhere (``conv`` on the
window's K - 1 rows of a group of 3, both on the batch rows where the
batch equals ``attn_every``) the blocks gather it at its use and write
their result back in its layout (``common.state_in`` / ``state_out``).
A block whose dims do not divide gathers its split leaves at their
use, runs whole and keeps the rank's slice of the state.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (ModelConfig, all_gather, all_reduce,
                                       block_in, block_out, card_device,
                                       copy_to_tp, dense_init, embed_init,
                                       leaf_at_use, rank_cols, rms_norm,
                                       seq_block, seq_layers, seq_slice,
                                       split_block, state_in, state_out,
                                       state_piece, unsplit)
from repro_torch.models.mlp import ffn, init_ffn
from repro_torch.models.transformer import (block_seq_split, checkpointed,
                                            embed_tokens, unembed)

CONV_K = 4
EXPAND = 2
# Tokens per chunk of the chunked SSD on the card: a chunk's intra part is
# a [B, C, C, H] decay tensor and a [B, H, C, C] x [B, H, C, P] product,
# and the state passes T / C times per layer (32 at T 4096).
SSD_CHUNK = 128


# the replicated leaves a split block uses on the rank's heads only: a
# rank's gradient of each is its heads' share (``training.trainer`` sums
# it over the model group)
MAMBA_SHARED = ("A_log", "dt_bias", "D_skip")


def dims(cfg: ModelConfig):
    d_inner = EXPAND * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def split_widths(cfg: ModelConfig):
    """Each Mamba2 leaf ``param_spec`` splits: (the dim it cuts, the
    leaf's width there)."""
    d_inner, H, P, N = dims(cfg)
    conv = d_inner + 2 * N
    return {"w_in": (-1, 2 * d_inner + 2 * N + H), "conv_w": (-1, conv),
            "conv_b": (-1, conv), "ln_gate": (-1, d_inner),
            "w_out": (-2, d_inner)}


def _at_use(pl, cfg: ModelConfig) -> dict:
    """A gathered block's leaves whole: each split one all-gathered at
    its use (``common.leaf_at_use``)."""
    widths = split_widths(cfg)
    return {k: leaf_at_use(v, cfg, *widths[k]) if k in widths else v
            for k, v in pl.items()}


def _split(cfg: ModelConfig) -> bool:
    """Whether the Mamba2 blocks run split on this rank (a group whose
    plan splits ``mamba``)."""
    return cfg.tp_axis is not None and split_block(cfg, "mamba")


def _in_proj(pl, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """``h @ w_in``, every column on every rank: under the split block
    the rank's columns, joined by one all-gather (``h`` enters through
    ``copy_to_tp``, the joined columns leave through it)."""
    if not _split(cfg):
        return h @ pl["w_in"]
    cols = block_in(h, cfg) @ pl["w_in"]
    return copy_to_tp(all_gather(cols, cfg.tp_axis, -1), cfg)


def _conv_channels(pl, cfg: ModelConfig) -> slice:
    """The conv channels whose weights this rank holds (all without the
    split block)."""
    if not _split(cfg):
        return slice(None)
    return rank_cols(cfg, pl["conv_w"].shape[-1])


def _join_channels(conv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The conv output of the rank's channels -> every channel on every
    rank (one all-gather, leaving through ``copy_to_tp``)."""
    if not _split(cfg):
        return conv
    return copy_to_tp(all_gather(conv, cfg.tp_axis, -1), cfg)


def _rank_heads(pl, cfg: ModelConfig, z, xs, dt):
    """This rank's heads under the split block: its pieces of ``z`` /
    ``xs`` (``P`` columns a head) and ``dt``, and of the replicated
    ``A_log`` / ``dt_bias`` / ``D_skip``; all of them otherwise."""
    if not _split(cfg):
        return pl, z, xs, dt
    n = pl["ln_gate"].shape[-1]
    cols, heads = rank_cols(cfg, n), rank_cols(cfg, n // cfg.ssm_head_dim)
    pl = dict(pl, **{k: pl[k][heads] for k in MAMBA_SHARED})
    return pl, z[..., cols], xs[..., cols], dt[..., heads]


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
    """x [B, T, H·P] -> heads xh [B, T, H, P] in f32; dt [B, T, H] ->
    ``dtf = softplus(dt + dt_bias)`` and the log decay ``la = dtf * A``
    (``A = -exp(A_log)``), f32. H is ``dt``'s: a rank's heads under the
    split block."""
    Bb, T, di = x.shape
    H = dt.shape[-1]
    xh = x.reshape(Bb, T, H, di // H).float()
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
    """The SSD of a block: x [B, T, H·P], Bm / Cm [B, T, N], dt
    [B, T, H] (every head, or a rank's) -> (y [B, T, H·P] f32 with the D
    skip, final S).
    ``chunk``: None = on the card :func:`ssd_chunked` (``cfg.ssm_chunk``
    or ``SSD_CHUNK``), elsewhere the reference's choice (chunked only
    when ``cfg.ssm_chunk`` divides T, else token by token); 0 = token by
    token; n = chunks of n."""
    Bb, T, di = x.shape
    H, N = dt.shape[-1], Bm.shape[-1]
    if chunk is None:
        chunk = default_chunk(cfg, T, x.device)
    xh, dtf, la = ssd_inputs(pl, cfg, x, dt)
    if S0 is None:
        S0 = torch.zeros((Bb, H, di // H, N), dtype=torch.float32,
                         device=x.device)
    fn = ssd_chunked if chunk else ssd_sequential
    args = (chunk,) if chunk else ()
    y, S = fn(xh, Bm.float(), Cm.float(), dtf, la, S0, *args)
    y = y + pl["D_skip"][None, None, :, None] * xh
    return y.reshape(Bb, T, di), S


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
    conv inputs, zero rows before the start) and the SSD state. Under the
    split block those two are the rank's channels and heads; under a
    gathered one the leaves are gathered at their use and the states are
    whole."""
    if cfg.tp_axis is not None and not split_block(cfg, "mamba"):
        return mamba_seq(_at_use(pl, cfg), unsplit(cfg), x, return_state,
                         chunk)
    y, conv_in, S = _mamba_mix(pl, cfg, rms_norm(x, pl["ln"], cfg.norm_eps),
                               chunk)
    if return_state:
        conv_state = F.pad(conv_in, (0, 0, CONV_K - 1, 0))[:, -(CONV_K - 1):]
        return x + y, conv_state, S
    return x + y


def _mamba_mix(pl, cfg: ModelConfig, h: torch.Tensor,
               chunk: Optional[int] = None):
    """The block's mixer on its normalised input h [B, T, D]: (its output,
    the raw conv input of the rank's channels, the SSD state). Under
    ``cfg.seq_parallel`` (a sequence-parallel layer, ``common.seq_block``)
    h is the gathered rows and the output this rank's T / m rows."""
    z, xs, Bm, Cm, dt = _split_proj(cfg, _in_proj(pl, cfg, h))
    xbc_raw = torch.cat([xs, Bm, Cm], dim=-1)
    ch = _conv_channels(pl, cfg)
    xbc = _join_channels(_conv_seq(pl, xbc_raw[..., ch]), cfg)
    d_inner, _, _, N = dims(cfg)
    xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    ph, z, xs, dt = _rank_heads(pl, cfg, z, xs, dt)
    y, S = _ssd(ph, cfg, xs, Bm, Cm, dt, chunk=chunk)
    return _gated_out(pl, cfg, y, z), xbc_raw[..., ch], S


def mamba_seq_split(pl, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """:func:`mamba_seq` on this rank's T / m rows of the residual stream
    (the ``seq_parallel`` lever): the rank's rows normalised, the mixer on
    the rows gathered along T (its input enters through one copy, so the
    conv sees its neighbours), its output reduce-scattered back to the
    rank's rows; a gathered block runs whole and keeps the rank's rows."""
    def mix(h, c):
        if c.tp_axis is not None and not split_block(c, "mamba"):
            return _mamba_mix(_at_use(pl, c), unsplit(c), h)[0]
        return _mamba_mix(pl, c, h)[0]
    return x + seq_block(mix, rms_norm(x, pl["ln"], cfg.norm_eps), cfg,
                         "mamba")


def _gated_out(pl, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor):
    """``rms_norm(y * silu(z), ln_gate) @ w_out``. Under the split block
    ``y`` and ``z`` are the rank's heads: the per-token sum of squares
    over its ``d_inner / n`` columns is all-reduced in f32 (and enters
    the rank's columns through ``copy_to_tp``), its ``ln_gate`` columns
    scale them and its ``w_out`` rows give a partial product,
    all-reduced."""
    if not _split(cfg):
        y = rms_norm(y.to(cfg.dtype) * F.silu(z), pl["ln_gate"],
                     cfg.norm_eps)
        return y @ pl["w_out"]
    v = (y.to(cfg.dtype) * F.silu(z)).float()
    ss = all_reduce(torch.sum(v * v, dim=-1, keepdim=True), cfg.tp_axis)
    ms = copy_to_tp(ss, cfg) / (EXPAND * cfg.d_model)
    y = (v * torch.rsqrt(ms + cfg.norm_eps)
         * pl["ln_gate"].float()).to(cfg.dtype)
    return block_out(y @ pl["w_out"], cfg)


def mamba_step(pl, cfg: ModelConfig, x: torch.Tensor,
               conv_state: torch.Tensor, S: torch.Tensor):
    """One decode token: x [B, D]; conv_state [B, K-1, Cd]; S [B, H, P, N]
    (under the split block the rank's channels and heads; a gathered
    block takes them whole and gathers its leaves at their use). Returns
    (x + block(x), the new conv state, the new S)."""
    if cfg.tp_axis is not None and not split_block(cfg, "mamba"):
        return mamba_step(_at_use(pl, cfg), unsplit(cfg), x, conv_state, S)
    d_inner, H, P, N = dims(cfg)
    h = rms_norm(x, pl["ln"], cfg.norm_eps)
    z, xs, Bm, Cm, dt = _split_proj(cfg, _in_proj(pl, cfg, h))
    xbc = torch.cat([xs, Bm, Cm], dim=-1)                      # [B, Cd]
    ch = _conv_channels(pl, cfg)
    window = torch.cat([conv_state, xbc[:, None, ch]], dim=1)  # [B, K, Cd]
    conv = torch.einsum("bkc,kc->bc", window.float(), pl["conv_w"].float())
    conv = F.silu(conv + pl["conv_b"].float())
    conv = _join_channels(conv.to(x.dtype), cfg)
    xs, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)
    ph, z, xs, dt = _rank_heads(pl, cfg, z, xs, dt)
    y, S = _ssd_scan(ph, cfg, xs[:, None], Bm[:, None], Cm[:, None],
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


def _shared_full(ps, cfg: ModelConfig, x, positions, split: bool = False):
    if split:           # x this rank's T / m rows: a decoder layer's form
        x, _, _ = block_seq_split(ps, cfg, x, positions)
        return x, None
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
                 remat: bool = False, return_cache: bool = False,
                 gather_logits: bool = True):
    """The train pass over tokens [B, T]. Returns (logits [B, T, V], the
    sites' prompt KV ``KVCache([G, B, T, Hkv, Dh])`` or None, aux 0).
    ``remat`` recomputes each group (its Mamba2 blocks and its shared
    site) in backward; ``gather_logits=False`` leaves a vocab-split
    unembedding's logits this rank's columns (``transformer.unembed``)."""
    x = embed_tokens(p, cfg, tokens)
    B, T = tokens.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)

    split = seq_layers(cfg) and not return_cache
    if split:           # the residual stream on this rank's T / m rows
        x = seq_slice(x, cfg.tp_axis)
    block = mamba_seq_split if split else mamba_seq

    def group(x, g):
        for a in range(cfg.attn_every):
            x = block(block_params(p["mamba"], g, a), cfg, x)
        return _shared_full(p["shared"], cfg, x, positions, split)
    kvs = []
    for g in range(_groups(cfg)):
        x, kv = checkpointed(group, remat, x, g)
        if return_cache:
            kvs.append(kv)
    if split:
        x = all_gather(x, cfg.tp_axis, 1)
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    cache = (KVCache(torch.stack([kv.k for kv in kvs]),
                     torch.stack([kv.v for kv in kvs]))
             if return_cache else None)
    return (unembed(p, cfg, x, gather_logits), cache,
            torch.zeros((), dtype=torch.float32, device=x.device))


# --------------------------------------------------------------------------
# Serving: prefill into the decode state, one token at a time after it
# --------------------------------------------------------------------------
def init_state(cfg: ModelConfig, batch: int, seq: int, device="cuda",
               dtype=None) -> Dict:
    """Zeroed decode state: the conv state ``[G, A, batch, K-1, Cd]`` and
    each site's KV ``[G, batch, S, Hkv, Dh]`` in ``dtype`` (default the
    model's; ``S = seq``, or ``min(seq, window)`` under a sliding
    window), the SSD state ``[G, A, batch, H, P, N]`` in f32; under a
    group this rank's slice of each (:func:`state_shapes`)."""
    dt = dtype or cfg.dtype
    conv, ssm, kv = state_shapes(cfg, batch, seq)
    return {
        "conv": torch.zeros(conv, dtype=dt, device=device),
        "ssm": torch.zeros(ssm, dtype=torch.float32, device=device),
        "kv": KVCache(torch.zeros(kv, dtype=dt, device=device),
                      torch.zeros(kv, dtype=dt, device=device)),
    }


def state_shapes(cfg: ModelConfig, batch: int, seq: int,
                 whole: bool = False):
    """The shapes of the decode state's ``conv``, ``ssm`` and each KV
    leaf: whole without a group (or with ``whole``), else this rank's
    slice in the layout ``launch.shardings.cache_shardings`` gives a
    decode state of ``seq`` rows (``common.state_piece``: ``conv`` on
    the conv window's K - 1 rows or else its channels, ``ssm`` on its
    heads, else P, else N, both on the batch rows where the batch equals
    ``attn_every``; the KV as ``attention.cache_dims``)."""
    d_inner, H, P, N = dims(cfg)
    G, A = _groups(cfg), cfg.attn_every
    S = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    conv, ssm = (G, A, batch, CONV_K - 1, d_inner + 2 * N), \
        (G, A, batch, H, P, N)
    kv = (G, batch, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.tp_axis is not None and not whole:
        conv, ssm = (state_piece(cfg, conv, S, 2),
                     state_piece(cfg, ssm, S, 2))
        kv = kv[:3] + attn.cache_dims(cfg)
    return conv, ssm, kv


def _compute_shapes(cfg: ModelConfig, batch: int):
    """The shapes of ``conv`` and ``ssm`` that a rank's Mamba2 blocks
    compute on: under the split block its channels (``conv_w``'s cut) and
    its heads, else whole."""
    conv, ssm, _ = state_shapes(cfg, batch, 1, whole=True)
    if not _split(cfg):
        return conv, ssm
    m = cfg.tp_axis.size
    return conv[:4] + (conv[4] // m,), ssm[:3] + (ssm[3] // m,) + ssm[4:]


def prefill(p, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: Optional[int] = None):
    """Run the prompt tokens [B, T]. Returns (last-token logits [B, V],
    the decode state): each block's conv and SSD states, and each site's
    prompt KV relayed into its own buffer of ``cache_len`` rows (default
    T) in the ring layout decode uses (position p at row ``p % W``; the
    last ``min(T, W)`` positions are kept). Under a group each leaf is
    this rank's slice (:func:`state_shapes`)."""
    B, T = tokens.shape
    S = cache_len or T
    x = embed_tokens(p, cfg, tokens)
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    state = init_state(cfg, B, S, device=x.device, dtype=x.dtype)
    wholes = dict(zip(("conv", "ssm"), state_shapes(cfg, B, S, whole=True)))
    W = state["kv"].k.shape[2]
    take = min(T, W)
    rows = torch.arange(T - take, T, device=x.device) % W
    for g in range(_groups(cfg)):
        for a in range(cfg.attn_every):
            x, conv, Ss = mamba_seq(block_params(p["mamba"], g, a), cfg, x,
                                    return_state=True)
            for name, src in (("conv", conv), ("ssm", Ss)):
                state_out(state[name][g, a], src, cfg, wholes[name][2:])
        x, kv = _shared_full(p["shared"], cfg, x, positions)
        state["kv"].k[g][:, rows] = kv.k[:, T - take:]
        state["kv"].v[g][:, rows] = kv.v[:, T - take:]
    x = rms_norm(x[:, -1], p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x), state


def forward_decode(p, cfg: ModelConfig, token: torch.Tensor, state,
                   pos: torch.Tensor, seq_group=None):
    """token [B] int; pos [B] int32 tokens already in the sites' KV (with
    ``seq_group``, this rank's rows of KV whose sequence is split over
    that group: context parallelism). Returns (logits [B, V], state), the
    state updated IN PLACE. Under a group the state is this rank's slice
    (:func:`state_shapes`); where its layout is not the one the blocks
    compute on (:func:`_compute_shapes`), the conv and SSD states are
    gathered at their use and written back in it (``common.state_in`` /
    ``state_out``)."""
    x = embed_tokens(p, cfg, token)
    kv = state["kv"]
    B = token.shape[0]
    wholes = dict(zip(("conv", "ssm"), state_shapes(cfg, B, 1, whole=True)))
    work = {n: state_in(state[n], cfg, wholes[n], want) for n, want in
            zip(("conv", "ssm"), _compute_shapes(cfg, B))}
    for g in range(_groups(cfg)):
        for a in range(cfg.attn_every):
            conv_l, ssm_l = work["conv"][g, a], work["ssm"][g, a]
            x, conv, S = mamba_step(block_params(p["mamba"], g, a), cfg, x,
                                    conv_l, ssm_l)
            conv_l.copy_(conv)
            ssm_l.copy_(S)
        x2, _ = _shared_decode(p["shared"], cfg, x[:, None],
                               KVCache(kv.k[g], kv.v[g]), pos, seq_group)
        x = x2[:, 0]
    for n in ("conv", "ssm"):
        state_out(state[n], work[n], cfg, wholes[n])
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return unembed(p, cfg, x), state
