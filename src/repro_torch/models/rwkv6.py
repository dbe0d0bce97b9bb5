"""RWKV-6 "Finch" — the port of ``repro.models.rwkv6``: an attention-free
RNN with data-dependent decay. [arXiv:2404.05892]

Per layer: token-shift mixing (static lerp weights, the reference's
simplification), per-channel decay ``w_t = exp(-exp(w0 + tanh(x A) B))``,
a per-head matrix state ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` read as
``y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)``, a per-head group norm and
the squared-ReLU channel mix. A request's decode state is O(1) in its
length: ``S`` [L, B, H, K, K] in f32 and the two token-shift rows
``att_prev`` / ``ffn_prev`` [L, B, D] in the model's dtype.

Dtypes follow the reference cast for cast: projections and lerps in the
model's dtype, the decay, the recurrence and the group norm in f32, and
the output projection in f32, cast back to the input's dtype.

The WKV recurrence has two forms. :func:`wkv_sequential` steps token by
token (the reference's ``lax.scan``). :func:`wkv_chunked` runs chunks of
``WKV_CHUNK`` tokens in matmuls, and is what a prompt on the card runs
(:func:`time_mix_seq` picks by device): a 5897-token prompt stepped one
token at a time would make 5897 x 32 rounds of small launches.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, card_device,
                                       dense_init, embed_init, rms_norm)
from repro_torch.models.transformer import checkpointed, layer_params

LORA_R = 32
# Tokens per chunk of the chunked WKV. Its intra-chunk part holds every
# pair (i, j < i) of a chunk with its own decay per key channel, a
# [C, C, K] tensor per head: work and memory grow with T * C * K while the
# scan over chunks takes T / C steps. At C = 64 a 5897-token prompt makes
# 93 scan steps per layer, and the pairwise tensor of one chunk is
# 64 * 64 * 64 f32 = 1 MB per head.
WKV_CHUNK = 64
# the pairwise tensors are built a group of chunks at a time, at most
# this many f32 elements each (256 MB)
WKV_PAIR_ELEMS = 1 << 26


def _heads(cfg: ModelConfig):
    K = cfg.ssm_head_dim or 64
    return cfg.d_model // K, K


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig,
               layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One layer's weights, or with ``layers`` the weights of that many
    layers stacked on a leading axis, drawn straight into that layout
    (each leaf filled slice by slice in its own dtype,
    ``common._fill_normal``). The reference's leaves, shapes and scales:
    ``dense_init`` on ``fan_in`` = the input width."""
    D, F_, dt, dev = cfg.d_model, cfg.d_ff, cfg.dtype, gen.device
    H, K = _heads(cfg)
    lead = () if layers is None else (layers,)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    def dense(shape, scale=1.0):
        return dense_init(gen, lead + shape, dt, scale=scale,
                          fan_in=shape[0])
    return {
        "ln_att": full((D,), 1.0),
        "ln_ffn": full((D,), 1.0),
        "mu_r": full((D,), 0.5),
        "mu_k": full((D,), 0.5),
        "mu_v": full((D,), 0.5),
        "mu_w": full((D,), 0.5),
        "mu_g": full((D,), 0.5),
        "w_r": dense((D, D)),
        "w_k": dense((D, D)),
        "w_v": dense((D, D)),
        "w_g": dense((D, D)),
        "w_o": dense((D, D)),
        "decay_w0": full((D,), -6.0),
        "decay_A": dense((D, LORA_R)),
        "decay_B": dense((LORA_R, D), scale=0.1),
        "bonus_u": full((H, K), 0.0),
        "ln_x": full((D,), 1.0),
        "mu_ck": full((D,), 0.5),
        "mu_cr": full((D,), 0.5),
        "cw_k": dense((D, F_)),
        "cw_v": dense((F_, D)),
        "cw_r": dense((D, D)),
    }


def init_model(gen: torch.Generator, cfg: ModelConfig):
    """Random weights on ``gen``'s device: embeddings, the layers stacked
    on ``num_layers``, the final norm and the unembedding."""
    return {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype),
        "layers": init_layer(gen, cfg, cfg.num_layers),
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                           device=gen.device),
        "unembed": dense_init(gen, (cfg.d_model, cfg.vocab_size), cfg.dtype),
    }


# --------------------------------------------------------------------------
# Pieces of a layer
# --------------------------------------------------------------------------
def _log_decay(pl, xw: torch.Tensor) -> torch.Tensor:
    """``log w = -exp(w0 + tanh(xw A) B)``, f32 (the reference's
    ``_decay`` before its outer ``exp``)."""
    z = pl["decay_w0"].float() + torch.tanh(
        xw.float() @ pl["decay_A"].float()) @ pl["decay_B"].float()
    return -torch.exp(z)


def _decay(pl, xw: torch.Tensor) -> torch.Tensor:
    """The decay ``w = exp(-exp(w0 + tanh(xw A) B))`` in f32."""
    return torch.exp(_log_decay(pl, xw))


def _group_norm(x: torch.Tensor, weight: torch.Tensor, H: int, K: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm on [..., H, K] flattened to [..., D], f32."""
    shp = x.shape
    x = x.reshape(shp[:-1] + (H, K)).float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return x.reshape(shp) * weight.float()


def _shift(x: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> the previous token's row (zeros at t = 0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def time_mix_step(pl, cfg: ModelConfig, x: torch.Tensor,
                  x_prev: torch.Tensor, S: torch.Tensor):
    """One token: x, x_prev [B, D]; S [B, H, K, K] f32. Returns (out [B, D]
    in x's dtype, S')."""
    H, K = _heads(cfg)
    B, D = x.shape

    def lerp(mu):
        return x + (x_prev - x) * mu
    r = (lerp(pl["mu_r"]) @ pl["w_r"]).reshape(B, H, K)
    k = (lerp(pl["mu_k"]) @ pl["w_k"]).reshape(B, H, K)
    v = (lerp(pl["mu_v"]) @ pl["w_v"]).reshape(B, H, K)
    g = F.silu(lerp(pl["mu_g"]) @ pl["w_g"])
    w = _decay(pl, lerp(pl["mu_w"])).reshape(B, H, K)
    rf, kf, vf = r.float(), k.float(), v.float()
    u = pl["bonus_u"].float()
    kv = kf[..., :, None] * vf[..., None, :]                  # [B, H, K, K]
    y = torch.einsum("bhk,bhkv->bhv", rf, S + u[None, :, :, None] * kv)
    S = w[..., None] * S + kv
    y = _group_norm(y.reshape(B, D), pl["ln_x"], H, K)
    return ((y * g.float()) @ pl["w_o"].float()).to(x.dtype), S


# --------------------------------------------------------------------------
# The WKV recurrence over a sequence
# --------------------------------------------------------------------------
def wkv_sequential(r, k, v, w, u, S0):
    """The recurrence token by token (the reference's scan): r, k, v, w
    [B, T, H, K] f32 (``w`` the decay), u [H, K], S0 [B, H, K, K]. Returns
    (y [B, T, H, K], S after the last token), f32."""
    S = S0
    ys = []
    uu = u[None, :, :, None]
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + uu * kv))
        S = w[:, t, ..., None] * S + kv
    return torch.stack(ys, 1), S


def wkv_chunked(r, k, v, lw, u, S0, chunk: int = WKV_CHUNK):
    """The same recurrence a chunk of ``chunk`` tokens at a time: r, k, v
    [B, T, H, K] f32, ``lw`` = log of the decay (<= 0), u [H, K], S0
    [B, H, K, K]. Returns (y [B, T, H, K], final S), f32.

    Within a chunk, with ``c_i`` the sum of ``lw`` over the chunk's tokens
    up to i and ``e_i = c_{i-1}`` (0 at the chunk start), every decay is
    ``exp`` of a difference of such sums, so every factor is ``exp(sum of
    log w) <= 1`` and nothing is divided by a cumulative product that
    could underflow:

        y_i = (r_i * exp(e_i)) S_start
              + sum_{j<i} [sum_k r_ik k_jk exp(e_ik - c_jk)] v_j
              + (sum_k r_ik u_k k_ik) v_i
        S_end = exp(c_last) * S_start + sum_j (k_j * exp(c_last - c_j)) v_j^T

    The chunks' own terms run for all chunks at once (batched matmuls; the
    pairwise ``exp(e_i - c_j)`` tensor a group of chunks at a time), then a
    scan over chunks carries S. A tail short of a chunk is padded with
    k = v = r = 0 and lw = 0, which leaves y and S unchanged."""
    B, T, H, K = r.shape
    C = chunk
    N = -(-T // C)
    pad = N * C - T

    def chunks(a):
        a = F.pad(a, (0, 0, 0, 0, 0, pad))
        return a.reshape(B, N, C, H, K).permute(0, 3, 1, 2, 4)  # [B,H,N,C,K]
    r, k, v, lw = (chunks(a) for a in (r, k, v, lw))
    c = lw.cumsum(3)                                  # inclusive sums
    e = F.pad(c[:, :, :, :-1], (0, 0, 1, 0))          # exclusive sums
    last = c[:, :, :, -1:]                            # [B, H, N, 1, K]
    # the bonus on the current token
    y = (r * u[None, :, None, None] * k).sum(-1, keepdim=True) * v
    # earlier tokens of the chunk, a group of chunks at a time
    below = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    step = max(1, WKV_PAIR_ELEMS // (B * H * C * C * K))
    for n0 in range(0, N, step):
        sl = slice(n0, n0 + step)
        diff = e[:, :, sl, :, None] - c[:, :, sl, None]    # [.., C, C, K]
        diff = diff.masked_fill(~below[..., None], -math.inf)
        att = torch.einsum("bhnik,bhnijk->bhnij", r[:, :, sl],
                           k[:, :, sl, None] * torch.exp(diff))
        y[:, :, sl] += att @ v[:, :, sl]
    # each chunk's own contribution to the state it passes on
    delta = (k * torch.exp(last - c)).transpose(-1, -2) @ v   # [B,H,N,K,K]
    carry = torch.exp(last).transpose(-1, -2)                 # [B,H,N,K,1]
    starts = []
    S = S0
    for n in range(N):
        starts.append(S)
        S = carry[:, :, n] * S + delta[:, :, n]
    y = y + (r * torch.exp(e)) @ torch.stack(starts, 2)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, N * C, H, K)[:, :T]
    return y, S


def wkv_inputs(pl, cfg: ModelConfig, x: torch.Tensor, x_prev0=None):
    """The sequence's recurrence inputs: x [B, T, D] -> (r, k, v, log w)
    [B, T, H, K] in f32 and the gate g [B, T, D] in x's dtype, every
    token-shift lerp and projection over the whole sequence at once
    (``x_prev0`` [B, D]: the row before x[:, 0], zeros if None)."""
    H, K = _heads(cfg)
    B, T, D = x.shape
    xp = _shift(x)
    if x_prev0 is not None:                   # decode-state handoff
        xp[:, 0] = x_prev0

    def lerp(mu):
        return x + (xp - x) * mu
    r = (lerp(pl["mu_r"]) @ pl["w_r"]).reshape(B, T, H, K)
    k = (lerp(pl["mu_k"]) @ pl["w_k"]).reshape(B, T, H, K)
    v = (lerp(pl["mu_v"]) @ pl["w_v"]).reshape(B, T, H, K)
    g = F.silu(lerp(pl["mu_g"]) @ pl["w_g"])
    lw = _log_decay(pl, lerp(pl["mu_w"])).reshape(B, T, H, K)
    return r.float(), k.float(), v.float(), lw, g


def time_mix_seq(pl, cfg: ModelConfig, x: torch.Tensor, S0=None,
                 x_prev0=None, return_state: bool = False,
                 chunk: Optional[int] = None):
    """A whole sequence: x [B, T, D] -> [B, T, D] in x's dtype. The
    token-shift lerps and every projection run over the whole sequence;
    only the WKV recurrence is sequential, or chunked: ``chunk`` tokens at
    a time (0 = token by token; None = ``WKV_CHUNK`` on the card,
    ``common.card_device``, token by token elsewhere, the reference's
    form). ``S0`` [B, H, K, K] and
    ``x_prev0`` [B, D] continue from a decode state; ``return_state``
    adds (S, the last input row) for the decode that follows."""
    H, K = _heads(cfg)
    B, T, D = x.shape
    rf, kf, vf, lw, g = wkv_inputs(pl, cfg, x, x_prev0)
    u = pl["bonus_u"].float()
    if S0 is None:
        S0 = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device)
    if chunk is None:
        chunk = WKV_CHUNK if card_device(x.device) else 0
    if chunk:
        y, S = wkv_chunked(rf, kf, vf, lw, u, S0, chunk)
    else:
        y, S = wkv_sequential(rf, kf, vf, torch.exp(lw), u, S0)
    y = _group_norm(y.reshape(B, T, D), pl["ln_x"], H, K)
    out = ((y * g.float()) @ pl["w_o"].float()).to(x.dtype)
    if return_state:
        return out, S, x[:, -1]
    return out


def channel_mix(pl, cfg: ModelConfig, x: torch.Tensor,
                x_prev: torch.Tensor) -> torch.Tensor:
    """x, x_prev [..., D] (x_prev the token-shifted input)."""
    xk = x + (x_prev - x) * pl["mu_ck"]
    xr = x + (x_prev - x) * pl["mu_cr"]
    k = torch.square(torch.relu(xk @ pl["cw_k"]))
    return torch.sigmoid(xr @ pl["cw_r"]) * (k @ pl["cw_v"])


def layer_seq(pl, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, pl["ln_att"], cfg.norm_eps)
    x = x + time_mix_seq(pl, cfg, h)
    h = rms_norm(x, pl["ln_ffn"], cfg.norm_eps)
    return x + channel_mix(pl, cfg, h, _shift(h))


def forward_full(p, cfg: ModelConfig, tokens: torch.Tensor,
                 remat: bool = False) -> torch.Tensor:
    """Logits [B, T, V] of tokens [B, T]; ``remat`` recomputes each layer
    in backward."""
    x = F.embedding(tokens.long(), p["embed"])
    for l in range(cfg.num_layers):
        x = checkpointed(layer_seq, remat, layer_params(p["layers"], l),
                         cfg, x)
    return rms_norm(x, p["ln_f"], cfg.norm_eps) @ p["unembed"]


# --------------------------------------------------------------------------
# Serving: the O(1) recurrent state
# --------------------------------------------------------------------------
def init_state(cfg: ModelConfig, batch: int, device="cuda",
               dtype=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode state of ``batch`` rows: ``S`` [L, batch, H, K, K]
    f32, ``att_prev`` / ``ffn_prev`` [L, batch, D] in ``dtype`` (default
    the model's)."""
    H, K = _heads(cfg)
    L, D = cfg.num_layers, cfg.d_model
    dt = dtype or cfg.dtype
    return {
        "S": torch.zeros((L, batch, H, K, K), dtype=torch.float32,
                         device=device),
        "att_prev": torch.zeros((L, batch, D), dtype=dt, device=device),
        "ffn_prev": torch.zeros((L, batch, D), dtype=dt, device=device),
    }


def forward_decode(p, cfg: ModelConfig, token: torch.Tensor, state,
                   pos=None, rows: Optional[torch.Tensor] = None):
    """token [B] int -> (logits [B, V], state). ``state`` is updated IN
    PLACE: its rows 0..B-1, or with ``rows`` ([B] int, the state row of
    each token) those rows of a state of any number of rows, so a serving
    slab's live rows decode where they lie. ``pos`` is ignored: the state
    carries the position."""
    x = F.embedding(token.long(), p["embed"])
    idx = None if rows is None else rows.long()
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        S_l, ap_l, fp_l = (state[n][l] for n in ("S", "att_prev",
                                                  "ffn_prev"))
        if idx is None:
            S, a_prev, f_prev = S_l, ap_l, fp_l
        else:
            S, a_prev, f_prev = (a.index_select(0, idx)
                                 for a in (S_l, ap_l, fp_l))
        h = rms_norm(x, pl["ln_att"], cfg.norm_eps)
        y, S = time_mix_step(pl, cfg, h, a_prev, S)
        x = x + y
        h2 = rms_norm(x, pl["ln_ffn"], cfg.norm_eps)
        x = x + channel_mix(pl, cfg, h2, f_prev)
        for dst, src in ((S_l, S), (ap_l, h), (fp_l, h2)):
            if idx is None:
                dst.copy_(src)
            else:
                dst.index_copy_(0, idx, src.to(dst.dtype))
    x = rms_norm(x, p["ln_f"], cfg.norm_eps)
    return x @ p["unembed"], state


def prefill(p, cfg: ModelConfig, tokens: torch.Tensor, cache_len=None):
    """Run the prompt tokens [B, T]; returns (last-token logits [B, V], the
    decode state). ``cache_len`` is ignored, as in the reference: the
    state's size does not depend on the length."""
    x = F.embedding(tokens.long(), p["embed"])
    state = init_state(cfg, tokens.shape[0], device=x.device, dtype=x.dtype)
    for l in range(cfg.num_layers):
        pl = layer_params(p["layers"], l)
        h = rms_norm(x, pl["ln_att"], cfg.norm_eps)
        y, S, att_prev = time_mix_seq(pl, cfg, h, return_state=True)
        x = x + y
        h2 = rms_norm(x, pl["ln_ffn"], cfg.norm_eps)
        x = x + channel_mix(pl, cfg, h2, _shift(h2))
        state["S"][l].copy_(S)
        state["att_prev"][l].copy_(att_prev)
        state["ffn_prev"][l].copy_(h2[:, -1])
    x = rms_norm(x[:, -1], p["ln_f"], cfg.norm_eps)
    return x @ p["unembed"], state
