"""Shared model components: config, norms, activations, initializers.

The port's counterpart of ``repro.models.common``. Parameters keep the JAX
package's layout so a bridge between the two is a renaming: a nested dict
of tensors, ``x @ W`` with ``W [in, out]``, and every per-layer weight
stacked on a leading ``num_layers`` axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch
import torch.nn.functional as F

Params = Any  # nested dict of torch.Tensor


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config per architecture (src/repro_torch/configs/). Field for
    field the JAX ``ModelConfig``, minus its sharding hints; ``dtype`` is
    a ``torch.dtype``. ``tp_axis`` keeps the reference's name, but where
    the reference names a mesh axis it holds the tensor-parallel group
    itself (a ``launch.mesh.Collectives``: a serving ``TPMesh``, or a
    training mesh's model group) that a forward runs in, or None. A
    data-parallel loss takes its data group as an argument
    (``Model.loss(..., data_group=)``)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int          # 0 for attention-free (rwkv6)
    num_kv_heads: int
    d_ff: int               # dense FFN dim (per-expert dim for MoE)
    vocab_size: int
    head_dim: int = 0       # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    dense_residual: bool = False
    router_aux_coef: float = 0.01
    moe_impl: str = "dense"

    # --- positional / attention flavor ---
    rope_theta: float = 10_000.0
    use_mrope: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0
    learned_pos: bool = False
    max_position: int = 131_072

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 0
    attn_every: int = 0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0

    # --- numerics ---
    act: str = "swiglu"            # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.float32
    source: str = ""
    # serving tensor parallelism: with a group, every weight is this
    # rank's shard (q/kv heads, FFN dim, vocab split over the ranks) and
    # the forward adds the collectives: an all-reduce after each wo and
    # w_down contraction and after the vocab-split embedding lookup, an
    # all-gather of the logits. None: one device, no collective.
    tp_axis: Any = dataclasses.field(default=None, compare=False,
                                     repr=False)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def tp_size(self) -> int:
        """Ranks a tensor-parallel forward runs on (1 without a group)."""
        return 1 if self.tp_axis is None else self.tp_axis.size

    def reduced(self, **over) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=256, <=4 experts."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=64 if self.num_heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            attn_every=2 if self.attn_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            max_position=4096,
            name=self.name + "-reduced",
        )
        small.update(over)
        return dataclasses.replace(self, **small)


# --------------------------------------------------------------------------
# Initializers: normal draws from an explicit torch.Generator, made in f32
# on the generator's device and cast (the JAX package's scheme; the draws
# themselves differ from jax.random, so cross-framework tests bridge the
# JAX weights instead). A large leaf is drawn slice by slice along its
# leading axes into a buffer of its own dtype, so no f32 copy of the whole
# leaf exists at once (qwen3-moe's expert leaf [48, 128, 2048, 768] would
# need 38.7 GB of f32 beside its 19.3 GB of bf16).
# --------------------------------------------------------------------------
DRAW_ELEMS = 1 << 28       # f32 draws of at most 1 GiB at a time


def _fill_normal(out: torch.Tensor, gen: torch.Generator,
                 std: float) -> torch.Tensor:
    """``out`` <- ``normal * std`` drawn in f32 from ``gen``, in slices of
    at most ``DRAW_ELEMS`` elements along the leading axes. The slicing
    depends on the shape only, so a seed gives the same weights on every
    call; a leaf of at most ``DRAW_ELEMS`` is one draw."""
    if out.numel() > DRAW_ELEMS and out.dim() >= 2:
        row = out[0].numel()
        if row > DRAW_ELEMS:
            for r in out:
                _fill_normal(r, gen, std)
        else:
            step = DRAW_ELEMS // row
            for s in range(0, out.shape[0], step):
                _fill_normal(out[s:s + step], gen, std)
        return out
    x = torch.randn(tuple(out.shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return out.copy_(x.mul_(std))


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: float = 1.0, fan_in: int | None = None) -> torch.Tensor:
    """``normal * scale / sqrt(fan_in)``; ``fan_in`` defaults to
    ``shape[0]`` (pass it explicitly for layer-stacked ``[L, in, out]``)."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    return _fill_normal(out, gen, scale / math.sqrt(fan_in))


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype) -> torch.Tensor:
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    return _fill_normal(out, gen, 0.02)


# --------------------------------------------------------------------------
# Collectives under autograd (Megatron's f / g pair): a serving forward
# (no grad) runs the group's ops as they are; a training forward runs them
# through these Functions, whose backward is the collective's adjoint.
# --------------------------------------------------------------------------
class _Sum(torch.autograd.Function):
    """All-reduce: the sum in forward (into a copy: the group's op works
    in place), the gradient as it is in backward (every rank's partial
    contributed once to the sum every rank holds)."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """A replicated value entering a rank's partial computation: the
    identity in forward, the all-reduce of its gradient in backward (each
    rank's gradient covers only its shard's share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous().clone()), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``: every rank's piece in forward, this
    rank's slice of the gradient in backward (every rank computes the
    same whole gradient from the gathered value)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.rank, ctx.dim, ctx.n = group.rank, dim, x.shape[dim]
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a ``launch.mesh.Collectives``),
    differentiable (:class:`_Sum`); ``x`` itself without a group."""
    if group is None:
        return x
    if _tracked(x):
        return _Sum.apply(x, group)
    return group.all_reduce(x.contiguous().clone())


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` along ``dim``, differentiable
    (:class:`_Gather`); ``x`` itself without a group."""
    if group is None:
        return x
    if _tracked(x):
        return _Gather.apply(x, group, dim)
    return group.all_gather(x, dim)


def psum_if_tp(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """All-reduce a partial activation over the tensor-parallel group —
    ``x`` itself without one, so one-device forwards run as before. A
    serving forward reduces ``x`` in place; under autograd the sum is
    :class:`_Sum`."""
    if cfg.tp_axis is not None and not _tracked(x):
        return cfg.tp_axis.all_reduce(x.contiguous())
    return all_reduce(x, cfg.tp_axis)


def copy_to_tp(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x`` (replicated over the tensor-parallel group) where it enters a
    column-parallel product: under autograd :class:`_Copy`, so its
    gradient sums the ranks' partials; otherwise ``x`` itself."""
    if cfg.tp_axis is None or not _tracked(x):
        return x
    return _Copy.apply(x, cfg.tp_axis)


# --------------------------------------------------------------------------
# Normalization / activations
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: statistics in f32, the result cast
    back to x's dtype (the reference's ``layer_norm``)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "swiglu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask=None, group=None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32: ``logsumexp(logits)`` minus
    the gold logit, per position of ``logits [..., V]`` / ``labels``
    int [...]; with ``mask`` [...], the masked mean
    ``sum(nll * mask) / max(sum(mask), 1)`` (the reference's
    ``softmax_xent``). With a data-parallel ``group`` the rows are this
    rank's share: the rank's sum over the group's whole count (mask sum,
    or positions), so the ranks' values add up to the whole batch's
    mean."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if group is not None:
        w = torch.ones_like(nll) if mask is None else mask.float()
        count = group.all_reduce(w.sum().detach().reshape(1))[0]
        return torch.sum(nll * w) / torch.clamp(count, min=1.0)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
