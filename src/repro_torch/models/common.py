"""Shared model components: config, norms, activations, initializers.

The port's counterpart of ``repro.models.common``. Parameters keep the JAX
package's layout so a bridge between the two is a renaming: a nested dict
of tensors, ``x @ W`` with ``W [in, out]``, and every per-layer weight
stacked on a leading ``num_layers`` axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

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
    # the per-leaf partition of a training mesh's model group (with
    # ``tp_axis`` its group): block name -> "split" | "gather"
    # (``training.trainer.sharding_mechanism``). A split block runs on
    # this rank's shard as above; a gathered block all-gathers its split
    # leaves at their use and runs whole; attention gathers q / k / v and
    # splits its core over (row, head) pairs, whatever the heads. None:
    # every block split on whole heads (serving, and training where every
    # dim divides).
    tp_plan: Any = dataclasses.field(default=None, compare=False,
                                     repr=False)
    # the data ranks a training mesh splits a batch's rows over (its data
    # axes; 1 without one): a rank's batch is a ``1 / tp_rows`` share of
    # the whole, which the rule that lays a decode state out
    # (:func:`cache_spec`) reads by size
    tp_rows: int = dataclasses.field(default=1, compare=False, repr=False)
    # the reference's beyond-paper levers a rank's program takes
    # (:class:`Levers`, chosen by ``launch.cases.choose_levers``), or None:
    # the baseline program
    levers: Any = dataclasses.field(default=None, compare=False, repr=False)
    # set on the cfg a sequence-parallel layer hands a split block
    # (:func:`seq_block`): the layer gathered the block's input along T and
    # the block leaves through a reduce-scatter along T (:func:`block_out`);
    # where its input enters its products through one copy (:func:`block_in`)
    # that copy is the layer's gather's, whose backward reduce-scatters
    seq_parallel: bool = dataclasses.field(default=False, compare=False,
                                           repr=False)
    # the data-axis group an expert leaf's F is split over (2-D experts,
    # :class:`Levers`), or None
    tp_data: Any = dataclasses.field(default=None, compare=False,
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


class _SeqGather(torch.autograd.Function):
    """Megatron's sequence-parallel gather: every rank's piece along
    ``dim`` in forward; in backward the gradient summed over the ranks,
    of which this rank keeps its piece (a reduce-scatter): each rank's
    gradient of the gathered value is its share of a partial
    computation."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad.contiguous(), ctx.dim), None, \
            None


class _SeqScatter(torch.autograd.Function):
    """Megatron's sequence-parallel reduce-scatter: the sum of every
    rank's partial in forward, of which this rank keeps its piece along
    ``dim``; in backward every rank's gradient piece gathered (every
    rank's partial contributed to every piece)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_gather(grad.contiguous(), ctx.dim), None, None


class _Slice(torch.autograd.Function):
    """This rank's piece along ``dim`` of a value every rank holds whole:
    the piece in forward, every rank's gradient piece gathered in backward
    (:class:`_Gather`'s adjoint)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_gather(grad.contiguous(), ctx.dim), None, None


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


def seq_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's piece of ``x`` along ``dim``, its backward a
    reduce-scatter (:class:`_SeqGather`); ``x`` without a group."""
    if group is None:
        return x
    if _tracked(x):
        return _SeqGather.apply(x, group, dim)
    return group.all_gather(x.contiguous(), dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's piece along ``dim``,
    its backward a gather (:class:`_SeqScatter`); ``x`` without a
    group."""
    if group is None:
        return x
    if _tracked(x):
        return _SeqScatter.apply(x, group, dim)
    return group.reduce_scatter(x.contiguous(), dim)


def seq_slice(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """This rank's piece along ``dim`` of ``x`` (whole on every rank),
    its backward a gather (:class:`_Slice`); ``x`` without a group."""
    if group is None:
        return x
    if _tracked(x):
        return _Slice.apply(x, group, dim)
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * n, n).contiguous()


class Levers(NamedTuple):
    """The reference's beyond-paper levers (its ``build_case(optimized=
    True)``) as a rank's program takes them: ``seq_parallel`` keeps a
    train step's residual stream split on T over the model group between
    layers (:func:`seq_block`); ``ssm_chunk`` the hybrid's chunked SSD;
    ``expert_2d`` splits the expert leaves' F on the data axis
    (``models.mlp``); ``zero1`` cuts the AdamW moments on the data axis
    (``training.trainer``); ``seq_cache`` lays the decode KV cache's
    sequence on the model group (``models.attention``)."""
    seq_parallel: bool = False
    ssm_chunk: int = 0
    expert_2d: bool = False
    zero1: bool = False
    seq_cache: bool = False

    def taken(self) -> Tuple[str, ...]:
        """The names of the levers on."""
        return tuple(k for k, v in self._asdict().items() if v)


def seq_layers(cfg: ModelConfig) -> bool:
    """Whether a whole-sequence pass keeps its residual stream split on
    T over ``cfg.tp_axis`` between layers (the ``seq_parallel`` lever,
    under a group)."""
    return (cfg.tp_axis is not None and cfg.levers is not None
            and cfg.levers.seq_parallel)


def seq_block(fn, h: torch.Tensor, cfg: ModelConfig, block: str,
              enters: bool = True):
    """One block of a sequence-parallel layer: ``h`` [B, T/m, D] this
    rank's rows of the block's (normalised) input, ``fn(whole, cfg)`` the
    block on whole rows; returns its output's rows of this rank (with
    ``fn``'s other outputs, where it returns a tuple). A split ``block``
    (``cfg.tp_plan``) runs on the rows gathered along T and leaves through
    a reduce-scatter (``cfg.seq_parallel``: :func:`block_out`); with
    ``enters`` its input enters its products through one copy
    (:func:`block_in`), which the gather's backward reduce-scatter stands
    for, else (the MoE's router, rwkv6's token-shift lerps: work on the
    whole input before the copy) the gather's backward takes this rank's
    rows of a whole gradient. A gathered block runs whole on the gathered
    rows and this rank takes its rows of the output."""
    g = cfg.tp_axis
    if not split_block(cfg, block):
        out = fn(all_gather(h, g, 1), cfg)
        if isinstance(out, tuple):
            return (seq_slice(out[0], g),) + tuple(out[1:])
        return seq_slice(out, g)
    inner = dataclasses.replace(cfg, seq_parallel=True)
    return fn(seq_gather(h, g) if enters else all_gather(h, g, 1), inner)


def block_in(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A split block's input where it enters the rank's products:
    ``copy_to_tp``, or ``x`` itself under ``cfg.seq_parallel`` (the
    layer's gather carries the backward sum)."""
    return x if cfg.seq_parallel else copy_to_tp(x, cfg)


def block_out(y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A split block's partial output [B, T, ...]: all-reduced
    (``psum_if_tp``), or under ``cfg.seq_parallel`` reduce-scattered
    along T (this rank's rows of the sum)."""
    if cfg.seq_parallel:
        return reduce_scatter(y, cfg.tp_axis, 1)
    return psum_if_tp(y, cfg)


def seq_piece(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A split block's whole value [B, T, ...] where it meets its output:
    ``x``, or under ``cfg.seq_parallel`` this rank's rows
    (:func:`seq_slice`)."""
    return seq_slice(x, cfg.tp_axis, 1) if cfg.seq_parallel else x


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


def split_block(cfg: ModelConfig, block: str) -> bool:
    """Whether ``block`` (a key of ``cfg.tp_plan``) runs on this rank's
    shard over ``cfg.tp_axis``: every block does under a group without a
    plan, none without a group."""
    if cfg.tp_axis is None:
        return False
    return cfg.tp_plan is None or cfg.tp_plan.get(block) == "split"


def unsplit(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` without its group and plan: the one-device forward a
    gathered block runs on its whole leaves."""
    return dataclasses.replace(cfg, tp_axis=None, tp_plan=None,
                               seq_parallel=False)


def leaf_at_use(w: torch.Tensor, cfg: ModelConfig, dim: int,
                full: int) -> torch.Tensor:
    """``w`` whole where a gathered block uses it: all-gathered over
    ``cfg.tp_axis`` along ``dim`` where this rank holds a piece of a leaf
    ``full`` wide there (differentiable: the rank keeps its slice of the
    gradient), ``w`` itself where it is whole."""
    if cfg.tp_axis is None or w.shape[dim] == full:
        return w
    return all_gather(w, cfg.tp_axis, dim % w.dim())


def rank_cols(cfg: ModelConfig, n: int) -> slice:
    """This rank's ``n`` consecutive entries of an axis cut into equal
    pieces over ``cfg.tp_axis`` (rank r: ``[r·n, (r + 1)·n)``)."""
    r = cfg.tp_axis.rank
    return slice(r * n, (r + 1) * n)


def cache_spec(shape: Sequence[int], *, batch_size: int, cache_seq,
               data: int = 1, model: int = 1, context_parallel: bool = False,
               seq_on_model: bool = False) -> Tuple[Optional[str], ...]:
    """The axis each dim of a decode-cache leaf of ``shape`` lies on
    (``"data"``, ``"model"`` or None) on a mesh of ``data`` x ``model``:
    the rule of ``launch.shardings.cache_shardings``, and its one copy.
    Axes are found by SIZE (layouts differ per family): the batch axis is
    the first non-leading dim equal to ``batch_size``, on ``data`` where
    it divides; with ``context_parallel`` (one long sequence) the first
    dim equal to ``cache_seq`` goes on ``data`` instead. Then ``model``
    takes the first later dim it divides among the heads (neither the
    sequence nor the last), the sequence (``seq_on_model`` only) and the
    last (head_dim)."""
    shape = tuple(shape)
    r = len(shape)
    spec: list = [None] * r
    if context_parallel:
        data_ax = next((i for i, d in enumerate(shape)
                        if d == cache_seq and d % data == 0), None)
    else:
        data_ax = next((i for i in range(1, r) if shape[i] == batch_size
                        and shape[i] % data == 0), None)
    if data_ax is not None:
        spec[data_ax] = "data"
    start = (data_ax + 1) if data_ax is not None else 1
    non_seq = [i for i in range(start, r) if spec[i] is None
               and shape[i] != cache_seq]
    heads = [i for i in non_seq if i < r - 1]
    seq = ([i for i in range(start, r) if spec[i] is None
            and shape[i] == cache_seq] if seq_on_model else [])
    final = [i for i in non_seq if i == r - 1]
    for i in heads + seq + final:
        if shape[i] % model == 0:
            spec[i] = "model"
            break
    return tuple(spec)


def state_piece(cfg: ModelConfig, whole: Sequence[int], cache_seq,
                rows_dim: int) -> Tuple[int, ...]:
    """The shape of this rank's piece of a decode-state leaf whose shape
    over the rank's batch rows (at dim ``rows_dim``) is ``whole``: the
    leaf of the whole batch (``cfg.tp_rows`` times the rows) laid out by
    :func:`cache_spec` for a cache of ``cache_seq`` rows, cut on the dim
    it puts ``model`` on; ``whole`` itself without a group. A rank holds
    its rows of the batch, so where the rule puts ``data`` on another dim
    (a state dim of the whole batch's size) it is refused."""
    whole = tuple(whole)
    if cfg.tp_axis is None:
        return whole
    d, m = cfg.tp_rows, cfg.tp_axis.size
    glob = list(whole)
    glob[rows_dim] *= d
    spec = cache_spec(glob, batch_size=glob[rows_dim], cache_seq=cache_seq,
                      data=d, model=m)
    if d > 1 and spec[rows_dim] != "data":
        raise ValueError(
            f"the decode-state rule puts the data axis ({d}) of a leaf "
            f"{tuple(glob)} on dim {spec.index('data')}, not on its batch "
            f"rows (dim {rows_dim}): a rank's program holds its own rows")
    return tuple(n // m if ax == "model" else n
                 for n, ax in zip(whole, spec))


def state_axis(sizes: Sequence[int], model: int,
               cache_seq=None) -> Optional[int]:
    """The index in ``sizes`` of the dim :func:`cache_spec` puts ``model``
    on for a leaf ``[layers, batch, *sizes]`` whose batch no other dim
    equals (None: whole on every rank): the layout a plan names."""
    spec = cache_spec((1, 0) + tuple(sizes), batch_size=0,
                      cache_seq=cache_seq, model=model)
    return spec.index("model") - 2 if "model" in spec else None


def split_dim(local, whole) -> Optional[int]:
    """The dim where a rank's piece of shape ``local`` is narrower than
    the leaf's ``whole`` shape (None: it is the whole leaf)."""
    return next((i for i, (a, b) in enumerate(zip(local, whole)) if a != b),
                None)


def state_at_use(a: torch.Tensor, cfg: ModelConfig, whole) -> torch.Tensor:
    """A decode-state leaf ``a`` whole on every rank: all-gathered over
    ``cfg.tp_axis`` along the dim where this rank holds a piece of a
    leaf of shape ``whole`` (a state is never differentiated), ``a``
    itself where it is whole."""
    d = split_dim(a.shape, whole)
    if d is None:
        return a
    return cfg.tp_axis.all_gather(a.contiguous(), d)


def state_in(leaf: torch.Tensor, cfg: ModelConfig, whole,
             want) -> torch.Tensor:
    """The piece of a decode-state leaf that this rank computes on, of
    shape ``want`` (``whole``: the leaf's whole shape): ``leaf`` itself
    where it already is that piece (no collective), else the leaf
    gathered at its use (:func:`state_at_use`) and cut to ``want`` (a
    tensor of its own)."""
    if tuple(leaf.shape) == tuple(want):
        return leaf
    return piece_of(state_at_use(leaf, cfg, whole), cfg, want).clone()


def state_out(leaf: torch.Tensor, work: torch.Tensor, cfg: ModelConfig,
              whole) -> None:
    """Write ``work`` (a rank's piece from :func:`state_in`, the whole
    value, or the leaf itself) back into the decode-state leaf ``leaf``
    in its layout: a piece cut on another dim is first gathered over
    the group."""
    if work is leaf:
        return
    if tuple(work.shape) != tuple(leaf.shape):
        work = piece_of(state_at_use(work, cfg, whole), cfg, leaf.shape)
    leaf.copy_(work)


def piece_of(x: torch.Tensor, cfg: ModelConfig, local) -> torch.Tensor:
    """This rank's piece of the whole value ``x`` in a leaf whose rank
    piece has shape ``local``: ``x`` narrowed at the rank along the dim
    where they differ (``x`` itself where they do not)."""
    d = split_dim(local, x.shape)
    if d is None:
        return x
    n = local[d]
    return x.narrow(d, cfg.tp_axis.rank * n, n)


def card_device(device) -> bool:
    """Whether code on ``device`` takes the card's forms (the chunked
    recurrences, the attention kernels' operators): on the card, and on
    the meta device, which holds no data and stands for the card where a
    program is only counted (``launch.dryrun``)."""
    return torch.device(device).type in ("cuda", "meta")


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
                 mask=None, group=None, vocab_group=None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32: ``logsumexp(logits)`` minus
    the gold logit, per position of ``logits [..., V]`` / ``labels``
    int [...]; with ``mask`` [...], the masked mean
    ``sum(nll * mask) / max(sum(mask), 1)`` (the reference's
    ``softmax_xent``). With a data-parallel ``group`` the rows are this
    rank's share: the rank's sum over the group's whole count (mask sum,
    or positions), so the ranks' values add up to the whole batch's
    mean. With a ``vocab_group`` the logits are this rank's columns of
    the vocabulary (rank r: ``[r·V/n, (r + 1)·V/n)``) and stay so: the
    row's max is gathered, its sum of exponentials and its gold logit
    are all-reduced (:func:`vocab_split_terms`)."""
    logits = logits.float()
    if vocab_group is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        logz, gold = vocab_split_terms(logits, labels, vocab_group)
    nll = logz - gold
    if group is not None:
        w = torch.ones_like(nll) if mask is None else mask.float()
        count = group.all_reduce(w.sum().detach().reshape(1))[0]
        return torch.sum(nll * w) / torch.clamp(count, min=1.0)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def vocab_split_terms(logits: torch.Tensor, labels: torch.Tensor, group):
    """``(logsumexp, gold logit)`` per row of f32 logits split on the
    vocabulary over ``group`` (this rank's ``V / n`` consecutive columns),
    as a vocab-parallel cross-entropy computes them: the rows' maxima
    gathered (no gradient: the log-sum-exp does not depend on them), the
    sums of ``exp(logit - max)`` all-reduced, and the gold logit taken
    by the rank that holds its column (zeros elsewhere) and
    all-reduced. Both sums are differentiable (``all_reduce``), so each
    rank's logits get their columns' gradient."""
    vl = logits.shape[-1]
    with torch.no_grad():
        m = logits.amax(-1, keepdim=True)
        m = group.all_gather(m, -1).amax(-1, keepdim=True)
    logz = m[..., 0] + torch.log(all_reduce(
        torch.exp(logits - m).sum(-1), group))
    local = labels.long() - group.rank * vl
    ok = (local >= 0) & (local < vl)
    g = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    return logz, all_reduce(torch.where(ok, g, torch.zeros_like(g)), group)

