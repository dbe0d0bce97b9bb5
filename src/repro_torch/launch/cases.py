"""Dry-run cases — the port's counterpart of ``repro.launch.cases``:
(architecture × input shape × layout) -> ONE RANK's program, its inputs
and their bytes.

Input shapes (assignment):
    train_4k     seq 4096,   global batch 256   -> train_step
    prefill_32k  seq 32768,  global batch 32    -> prefill
    decode_32k   seq 32768,  global batch 128   -> serve_step (1 new token)
    long_500k    seq 524288, global batch 1     -> serve_step, sub-quadratic

Family adjustments (the reference's):
  * long_500k gives full-attention families a sliding-window (8192)
    variant; whisper skips long_500k (448-position decoder, no 500k story);
    rwkv6 (O(1) state) and zamba2 run their native decode.
  * whisper's decoder position table is extended to the exercised decode
    length (synthetic but shape-faithful).
  * MoE archs run the GShard capacity-dispatch path instead of the
    dense-verification path; with the experts split on ``model`` (the
    training rules) each rank runs its E / model experts on its kept
    (token, k) pairs and all-reduces the combined output once.

**One rank's program.** The reference lowers the global step on 512
forced host devices and lets GSPMD find the per-chip program. The port
has no such compiler, so a case writes rank 0's program out from the
port's own rules: the params cut by ``launch.shardings.param_shardings``
on a ``launch.mesh.VirtualRank`` of the layout (its groups record their
collectives instead of communicating), the model group run by the
plan ``training.trainer.sharding_mechanism`` makes (tensor parallelism
where every dim divides; else the per-leaf partition: each block split
where its dims divide, the rest gathering their split leaves at their
use, attention on gathered q / k / v with its core split over (row,
head) pairs, rwkv6's and zamba2's recurrences on the rank's heads), the
batch rows on the data axes (``pod × data``, one group). No case
gathers the tree or the decode state.
Given a rank of a ``launch.mesh.TrainMesh`` instead of a layout, the
case is that rank's program over its real groups.

  * **train**: ``make_sharded_train_step(remat=True)`` on the rank's
    rows, the AdamW moments shaped like the shard (the reference's
    ``make_train_step(remat=True)`` under GSPMD).
  * **prefill**: ``Model.prefill(params, tokens, cache_len=T)`` on the
    rank's rows.
  * **decode**: one ``Model.decode_step`` against a cache of T rows
    (``min(T, W)`` under a window) for the rank's rows, the cache laid out by
    ``launch.shardings.cache_shardings``: each leaf stays the rank's slice (on
    kv heads, or on the head dim, whose decode all-reduces its partial scores:
    ``models.attention.head_dim_decode``; rwkv6's state on its heads and its
    token-shift rows on D, gathered at their use; zamba2's conv state on its
    channels and SSD state on its heads; whisper's cross K/V on the encoder's
    frames where they divide, whose shares merge by log-sum-exp). At B 1
    (``long_500k``) the cache's sequence shards on ``data`` (context
    parallelism): each data rank decodes over its keys and the shares merge by
    log-sum-exp
    (``models.attention.context_parallel_decode``). rwkv6's state has no
    sequence axis, so every data rank decodes the same state.

A case is built on fake tensors on the meta device by default
(``FakeTensorMode``: shapes and dtypes, nothing allocated, no card
needed; ``launch.dryrun`` traces it), or on real tensors on ``device``
(weights from a seeded ``torch.Generator``, a random cache), with the
global batch cut by ``batch=``. The meta device stands for the card
(``models.common.card_device``), so the fake program is the one the
card runs: the recurrences take their chunked forms, and the attention
kernels (#5, #6) are their operators' fake versions
(``kernels.ops.LIBRARY``). Not fake CUDA tensors: a CPU-only build of
PyTorch has no CUDA device guard, which autograd needs for a train
step.

**The levers** (``optimized=True``, the reference's beyond-paper
program; :func:`choose_levers` picks them per kind as the reference's
``build_case`` does, and they ride in ``cfg.levers``,
``models.common.Levers``): sequence-parallel activations in train (the
residual stream on a rank's T / m rows between layers, Megatron's
gather / reduce-scatter pair at each block), the chunked SSD (128) for
the hybrid in train and prefill, 2-D experts (F also on the data axis)
in every MoE decode and in train and prefill where ``2 · params /
model`` passes 8 GiB, ZeRO-1 moments in train
(``training.trainer.ShardedTrainStep``), and the decode KV cache laid
out by ``cache_shardings(seq_on_model=True)``: where that puts the
sequence on ``model`` (kv heads that do not divide it) each rank holds
S / m rows of every head and the shares merge by log-sum-exp
(``models.attention``). Each computes what the baseline program does.
Nothing here runs at import.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.core.migration import tree_leaves, tree_map
from repro_torch.launch.mesh import VirtualRank
from repro_torch.launch.shardings import cache_shardings, local_shard
from repro_torch.models.attention import rope_freqs
from repro_torch.models.common import Levers, ModelConfig
from repro_torch.models.model import Model, build_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import make_sharded_train_step

SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind=0),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind=1),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind=2),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind=2),
}

SLIDING_WINDOW_LONG = 8192
# 2-D experts in train / prefill only where a chip's bf16 weights would
# pass this (the reference's rule)
EXPERT_2D_BYTES = 8 * 2**30
SSM_CHUNK = 128


def shape_kind(shape_name: str) -> str:
    return {0: "train", 1: "prefill", 2: "decode"}[SHAPES[shape_name]["kind"]]


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    if arch == "whisper-large-v3" and shape_name == "long_500k":
        return ("enc-dec audio decoder is position-capped (448); no 500k "
                "decode story (DESIGN §4)")
    return None


def adjusted_config(arch: str, shape_name: str,
                    dtype=torch.bfloat16) -> ModelConfig:
    cfg = get_config(arch, dtype=dtype)
    over: Dict[str, Any] = {}
    if cfg.num_experts:
        over["moe_impl"] = "gshard"
    if shape_name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        over["sliding_window"] = SLIDING_WINDOW_LONG
    if cfg.family == "encdec":
        # extend the decoder position table to the exercised length
        seq = SHAPES[shape_name]["seq_len"]
        if shape_name != "train_4k":
            over["max_position"] = max(cfg.max_position, seq + 1)
        else:
            over["max_position"] = max(cfg.max_position, 4096 + 1)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    return cfg


@dataclasses.dataclass
class DryrunCase:
    """One rank's program: ``fn(*args)`` runs it (under ``mode`` when the
    args are fake). ``rank`` is the :class:`~repro_torch.launch.mesh.
    VirtualRank` whose ``records`` collect its collectives (or a rank of
    a ``TrainMesh``, whose groups communicate); ``plan`` the
    ``training.trainer.Plan`` its model group runs; ``batch`` the
    global batch it was built at, ``rows`` the rank's share of it;
    ``arg_bytes`` what the rank holds before it runs (its shard of the
    params, the moments, its inputs and cache)."""
    arch: str
    shape_name: str
    cfg: ModelConfig
    fn: Callable
    args: Tuple[Any, ...]
    model: Model
    rank: VirtualRank
    mechanism: str
    batch: int
    rows: int
    seq: int
    arg_bytes: float
    context_parallel: bool = False
    plan: Any = None
    mode: Any = None
    levers: Optional[Levers] = None
    step: Any = None


def choose_levers(cfg: ModelConfig, kind: str, model: int,
                  seq_cache: bool = False) -> Levers:
    """The reference's beyond-paper levers for a case of ``kind`` on a
    model axis of ``model`` (its ``build_case(optimized=True)``):
    sequence-parallel activations and ZeRO-1 in train (in prefill the
    reference measured sequence parallelism a regression); the chunked
    SSD for the hybrid in train and prefill; 2-D experts always in
    decode (weight streaming is the wall), in train and prefill only
    where ``2 · params_total / model`` (``sim.costmodel.
    profile_from_config``) passes ``EXPERT_2D_BYTES``; ``seq_cache`` (a
    decode whose KV leaf the rule lays on the sequence) as given."""
    from repro_torch.sim.costmodel import profile_from_config
    expert_2d = False
    if cfg.num_experts:
        expert_2d = kind == "decode" or (
            2.0 * profile_from_config(cfg).params_total / model
            > EXPERT_2D_BYTES)
    return Levers(
        seq_parallel=kind == "train",
        ssm_chunk=(SSM_CHUNK if cfg.family == "hybrid"
                   and kind in ("train", "prefill") else 0),
        expert_2d=expert_2d, zero1=kind == "train",
        seq_cache=kind == "decode" and seq_cache)


def _specs(cfg: ModelConfig, B: int, T: int) -> Dict[str, Tuple[tuple,
                                                                 Any]]:
    """(shape, dtype) of every model input of a token batch."""
    sh: Dict[str, Tuple[tuple, Any]] = {"tokens": ((B, T), torch.int32)}
    if cfg.family == "encdec":
        sh["audio_embeds"] = ((B, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        n_patch = max(1, T // 8)
        sh["vision_embeds"] = ((B, n_patch, cfg.d_model), cfg.dtype)
        sh["vision_mask"] = ((B, T), torch.bool)
        sh["mrope_positions"] = ((B, T, 3), torch.int32)
    return sh


def input_specs(arch: str, shape_name: str = "train_4k"):
    """Stand-ins for every model input of the given (arch, shape):
    tensors on the ``meta`` device (shape and dtype, no storage), the
    counterpart of the reference's ``ShapeDtypeStruct``s."""
    cfg = adjusted_config(arch, shape_name)
    sp = SHAPES[shape_name]
    B, T = sp["global_batch"], sp["seq_len"]
    if shape_kind(shape_name) == "decode":
        return {"token": torch.empty((B,), dtype=torch.int32, device="meta"),
                "pos": torch.empty((B,), dtype=torch.int32, device="meta")}
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in _specs(cfg, B, T).items()}


def _token_batch(cfg: ModelConfig, B: int, T: int, device,
                 gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A token batch of the family's inputs drawn from ``gen``: random
    tokens, normal embeddings, the first ``T // 8`` positions a VLM's
    patches, its M-RoPE ids the text positions on all three streams."""
    out = {}
    for k, (shape, dt) in _specs(cfg, B, T).items():
        if k == "tokens":
            out[k] = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                   device=device, dtype=dt)
        elif k == "vision_mask":
            n_patch = max(1, T // 8)
            out[k] = (torch.arange(T, device=device) < n_patch)[None].expand(
                shape).contiguous()
        elif k == "mrope_positions":
            out[k] = torch.arange(T, device=device, dtype=dt)[
                None, :, None].expand(shape).contiguous()
        else:
            out[k] = torch.randn(shape, generator=gen, device=device,
                                 dtype=dt)
    return out


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a cache pytree and its specs (the same
    structure, a spec tuple per leaf), the structure kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    out = [_zip_map(fn, t, s) for t, s in zip(tree, specs)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def _own(piece: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """A rank's piece of a leaf as a tensor of its own (the leaf itself
    where the piece is all of it: no copy of a cache that one rank holds
    whole)."""
    return whole if piece.shape == whole.shape else piece.clone()


def _pairs(tree, other):
    """``(leaf, item)`` of a cache pytree and a tree of its structure
    (:func:`_zip_map`'s output), in the cache's leaf order."""
    if isinstance(tree, torch.Tensor):
        yield tree, other
    elif isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], other[k])
    else:
        for t, o in zip(tree, other):
            yield from _pairs(t, o)


def _nbytes(tree) -> float:
    return float(sum(a.numel() * a.element_size()
                     for a in tree_leaves(tree)))


def build_case(arch: str, shape_name: str, mesh, optimized: bool = False,
               *, batch: Optional[int] = None, seq: Optional[int] = None,
               cfg: Optional[ModelConfig] = None, device=None,
               seed: int = 0) -> DryrunCase:
    """Rank 0's program of (arch, shape) on the layout ``mesh`` (a
    ``launch.mesh.Layout``). ``batch`` cuts the global batch and ``seq``
    the sequence (default the shape's), ``cfg`` replaces
    :func:`adjusted_config`'s (a reduced config in tests); ``device``
    None builds on fake meta tensors (the dry run), else real tensors
    there: weights from ``seed``, inputs and the cache drawn from ``seed
    + 1`` (CPU generators under fake tensors). ``optimized=True``
    takes the reference's beyond-paper levers (:func:`choose_levers`,
    ``case.levers``)."""
    reason = skip_reason(arch, shape_name)
    if reason is not None:
        raise ValueError(f"skipped: {reason}")
    mode = FakeTensorMode() if device is None else None
    dev = torch.device("meta" if device is None else device)
    gen_dev = "cpu" if device is None else dev
    with fake_scope(mode):
        case = _build(arch, shape_name, mesh, cfg, batch, seq, dev, gen_dev,
                      seed, optimized)
    case.mode = mode
    return case


@contextlib.contextmanager
def fake_scope(mode):
    """Enter ``mode`` (a ``FakeTensorMode``, or None for real tensors)
    with the models' cached tensors (``attention.rope_freqs``) dropped on
    entry and exit, so that no fake tensor outlives the scope in a cache
    and no real one enters it."""
    if mode is None:
        yield
        return
    rope_freqs.cache_clear()
    try:
        with mode:
            yield
    finally:
        rope_freqs.cache_clear()


def _build(arch, shape_name, mesh, cfg, batch, seq, dev, gen_dev,
           seed, optimized=False) -> DryrunCase:
    cfg = cfg or adjusted_config(arch, shape_name)
    sp = SHAPES[shape_name]
    B, T = batch or sp["global_batch"], seq or sp["seq_len"]
    kind = shape_kind(shape_name)
    # a training mesh's rank runs its own program over its groups; a
    # layout is written out as its rank 0
    rank = mesh if hasattr(mesh, "model_group") else VirtualRank(mesh, dev)
    S_eff = min(T, cfg.sliding_window) if cfg.sliding_window else T
    whole = specs = None
    levers = None
    if kind == "decode":
        whole = build_model(cfg).init_cache(B, T, device=dev)
        specs = cache_shardings(whole, rank, batch_size=B, cache_seq=S_eff,
                                context_parallel=B == 1,
                                seq_on_model=optimized)
    if optimized:
        seq_cache = bool(cfg.num_heads) and kind == "decode" and any(
            a.dim() == 5 and a.shape[2] == S_eff and s[2] == "model"
            for a, s in _pairs(whole, specs))
        levers = choose_levers(cfg, kind, rank.model, seq_cache)
        cfg = dataclasses.replace(cfg, levers=levers)
        if levers.ssm_chunk:
            cfg = dataclasses.replace(cfg, ssm_chunk=levers.ssm_chunk)
    model = build_model(cfg)
    step = make_sharded_train_step(model, AdamWConfig(), rank,
                                   remat=kind == "train")
    params = step.shard(model.init(
        torch.Generator(device=gen_dev).manual_seed(seed), device=dev))
    gen = torch.Generator(device=gen_dev).manual_seed(seed + 1)

    plan = step.plan
    if levers is not None and levers.seq_cache:   # the KV on the sequence
        plan = plan._replace(axes=dict(plan.axes, cache="seq"))

    def case(fn, args, rows, arg_bytes, cp=False):
        return DryrunCase(arch, shape_name, cfg, fn, args, step.model, rank,
                          step.mechanism, B, rows, T, arg_bytes, cp,
                          plan=plan, levers=levers, step=step)

    if kind == "train":
        local = {k: v.clone() for k, v in step.rows(
            _token_batch(cfg, B, T, dev, gen)).items()}
        opt_state = step.init_moments(params)

        return case(step.local_step, (params, opt_state, local),
                    local["tokens"].shape[0],
                    _nbytes(params) + _nbytes([opt_state.mu, opt_state.nu])
                    + _nbytes(local))

    if kind == "prefill":
        _rows_divide(rank, B)
        extras = {k: v.clone() for k, v in step.rows(
            _token_batch(cfg, B, T, dev, gen)).items()}
        tokens = extras.pop("tokens")

        def prefill_step(params, tokens, extras):
            with torch.no_grad():
                return step.model.prefill(params, tokens, cache_len=T,
                                          **extras)
        return case(prefill_step, (params, tokens, extras), tokens.shape[0],
                    _nbytes(params) + _nbytes([tokens, extras]))

    # decode: one new token against a cache of T tokens
    context_parallel = B == 1
    cache = _zip_map(lambda a, s: _own(local_shard(a, s, rank), a), whole,
                     specs)
    del whole
    leaves = tree_leaves(cache)
    if not isinstance(leaves[0], FakeTensor):
        for leaf in leaves:                   # a real run: a random cache
            leaf.normal_(generator=gen)
    seq_group = None
    if context_parallel and any("data" in s for _, s in _pairs(cache,
                                                                specs)):
        seq_group = rank.data_group
    token = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                          device=dev, dtype=torch.int32)
    pos = torch.full((B,), T - 1, dtype=torch.int32, device=dev)
    if B > 1 and B % rank.data == 0:
        n = B // rank.data
        token, pos = (x[rank.d * n:(rank.d + 1) * n].clone()
                      for x in (token, pos))

    def serve_step(params, cache, token, pos):
        with torch.no_grad():
            kw = {} if seq_group is None else {"seq_group": seq_group}
            return step.model.decode_step(params, cache, token, pos, **kw)
    return case(serve_step, (params, cache, token, pos), token.shape[0],
                _nbytes(params) + _nbytes([cache, token, pos]),
                cp=seq_group is not None)


def _rows_divide(rank, B: int) -> None:
    """Refuse a prefill of ``B`` rows that the data axes do not divide:
    every rank would hold all of them, where the decode state's layout
    (``common.state_piece``) takes a rank's rows as its share."""
    if rank.data > 1 and B % rank.data:
        raise ValueError(f"a prefill of {B} rows on a data axis of "
                         f"{rank.data}: the rows must divide it")


def rank_prefill_decode(mesh, cfg: ModelConfig, seed: int, tokens, cache_len,
                        token, pos, extras=None) -> dict:
    """One rank's part of a prefill and one decode step of ``cfg`` on the
    model group of a ``launch.mesh.TrainMesh`` (every rank runs it:
    ``mesh.run(rank_prefill_decode, ...)``), on given inputs: the whole
    tree drawn from ``seed`` on the rank's device and cut by the training
    rules, the forward on the config's plan (``training.trainer.
    sharding_mechanism``); ``tokens`` [B, T], ``token`` / ``pos`` [B]
    and a family's prefill ``extras`` (whisper's ``audio_embeds``) are
    the whole batch's, of which the rank takes its rows. The decode
    continues from the prefill's cache (``cache_len`` rows, this rank's
    slice). Returns on the CPU the mechanism, the prefill's logits [rows,
    V] and cache slice, then the decode step's logits and cache slice
    (each cache in its own structure)."""
    _rows_divide(mesh, tokens.shape[0])
    model = build_model(cfg)
    step = make_sharded_train_step(model, AdamWConfig(), mesh)
    params = step.shard(model.init(seed, device=mesh.device))
    extras = dict(extras or {})
    rows = step.rows({"tokens": tokens, "token": token, "pos": pos,
                      **extras})

    def host(cache):
        return tree_map(lambda a: a.detach().cpu().clone(), cache)
    with torch.no_grad():
        logits, cache = step.model.prefill(
            params, rows["tokens"], cache_len=cache_len,
            **{k: rows[k] for k in extras})
        out = {"rank": mesh.rank, "mechanism": step.mechanism,
               "logits": logits.cpu(), "cache": host(cache)}
        logits, cache = step.model.decode_step(params, cache, rows["token"],
                                               rows["pos"])
    out.update(decode_logits=logits.cpu(), decode_cache=host(cache))
    return out

