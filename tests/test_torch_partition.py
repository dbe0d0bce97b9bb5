"""The per-leaf partition of a rank's program (``training.trainer.
sharding_mechanism``'s :class:`Plan`), f32 on the CPU.

* **The plan** of every config at model 2 and 16: each block's mode
  (split, or gathered at its use), where the core and the decode cache
  split, and the mechanism; rwkv6's, zamba2's and whisper's blocks too
  (``tests/test_torch_partition_families.py`` runs them).
* **Sharded == unsharded** on a (data 2, model 2) gloo group of four
  ranks (threads of this process): the reduced smollm with 3 heads and
  1 kv head (H·Dh 192, Hkv·Dh 64 and d_ff 512 divide 2, the heads do
  not: attention's core splits over (row, head) pairs and the decode
  cache on its head dim), the same with d_ff and vocab 511, whose MLP and
  vocab the rules leave whole (the blocks gather at use: nothing is
  split, so nothing moves), and the reduced qwen3-moe under
  ``moe_gshard``, whose every dim divides (tensor parallelism: its
  experts split, each rank running its E / 2 on its kept pairs, its
  cache on kv heads); and the first config at (data 1, model 3), where H·Dh splits but Hkv·Dh does not: attention gathers
  ``wq`` and ``wo`` at use and runs whole-leaf projections, the cache
  stays whole. The train step (2 AdamW steps, remat) — loss, grad norm and
  the params after it — the prefill's logits and cache slices, and a
  decode step's logits and cache slices equal the port's unsharded run
  within ``TOL`` = 1e-5 (of the largest magnitude, at least 1; AdamW at
  eps 1e-5 as ``tests/test_torch_sharded_training.py`` explains); each
  program's collectives on the model group equal the count written from
  the code (``_hand_count``).
* **Against the reference**: the first config's sharded step at (1, 2)
  against the reference's GSPMD step (``jax.jit(make_train_step)`` over
  ``param_shardings`` on ``make_host_mesh(model=2)``; conftest gives JAX
  two host devices) within ``REF_TOL`` = 1e-4.
* **The dry run** of the first config at (2, 2): every kind traced
  under fake tensors on the per-leaf plan, its recorded collectives the
  hand count, its traced FLOPs within 2x of the analytic share, the
  row's ``plan``."""
import dataclasses
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro.training.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.training.data import TokenStream as JaxStream  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.migration import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.cases import _zip_map, adjusted_config  # noqa: E402
from repro_torch.launch.mesh import Layout  # noqa: E402
from repro_torch.launch.shardings import (cache_shardings,  # noqa: E402
                                          local_shard, param_leaves,
                                          param_spec)
from repro_torch.models import build_model, mamba2  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            init_adamw)
from repro_torch.training.trainer import (batch_to,  # noqa: E402
                                          make_sharded_train_step,
                                          make_train_step,
                                          sharding_mechanism)

TOL, REF_TOL = 1e-5, 1e-4
STEPS, B, T = 2, 4, 32
CACHE = 40                  # the prefill's cache rows (T prompt + room)
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS, eps=1e-5)
DATA = DataConfig(batch_size=B, seq_len=T)
ODD_HEADS = dict(num_heads=3, num_kv_heads=1)
# case -> (arch, reduced(**over), (data, model))
CASES = {"pairs": ("smollm-360m", ODD_HEADS, (2, 2)),
         "mlp-vocab-whole": ("smollm-360m",
                             dict(ODD_HEADS, d_ff=511, vocab_size=511),
                             (2, 2)),
         "gshard-experts": ("qwen3-moe-30b-a3b", {}, (2, 2)),
         "model-3": ("smollm-360m", ODD_HEADS, (1, 3))}


def _cfg(case):
    arch, over, _ = CASES[case]
    cfg = get_config(arch).reduced(**over)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_impl="gshard")
    return cfg


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------
S, G = "split", "gather"
DECODER = dict(embed=S, attn=S, mlp=S, unembed=S, core=S, cache=S)
GSHARD = dict(embed=S, attn=S, experts=S, unembed=S, core=S, cache=S)
RWKV = dict(embed=S, tmix=S, cmix=S, unembed=S, core=S, cache=S)
ZAMBA = dict(embed=S, mamba=S, attn=S, mlp=S, unembed=S, core=S, cache=S)
WHISPER = dict(embed=S, attn=S, cross_attn=S, mlp=S, core=S, cache=S)
# arch -> {model: (mechanism, blocks, axes)}; MoE archs under gshard (the
# dry run's impl); rwkv6's axes are its recurrence's and its state S's
PLANS = {
    "llama3.2-3b": {2: ("tensor", DECODER, ("heads", "kv heads")),
                    16: ("per-leaf", DECODER, ("pairs", "head_dim"))},
    "smollm-360m": {2: ("per-leaf", DECODER, ("pairs", "head_dim")),
                    16: ("per-leaf", DECODER, ("pairs", "head_dim"))},
    "qwen2.5-14b": {2: ("tensor", DECODER, ("heads", "kv heads")),
                    16: ("per-leaf", DECODER, ("pairs", "head_dim"))},
    "minitron-8b": {2: ("tensor", DECODER, ("heads", "kv heads")),
                    16: ("per-leaf", DECODER, ("heads", "head_dim"))},
    "starcoder2-3b": {2: ("tensor", DECODER, ("heads", "kv heads")),
                      16: ("per-leaf", DECODER, ("pairs", "head_dim"))},
    "qwen2-vl-7b": {2: ("tensor", DECODER, ("heads", "kv heads")),
                    16: ("per-leaf", DECODER, ("pairs", "head_dim"))},
    "qwen3-moe-30b-a3b": {2: ("tensor", GSHARD, ("heads", "kv heads")),
                          16: ("per-leaf", GSHARD, ("heads", "head_dim"))},
    "arctic-480b": {2: ("tensor", dict(GSHARD, mlp=S),
                        ("heads", "kv heads")),
                    16: ("per-leaf", dict(GSHARD, mlp=S),
                         ("pairs", "head_dim"))},
    "rwkv6-7b": {2: ("tensor", RWKV, ("heads", "heads")),
                 16: ("tensor", RWKV, ("heads", "heads"))},
    "zamba2-2.7b": {2: ("per-leaf", ZAMBA, ("heads", "kv heads")),
                    16: ("per-leaf", ZAMBA, ("heads", "kv heads"))},
    "whisper-large-v3": {2: ("tensor", WHISPER, ("heads", "kv heads")),
                         16: ("per-leaf", dict(WHISPER, embed=G),
                              ("pairs", "head_dim"))},
}
# the families' other axes: zamba2's SSD, whisper's cross K/V cache (on
# the encoder's 1500 frames where they divide, as cache_shardings lays it)
MORE_AXES = {("zamba2-2.7b", 2): {"ssd": "heads"},
             ("zamba2-2.7b", 16): {"ssd": "heads"},
             ("whisper-large-v3", 2): {"cross": "seq"},
             ("whisper-large-v3", 16): {"cross": "head_dim"}}
# block -> the paths of its leaves, by family
BLOCK_LEAVES = {
    "ssm": {"embed": r"^embed$", "unembed": r"^unembed$",
            "tmix": r"^layers/w_[rkvgo]$", "cmix": r"^layers/cw_"},
    "hybrid": {"embed": r"^embed$", "unembed": r"^unembed$",
               "mamba": r"^mamba/", "attn": r"^shared/attn/",
               "mlp": r"^shared/ffn/"},
    "encdec": {"embed": r"^embed$",
               "attn": r"^(enc_layers/attn|dec_layers/self_attn)/",
               "cross_attn": r"^dec_layers/cross_attn/",
               "mlp": r"^(enc|dec)_layers/ffn/"}}


@pytest.mark.parametrize("model", [2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_of_every_config(arch, model):
    cfg = get_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_impl="gshard")
    want = PLANS[arch][model]
    plan = sharding_mechanism(cfg, model)
    assert plan.mechanism == want[0]
    assert plan.blocks == want[1]
    assert (plan.axes["core"], plan.axes["cache"]) == want[2]
    assert MORE_AXES.get((arch, model), {}).items() <= plan.axes.items()
    assert plan.why.startswith({"tensor": "tensor parallelism",
                                "per-leaf": "per-leaf partition"}[want[0]])
    assert sharding_mechanism(cfg, 1).mechanism == "replicated"
    # a weight block splits where param_spec splits every leaf of it that
    # a rule cuts (those it cuts at model 1; a GELU FFN's b_down is
    # whole), on the full-width tree's shapes (fake tensors); gshard's
    # experts split as moe_dense's do, and no plan says they have no
    # split form
    with FakeTensorMode():
        shapes = build_model(cfg).init(
            torch.Generator(device="cpu").manual_seed(0), device="meta")
    blocks = BLOCK_LEAVES.get(cfg.family, {
        "embed": r"^embed$", "unembed": r"^unembed$",
        "attn": r"^layers/attn/", "mlp": r"^layers/ffn/",
        "experts": r"^layers/moe/w_"})
    for block, pat in blocks.items():
        specs = [param_spec(path, tuple(a.shape), model)
                 for path, a in param_leaves(shapes)
                 if re.search(pat, path)
                 and param_spec(path, tuple(a.shape), 1)]
        if block not in plan.blocks:
            assert not specs or block == "unembed", block
            continue
        split = bool(specs) and all("model" in sp for sp in specs)
        assert (plan.blocks[block] == S) == split, block
    assert "no expert-split form" not in plan.why


def test_plan_modes_follow_the_dims():
    """A decoder whose d_ff and vocab do not divide gathers its MLP and
    vocab; whose every weight dim fails gathers everything (its core
    still splits); the dense MoE splits its experts."""
    odd = get_config("smollm-360m").reduced(num_heads=3, num_kv_heads=1,
                                            d_ff=511, vocab_size=511)
    p = sharding_mechanism(odd, 2)
    assert p.mechanism == "per-leaf"
    assert {b: p.blocks[b] for b in ("embed", "attn", "mlp", "unembed")} \
        == dict(embed=G, attn=S, mlp=G, unembed=G)
    none = dataclasses.replace(odd, head_dim=63)
    p = sharding_mechanism(none, 2)
    assert p.mechanism == "gather" and p.blocks["core"] == S
    assert p.blocks["cache"] == G and p.axes["cache"] == "none"
    dense_moe = get_config("qwen3-moe-30b-a3b")
    assert sharding_mechanism(dense_moe, 2).mechanism == "tensor"
    assert sharding_mechanism(dense_moe, 16).blocks["experts"] == S


# --------------------------------------------------------------------------
# A data x model group of ranks, each a thread of this process
# --------------------------------------------------------------------------
class ThreadRank:
    """One rank of a (data, model) layout whose groups are gloo groups
    between threads of this process: what ``ShardedTrainStep`` and
    ``launch.cases`` read of a ``TrainMesh``."""

    def __init__(self, store, rank, data, model):
        self.rank, self.size = rank, data * model
        self.data, self.model = data, model
        self.d, self.m = divmod(rank, model)
        self.device = torch.device("cpu")
        self.axis_names = ("data", "model")

        def group(name, r, n):
            if n == 1:
                return None
            pg = mesh_mod._gloo(dist.PrefixStore(name, store), r, n)
            return mesh_mod.Collectives(pg, r, n)
        self.model_group = group(f"model/{self.d}", self.m, model)
        self.data_group = group(f"data/{self.m}", self.d, data)

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def coords(self):
        return {"data": self.d, "model": self.m}

    def zero(self):
        for g in (self.model_group, self.data_group):
            if g is not None:
                g.coll_calls = 0

    def calls(self, axis):
        g = self.model_group if axis == "model" else self.data_group
        return 0 if g is None else g.coll_calls


def _threads(n, fn):
    out, errors = [None] * n, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:     # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        assert not t.is_alive(), "a rank did not finish in 600 s"
    if errors:
        raise errors[0]
    return out


def make_ranks(data, model):
    store = dist.HashStore()
    return _threads(data * model,
                    lambda r: ThreadRank(store, r, data, model))


@pytest.fixture(scope="module")
def ranks22():
    return make_ranks(2, 2)


@pytest.fixture(scope="module")
def ranks12():
    return make_ranks(1, 2)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return {k: _clone(v) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    want = want.detach()
    err = float((got.detach() - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), (
        err, tuple(want.shape))


# --------------------------------------------------------------------------
# The hand count: each program's collectives on the model group, from the
# code of models/ (per layer: attention's q/k/v gather, its pair gather
# or, in a decode, its score all-reduce and head-dim gather (a kv-head
# split: its heads' gather), wo's all-reduce — under tensor parallelism
# (whole heads a rank) wo's all-reduce only; the FFN's all-reduce; the
# split MoE's one f32 all-reduce of its combined output; a gathered
# block's split leaves; the vocab-split embedding's all-reduce and the
# logits' gather (a train step's loss keeps them split); under autograd
# each copy_to_tp is an all-reduce in backward, and remat runs each
# layer's forward again up to the last tensor its backward needs)
# --------------------------------------------------------------------------
def _hand_count(cfg, plan, kind, model=2):
    if cfg.family in FAMILY_COUNTS:
        return FAMILY_COUNTS[cfg.family](cfg, plan, kind, model)
    L, dh = cfg.num_layers, cfg.head_dim
    H, Hkv = cfg.num_heads * dh, cfg.num_kv_heads * dh
    blocks = plan.blocks
    if plan.mechanism == "tensor":
        # wo's all-reduce; backward: x into the q/k/v columns; the core
        # and the cache on the rank's heads move nothing
        fwd, bwd = 1, 1
    else:
        if blocks["attn"] == S:
            # q/k/v gather and wo all-reduce; backward: x into the
            # columns, q/k/v into the core, o into wo's rows
            fwd, bwd = 2, 3
        else:
            # each split leaf (wq, wk, wv, wo) gathered; backward: q/k/v
            # into the core
            fwd, bwd = sum(n % model == 0 for n in (H, Hkv, Hkv, H)), 1
        fwd += ({"head_dim": 2, "kv heads": 1, "none": 0}[
            plan.axes["cache"]] if kind == "decode" else 1)
    mlp = blocks.get("mlp") == S
    experts = blocks.get("experts") == S
    # the split MoE: its f32 all-reduce; backward: the rows and the
    # combine weights, each through copy_to_tp
    fwd += (1 if mlp else 0) + (1 if experts else 0)
    bwd += (1 if mlp else 0) + (2 if experts else 0)
    vocab = blocks["embed"] == S
    if kind != "train":
        # the embedding's all-reduce, the logits' gather
        return L * fwd + (2 if vocab else 0)
    # remat's second forward stops at the last tensor backward needs
    # (torch.utils.checkpoint's early stop): the layer's last all-reduce
    # (the FFN's, or the MoE's where no FFN follows it), whose output
    # nothing saves, is not run again
    again = fwd - (1 if mlp or experts else 0)
    # the loss keeps vocab-split logits split: no logits gather, but the
    # rows' maxima gathered and two all-reduces (the sum of exponentials,
    # the gold logit); the logits' copy_to_tp in backward; the global
    # norm's all-reduce
    vocab_loss = (1 + 3 + 1) if vocab else 0
    return L * (fwd + again + bwd) + vocab_loss + 1


def _rwkv_count(cfg, plan, kind, model):
    """rwkv6 with every block split: a layer's forward makes ``w_o``'s
    all-reduce, the channel mix's gate all-gather and ``k @ cw_v``'s
    all-reduce; a decode step first gathers the state's two token-shift leaves
    (one all-gather each); the vocab-split embedding's all-reduce and the
    logits' gather close a serving pass. A train step: remat reruns each layer
    whole (the channel mix's product saves its all-reduced operand); backward
    adds a ``copy_to_tp`` all-reduce a block (the time mix's input, the channel
    mix's two lerps stacked) and the logits'; the vocab-parallel loss's three;
    the global norm's; the sum
    of ``TMIX_SHARED``'s gradients."""
    assert set(plan.blocks.values()) == {S}, plan.blocks
    L = cfg.num_layers
    if kind == "prefill":
        return 3 * L + 2
    if kind == "decode":
        return 3 * L + 2 + 2
    return L * (3 + 3 + 2) + 1 + 1 + 3 + 1 + 1


def _zamba_count(cfg, plan, kind, model):
    """zamba2: a split Mamba2 block makes four collectives forward (the
    projection's columns joined, the conv's channels joined, the gated
    norm's sum of squares, ``w_out``'s all-reduce) and four ``copy_to_tp``
    all-reduces backward; a gathered one gathers each of its split leaves at
    its use, and a decode step gathers its conv and SSD state leaves once where
    they are split. The shared block runs the decoders' per-leaf attention (3
    forward, a decode's on kv heads 3, backward 3) and FFN (1, backward 1). A
    train step's remat reruns a group up to the last tensor its backward needs:
    the shared FFN's all-reduce is not rerun (its output only feeds the
    residual); without a split FFN the attention's is. Then the vocab-parallel
    loss, the global norm and
    the sum of ``MAMBA_SHARED``'s gradients."""
    A, L = cfg.attn_every, cfg.num_layers
    groups = L // A
    b = plan.blocks
    assert b["attn"] == S and plan.axes["cache"] == "kv heads", plan
    leaves = [n for n, (d, w) in mamba2.split_widths(cfg).items()
              if w % model == 0]
    if b["mamba"] == S:
        m_fwd, m_bwd, states = 4, 4, 0
    else:
        d_inner, H, P, N = mamba2.dims(cfg)
        states = sum(any(n % model == 0 for n in dims) for dims in (
            (mamba2.CONV_K - 1, d_inner + 2 * N), (H, P, N)))
        m_fwd, m_bwd = len(leaves), 0
    mlp = 1 if b["mlp"] == S else 0
    vocab = b["embed"] == S
    assert (b["unembed"] == S) == vocab
    shared_fwd = 3 + mlp
    if kind != "train":
        return (groups * (A * m_fwd + shared_fwd) + (2 if vocab else 0)
                + (states if kind == "decode" else 0))
    fwd = groups * (A * m_fwd + shared_fwd)
    again = groups * (A * m_fwd + shared_fwd - mlp)
    bwd = groups * (A * m_bwd + 3 + mlp)
    loss = (1 + 1 + 3) if vocab else 0     # embed, logits' copy, loss
    return fwd + again + bwd + loss + 1 + (1 if b["mamba"] == S else 0)


def _whisper_count(cfg, plan, kind, model):
    """whisper: under tensor parallelism an encoder layer makes ``wo``'s
    and the FFN's all-reduce (backward: x into q / k / v, x into the
    FFN), a decoder layer the self-attention's, the cross-attention's
    and the FFN's (backward: x into the self q / k / v, into the cross
    q and the encoder output into its k / v, into the FFN); a prefill
    adds a gather of the cross K/V heads where the cache splits on the
    encoder's frames. Under the per-leaf plan each attention gathers q /
    k / v (the cross one its q and its k / v apart), gathers its pairs
    and all-reduces ``wo``'s product (backward: x into the columns, q /
    k / v into the core, o into ``wo``'s rows). A decode step: the self
    core on kv heads gathers its heads (on the head dim: the scores'
    all-reduce, the columns' gather), the cross core on the frames
    gathers every head's q (tensor) and merges the shares by one
    all-gather. The tied embedding: the lookup's all-reduce and the
    logits' gather where V splits (a train step: the vocab-parallel
    loss's three and the logits' copy). Remat reruns a decoder layer
    but its FFN's all-reduce; the global norm closes a step."""
    Le, L = cfg.encoder_layers, cfg.num_layers
    b, axes = plan.blocks, plan.axes
    assert all(b[k] == S for k in ("attn", "cross_attn", "mlp")), b
    vocab = b["embed"] == S
    tensor = plan.mechanism == "tensor"
    seq = axes["cross"] == "seq"
    if tensor:
        enc_f, enc_b = 2, 2
        dec_f, dec_b = 3, 4
        pre = 1 if seq else 0
        dec_self = 1 if axes["cache"] == "kv heads" else None
        cross_dec = 3 if seq else 1
    else:
        enc_f, enc_b = 4, 4
        dec_f, dec_b = 8, 9
        pre = 0
        dec_self = {"kv heads": 3, "head_dim": 4}[axes["cache"]]
        cross_dec = {"seq": 3, "kv heads": 3, "head_dim": 4}[axes["cross"]]
    if kind == "prefill":
        return Le * enc_f + L * (dec_f + pre) + (2 if vocab else 0)
    if kind == "decode":
        return L * (dec_self + cross_dec + 1) + (2 if vocab else 0)
    fwd = Le * enc_f + L * dec_f
    again = L * (dec_f - 1)
    bwd = Le * enc_b + L * dec_b
    loss = (1 + 1 + 3) if vocab else 0
    return fwd + again + bwd + loss + 1


FAMILY_COUNTS = {"ssm": _rwkv_count, "hybrid": _zamba_count,
                 "encdec": _whisper_count}


# --------------------------------------------------------------------------
# Sharded == unsharded at (data 2, model 2)
# --------------------------------------------------------------------------
def _extras(cfg):
    """A family's prefill inputs beside the tokens: whisper's encoder
    frames [B, S_enc, D], drawn from a seed."""
    if cfg.family != "encdec":
        return {}
    return {"audio_embeds": torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}


def _unsharded(cfg):
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    whole = _clone(params)
    step = make_train_step(model, OPT, remat=True)
    opt = init_adamw(params)
    it = iter(TokenStream(cfg, DATA))
    hist = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, batch_to(next(it), "cpu"))
        hist.append({k: float(v) for k, v in m.items()})
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, T), dtype=np.int32))
    extras = _extras(cfg)
    with torch.no_grad():
        logits, cache = model.prefill(whole, tokens, cache_len=CACHE,
                                      **extras)
        token = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (B,), dtype=np.int32))
        pos = torch.full((B,), T, dtype=torch.int32)
        dec_cache = tree_map(torch.clone, cache)
        dec_logits, dec_cache = model.decode_step(whole, dec_cache, token,
                                                  pos)
    return dict(whole=whole, hist=hist, params=params, tokens=tokens,
                extras=extras, logits=logits, cache=cache, token=token,
                pos=pos, dec_logits=dec_logits, dec_cache=dec_cache)


def _rank_run(mesh, cfg, ref, kinds):
    """One rank's programs: the train step (STEPS steps), the prefill
    and one decode step; their results, collective counts and the
    all-gathers of a weight leaf (``gathered_leaves``: the shapes)."""
    out = {}
    model = build_model(cfg)
    step = make_sharded_train_step(model, OPT, mesh, remat=True)
    params = step.shard(_clone(ref["whole"]))
    out["plan"] = step.plan
    if "train" in kinds:
        p, opt = step.shard(_clone(ref["whole"])), None
        opt = init_adamw(p)
        it = iter(TokenStream(cfg, DATA))
        hist, counts = [], []
        with dryrun.weight_gathers(mesh.model_group, p) as found:
            for _ in range(STEPS):
                mesh.zero()
                p, opt, m = step(p, opt, next(it))
                counts.append((mesh.calls("model"), mesh.calls("data")))
                hist.append({k: float(v) for k, v in m.items()})
        out.update(hist=hist, train_counts=counts, gathered=step.gather(p),
                   gathered_leaves=found)
    with dryrun.weight_gathers(mesh.model_group, params) as found:
        _serve_run(mesh, cfg, ref, kinds, step, params, out)
    out["gathered_leaves"] = out.get("gathered_leaves", []) + found
    return out


def _serve_run(mesh, cfg, ref, kinds, step, params, out):
    """:func:`_rank_run`'s prefill and decode step, into ``out``."""
    if "prefill" in kinds:
        rows = step.rows({"tokens": ref["tokens"], **ref.get("extras", {})})
        tokens = rows.pop("tokens")
        mesh.zero()
        with torch.no_grad():
            logits, cache = step.model.prefill(params, tokens,
                                               cache_len=CACHE, **rows)
        out.update(logits=logits, cache=cache,
                   prefill_counts=(mesh.calls("model"), mesh.calls("data")))
    if "decode" in kinds:
        whole = ref["cache"]
        specs = cache_shardings(whole, mesh, batch_size=B, cache_seq=CACHE)
        cache = _zip_map(lambda a, s: local_shard(a, s, mesh).clone(),
                         whole, specs)
        rows = step.rows({"token": ref["token"], "pos": ref["pos"]})
        mesh.zero()
        with torch.no_grad():
            dl, cache = step.model.decode_step(params, cache, rows["token"],
                                               rows["pos"])
        out.update(dec_logits=dl, dec_cache=cache, specs=specs,
                   decode_counts=(mesh.calls("model"), mesh.calls("data")))


@pytest.fixture(scope="module")
def ranks13():
    return make_ranks(1, 3)


@pytest.fixture(scope="module")
def runs(ranks22, ranks13):
    out = {}
    for case, (_, _, layout) in CASES.items():
        cfg = _cfg(case)
        ref = _unsharded(cfg)
        ranks = ranks22 if layout == (2, 2) else ranks13
        res = _threads(len(ranks), lambda r: _rank_run(
            ranks[r], cfg, ref, ("train", "prefill", "decode")))
        out[case] = (cfg, ref, ranks, res)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_equals_unsharded(runs, case):
    cfg, ref, ranks, res = runs[case]
    plan = res[0]["plan"]
    model = ranks[0].model
    # at model 3 no weight block splits whole (the mechanism says
    # "gather"), but wq / wo are split and gathered at use; the reduced
    # qwen3-moe's dims all divide 2 (tensor parallelism)
    assert plan.mechanism == ("gather" if model == 3 else "tensor"
                              if cfg.num_experts else "per-leaf")
    for r in res:
        for h, want in zip(r["hist"], ref["hist"]):
            for k in ("loss", "xent", "grad_norm", "lr"):
                assert h[k] == pytest.approx(want[k], rel=TOL, abs=1e-9), k
    assert res[0]["gathered"] is not None
    for a, b in zip(tree_leaves(res[0]["gathered"]),
                    tree_leaves(ref["params"])):
        _close(a, b)
    want = _hand_count(cfg, plan, "train", model)
    for r in res:
        assert [c[0] for c in r["train_counts"]] == [want] * STEPS
        # the data group: the xent's count, the gradient sum (one dtype a
        # collective: f32 weights, and the f32 router beside them), the
        # xent; the MoE's aux statistics twice a layer, in remat twice
        data = 0 if ranks[0].data == 1 else 3 + (
            4 * cfg.num_layers if cfg.num_experts else 0)
        assert [c[1] for c in r["train_counts"]] == [data] * STEPS


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_equal_unsharded(runs, case):
    """Each rank's logits (its rows) and cache slices (its rows on data,
    its kv heads or head dim on model as ``cache_shardings`` lays them
    out; whole at model 3, where neither divides)."""
    cfg, ref, ranks, res = runs[case]
    plan = res[0]["plan"]
    n = B // ranks[0].data
    for r, mesh in zip(res, ranks):
        rows = slice(mesh.d * n, (mesh.d + 1) * n)
        _close(r["logits"], ref["logits"][rows])
        _close(r["dec_logits"], ref["dec_logits"][rows])
        for key, whole in (("cache", ref["cache"]),
                           ("dec_cache", ref["dec_cache"])):
            for got, want, spec in zip(r[key], whole, r["specs"]):
                want = local_shard(want, spec, mesh)
                assert got.shape == want.shape
                _close(got, want)
        axis = plan.axes["cache"]
        assert r["specs"].k == ((None, "data", None, None, "model")
                                if axis == "head_dim" else
                                (None, "data", None, "model", None)
                                if axis == "kv heads" else
                                (None, "data", None, None, None))
        model = ranks[0].model
        assert r["prefill_counts"] == (
            _hand_count(cfg, plan, "prefill", model), 0)
        assert r["decode_counts"] == (
            _hand_count(cfg, plan, "decode", model), 0)


# --------------------------------------------------------------------------
# Against the reference's GSPMD step at (1, 2)
# --------------------------------------------------------------------------
def _gspmd(jcfg, jmodel, jparams):
    mesh = jmesh.make_host_mesh(model=2)
    with mesh:
        params = jax.device_put(jparams, jsh.param_shardings(jparams, mesh))
        opt = jopt.init_adamw(params)
        step = jax.jit(jtrainer.make_train_step(jmodel, jopt.AdamWConfig(
            lr=OPT.lr, eps=OPT.eps, warmup_steps=OPT.warmup_steps,
            total_steps=OPT.total_steps)))
        it = iter(JaxStream(jcfg, JaxDataConfig(batch_size=B, seq_len=T)))
        hist = []
        for _ in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in next(it).items()}
            params, opt, m = step(params, opt, batch)
            hist.append({k: float(v) for k, v in m.items()})
    return hist, jax.tree.map(np.asarray, params)


def test_sharded_step_matches_reference_gspmd(ranks12):
    jcfg = jax_get_config("smollm-360m").reduced(**ODD_HEADS)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    arrays = jax.tree.map(np.asarray, jparams)
    jhist, jwant = _gspmd(jcfg, jmodel, jparams)
    cfg = get_config("smollm-360m").reduced(**ODD_HEADS)
    whole = bridge.params_from_numpy(arrays, cfg, device="cpu")

    def run(r):
        mesh = ranks12[r]
        step = make_sharded_train_step(build_model(cfg), OPT, mesh,
                                       remat=True)
        p = step.shard(_clone(whole))
        opt = init_adamw(p)
        it = iter(TokenStream(cfg, DATA))
        hist = []
        for _ in range(STEPS):
            p, opt, m = step(p, opt, next(it))
            hist.append({k: float(v) for k, v in m.items()})
        return step.mechanism, hist, step.gather(p)
    res = _threads(2, run)
    assert [r[0] for r in res] == ["per-leaf"] * 2
    for h, want in zip(res[0][1], jhist):
        for k in ("loss", "lr", "grad_norm"):
            assert h[k] == pytest.approx(want[k], rel=REF_TOL, abs=1e-9), k
    got = res[0][2]
    for path, want in jax.tree_util.tree_leaves_with_path(jwant):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        err = float(np.abs(leaf.numpy() - want).max())
        assert err <= REF_TOL * max(1.0, float(np.abs(want).max())), (
            path, err)


# --------------------------------------------------------------------------
# The dry run on the plan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,batch,seq", [
    ("train_4k", 4, 16), ("prefill_32k", 4, 16), ("decode_32k", 4, 16)])
def test_dryrun_rank_runs_the_plan(shape, batch, seq):
    """The first config at (data 2, model 2) traced under fake tensors:
    the row carries the per-leaf plan, the recorded collectives on the
    model group are the hand count, the traced FLOPs are within 2x of
    the analytic share (the gathered whole model was ~2x the share at
    model 2, 16x at 16)."""
    cfg = dataclasses.replace(adjusted_config("smollm-360m", shape),
                              **{k: v for k, v in dataclasses.asdict(
                                  get_config("smollm-360m").reduced(
                                      **ODD_HEADS)).items()
                                 if k in ("num_layers", "d_model",
                                          "num_heads", "num_kv_heads",
                                          "head_dim", "d_ff", "vocab_size",
                                          "max_position", "name")})
    layout = Layout({"data": 2, "model": 2})
    row = dryrun.run_case("smollm-360m", shape, False, verbose=False,
                          layout=layout, cfg=cfg, batch=batch, seq=seq)
    assert row["status"] == "ok", row.get("error")
    assert row["mechanism"] == "per-leaf"
    assert row["plan"] == DECODER
    assert row["plan_axes"] == {"core": "pairs", "cache": "head_dim"}
    from repro_torch.launch.cases import build_case
    case = build_case("smollm-360m", shape, layout, cfg=cfg, batch=batch,
                      seq=seq)
    traced = dryrun.trace_case(case)
    kind = {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode"}[shape]
    on_model = [r for r in traced["records"] if r["name"].startswith(
        "model/")]
    assert len(on_model) == _hand_count(cfg, case.plan, kind, 2)
    assert row["flops_hlo_per_chip"] <= 2 * row["flops_per_chip"]


def test_a_real_rank_counts_what_its_trace_counts(ranks12):
    """A rank's program run on real tensors over a real group
    (``dryrun.run_rank``, the card phase's job) counts in its warm run,
    under ``FlopCounterMode`` and ``dryrun.Traffic``, exactly the FLOPs
    and bytes of its trace at the same layout, and its collectives on the
    model group are the trace's records: the group's own staging copies
    are no op of the program. On the CPU the attention takes its plain
    forms where the trace takes the card's, so the config's head dim
    (32) is one no kernel takes: both run the plain paths."""
    from repro_torch.launch.cases import build_case
    cfg = get_config("smollm-360m").reduced(head_dim=32, **ODD_HEADS)
    layout = Layout({"data": 1, "model": 2})
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        fake = build_case("smollm-360m", shape, layout, cfg=cfg, batch=2,
                          seq=16)
        traced = dryrun.trace_case(fake)
        got = _threads(2, lambda r: dryrun.run_rank(
            ranks12[r], "smollm-360m", shape, batch=2, seq=16, runs=1,
            cfg=cfg))
        for r in got:
            assert r["mechanism"] == "per-leaf" and r["warm"]["finite"]
            assert r["warm"]["collectives"] == {"model": len(
                traced["records"])}
            assert r["collectives"]["model"][0] == len(traced["records"])
        assert (got[0]["warm"]["flops"], got[0]["warm"]["bytes"]) == (
            traced["flops"], traced["bytes"]), shape


def test_rank_prefill_decode_equals_unsharded(ranks12):
    """The card phase's job for outputs (``cases.rank_prefill_decode``)
    at (1, 2): each rank's prefill logits and cache slice, and its decode
    step's, equal the unsharded model's on the same weights (drawn from
    the seed) within ``TOL``."""
    from repro_torch.launch.cases import rank_prefill_decode
    cfg = get_config("smollm-360m").reduced(**ODD_HEADS)
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, T), dtype=np.int32))
    token = tokens[:, -1].clone()
    pos = torch.full((B,), T, dtype=torch.int32)
    with torch.no_grad():
        logits, cache = model.prefill(params, tokens, cache_len=CACHE)
        first = KVCache(cache.k.clone(), cache.v.clone())
        dl, cache = model.decode_step(params, cache, token, pos)
    got = _threads(2, lambda r: rank_prefill_decode(
        ranks12[r], cfg, 3, tokens, CACHE, token, pos))
    dh = cfg.head_dim // 2
    for r in got:
        cols = slice(r["rank"] * dh, (r["rank"] + 1) * dh)
        assert r["mechanism"] == "per-leaf"
        _close(r["logits"], logits)
        _close(r["decode_logits"], dl)
        for a, b in zip(r["cache"], first):
            _close(a, b[..., cols])
        for a, b in zip(r["decode_cache"], cache):
            _close(a, b[..., cols])


def test_context_parallel_decode_on_a_head_dim_split_ring(ranks22):
    """``long_500k``'s form at (data 2, model 2): one row's window ring
    split on its sequence over data and on its head dim over model; the
    partial scores all-reduce over model inside each data shard, the
    shards merge by log-sum-exp. Each rank's logits and ring slice after
    a decode step equal the unsharded step's within ``TOL``."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(**ODD_HEADS),
                              sliding_window=16)
    model = build_model(cfg)
    whole = model.init(4, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 21), dtype=np.int32))
    token, pos = tokens[:, -1].clone(), torch.full((1,), 20,
                                                   dtype=torch.int32)
    with torch.no_grad():
        _, ring = model.prefill(whole, tokens[:, :20], cache_len=64)
        before = KVCache(ring.k.clone(), ring.v.clone())
        want, ring = model.decode_step(whole, ring, token, pos)
    S, d = 16 // 2, cfg.head_dim // 2

    def run(r):
        mesh = ranks22[r]
        step = make_sharded_train_step(model, OPT, mesh)
        params = step.shard(_clone(whole))
        rows = slice(mesh.d * S, (mesh.d + 1) * S)
        cols = slice(mesh.m * d, (mesh.m + 1) * d)
        cache = KVCache(*(a[:, :, rows, :, cols].clone() for a in before))
        with torch.no_grad():
            got, cache = step.model.decode_step(params, cache, token, pos,
                                                seq_group=mesh.data_group)
        return got, cache, rows, cols
    for got, cache, rows, cols in _threads(4, run):
        _close(got, want)
        for a, b in zip(cache, ring):
            _close(a, b[:, :, rows, :, cols])
