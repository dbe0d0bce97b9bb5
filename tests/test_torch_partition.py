"""The per-leaf partition of a rank's program (``training.trainer.
sharding_mechanism``'s :class:`Plan`), f32 on the CPU.

* **The plan** of every config at model 2 and 16: each block's mode
  (split, or gathered at its use), where the core and the decode cache
  split, and the mechanism.
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
from repro_torch.core.migration import tree_leaves  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.cases import adjusted_config  # noqa: E402
from repro_torch.launch.mesh import Layout  # noqa: E402
from repro_torch.launch.shardings import (cache_shardings,  # noqa: E402
                                          local_shard, param_leaves,
                                          param_spec)
from repro_torch.models import build_model  # noqa: E402
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
WHOLE = ("gather", {"model": G}, {})
# arch -> {model: (mechanism, blocks, axes)}; MoE archs under gshard (the
# dry run's impl)
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
    "rwkv6-7b": {2: WHOLE, 16: WHOLE},
    "zamba2-2.7b": {2: WHOLE, 16: WHOLE},
    "whisper-large-v3": {2: WHOLE, 16: WHOLE},
}


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
    if want[0] == "gather":
        assert plan.axes == {}
        assert "no tensor-parallel forward" in plan.why
    else:
        assert (plan.axes["core"], plan.axes["cache"]) == want[2]
        assert plan.why.startswith({"tensor": "tensor parallelism",
                                    "per-leaf": "per-leaf partition"}[
            want[0]])
    assert sharding_mechanism(cfg, 1).mechanism == "replicated"
    if want[0] == "gather":
        return
    # a weight block splits where param_spec splits every leaf of it that
    # a rule cuts (those it cuts at model 1; a GELU FFN's b_down is
    # whole), on the full-width tree's shapes (fake tensors); gshard's
    # experts split as moe_dense's do, and no plan says they have no
    # split form
    with FakeTensorMode():
        shapes = build_model(cfg).init(
            torch.Generator(device="cpu").manual_seed(0), device="meta")
    blocks = {"embed": r"^embed$", "unembed": r"^unembed$",
              "attn": r"^layers/attn/", "mlp": r"^layers/ffn/",
              "experts": r"^layers/moe/w_"}
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


# --------------------------------------------------------------------------
# Sharded == unsharded at (data 2, model 2)
# --------------------------------------------------------------------------
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
    with torch.no_grad():
        logits, cache = model.prefill(whole, tokens, cache_len=CACHE)
        token = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (B,), dtype=np.int32))
        pos = torch.full((B,), T, dtype=torch.int32)
        dec_cache = KVCache(cache.k.clone(), cache.v.clone())
        dec_logits, dec_cache = model.decode_step(whole, dec_cache, token,
                                                  pos)
    return dict(whole=whole, hist=hist, params=params, tokens=tokens,
                logits=logits, cache=cache, token=token, pos=pos,
                dec_logits=dec_logits, dec_cache=dec_cache)


def _rank_run(mesh, cfg, ref, kinds):
    """One rank's programs: the train step (STEPS steps), the prefill
    and one decode step; their results and collective counts."""
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
        for _ in range(STEPS):
            mesh.zero()
            p, opt, m = step(p, opt, next(it))
            counts.append((mesh.calls("model"), mesh.calls("data")))
            hist.append({k: float(v) for k, v in m.items()})
        out.update(hist=hist, train_counts=counts, gathered=step.gather(p))
    if "prefill" in kinds:
        tokens = step.rows({"tokens": ref["tokens"]})["tokens"]
        mesh.zero()
        with torch.no_grad():
            logits, cache = step.model.prefill(params, tokens,
                                               cache_len=CACHE)
        out.update(logits=logits, cache=cache,
                   prefill_counts=(mesh.calls("model"), mesh.calls("data")))
    if "decode" in kinds:
        whole = ref["cache"]
        specs = cache_shardings(whole, mesh, batch_size=B, cache_seq=CACHE)
        cache = KVCache(*(local_shard(a, s, mesh).clone()
                          for a, s in zip(whole, specs)))
        rows = step.rows({"token": ref["token"], "pos": ref["pos"]})
        mesh.zero()
        with torch.no_grad():
            dl, cache = step.model.decode_step(params, cache, rows["token"],
                                               rows["pos"])
        out.update(dec_logits=dl, dec_cache=cache, specs=specs,
                   decode_counts=(mesh.calls("model"), mesh.calls("data")))
    return out


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
