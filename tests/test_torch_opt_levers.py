"""The reference's beyond-paper levers in a rank's program
(``launch.cases.build_case(optimized=True)``, ``models.common.Levers``)
against the baseline program, f32 on the CPU, on (data 2, model 2) gloo
groups between threads of this process (``test_torch_partition``'s
``ThreadRank``).

* **Optimized == baseline** for the reduced smollm with 3 heads / 1 kv
  head (the per-leaf plan: its decode cache goes on the sequence), the
  reduced llama (tensor parallelism: its cache stays on kv heads), the
  reduced qwen3-moe under ``moe_gshard`` with 2-D experts forced on, and
  rwkv6, zamba2 and whisper: two AdamW steps (remat) — the metrics, the
  params and both moments gathered — within ``TOL`` = 1e-5 of the
  largest magnitude; the prefill's logits and cache slices; a decode's
  logits and cache slice, the latter equal to the baseline's cache cut by
  ``cache_shardings(seq_on_model=True)``.
* **Collectives**: each lever's counts on the model and data groups
  equal the baseline's plus the hand count (train without remat, whose
  recompute would stop at the last tensor backward needs).
* **ZeRO-1 bytes**: a rank's moments are ``1 / data`` of the
  baseline's wherever a dim divides.
* **Every case traces**: each arch × shape's optimized case at (2, 2)
  on its reduced config, its row listing the levers the rule picks.
* **Against the reference**: the optimized (1, 2) train step of the
  reduced smollm against the reference's GSPMD step with its levers
  (``act_shard``, ZeRO-1 moments) within ``REF_TOL`` = 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

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
from repro_torch.launch.cases import (SHAPES, _pairs,  # noqa: E402
                                      _zip_map, adjusted_config,
                                      choose_levers, shape_kind, skip_reason)
from repro_torch.launch.mesh import Layout  # noqa: E402
from repro_torch.launch.shardings import (cache_shardings,  # noqa: E402
                                          local_shard)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import Levers  # noqa: E402
from repro_torch.training.data import TokenStream  # noqa: E402
from repro_torch.training.trainer import (make_sharded_train_step,  # noqa: E402
                                          sharding_mechanism)
from test_torch_partition import (B, CACHE, DATA, ODD_HEADS, OPT,  # noqa: E402
                                  REF_TOL, STEPS, T, TOL, _clone, _close,
                                  _threads, _unsharded, make_ranks)

# case -> (arch, reduced(**over), gshard, 2-D experts forced on)
CASES = {"pairs": ("smollm-360m", ODD_HEADS, False),
         "tensor": ("llama3.2-3b", {}, False),
         "moe-2d": ("qwen3-moe-30b-a3b", {}, True),
         "rwkv6": ("rwkv6-7b", {}, False),
         "zamba2": ("zamba2-2.7b", {}, False),
         "whisper": ("whisper-large-v3", {}, False)}
KINDS = ("train", "prefill", "decode")


def _cfg(case):
    arch, over, _ = CASES[case]
    cfg = get_config(arch).reduced(**over)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_impl="gshard")
    return cfg


def _levers(case, cfg, kind, seq_cache=False):
    """The case's levers for ``kind`` at model 2 (:func:`choose_levers`),
    with the MoE case's 2-D experts forced on."""
    lv = choose_levers(cfg, kind, 2, seq_cache)
    return lv._replace(expert_2d=True) if CASES[case][2] else lv


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks22():
    return make_ranks(2, 2)


def _counts(mesh):
    return (mesh.calls("model"), mesh.calls("data"))


def _train(mesh, cfg, whole, levers, remat):
    step = make_sharded_train_step(build_model(dataclasses.replace(
        cfg, levers=levers)), OPT, mesh, remat=remat)
    p = step.shard(_clone(whole))
    opt = step.init_moments(p)
    shapes = [tuple(a.shape) for a in tree_leaves(opt.mu)]
    it = iter(TokenStream(cfg, DATA))
    hist, counts = [], []
    for _ in range(STEPS):
        mesh.zero()
        p, opt, m = step(p, opt, next(it))
        counts.append(_counts(mesh))
        hist.append({k: float(v) for k, v in m.items()})
    return dict(hist=hist, counts=counts, moment_shapes=shapes,
                params=step.gather(p), mu=step.gather(opt.mu, True),
                nu=step.gather(opt.nu, True))


def _serve(mesh, cfg, ref, levers, kind):
    step = make_sharded_train_step(build_model(dataclasses.replace(
        cfg, levers=levers)), OPT, mesh)
    params = step.shard(_clone(ref["whole"]))
    if kind == "prefill":
        rows = step.rows({"tokens": ref["tokens"], **ref["extras"]})
        tokens = rows.pop("tokens")
        mesh.zero()
        with torch.no_grad():
            logits, cache = step.model.prefill(params, tokens,
                                               cache_len=CACHE, **rows)
        return dict(logits=logits, cache=cache, counts=_counts(mesh))
    seq = bool(levers and levers.seq_cache)
    specs = cache_shardings(ref["cache"], mesh, batch_size=B,
                            cache_seq=CACHE, seq_on_model=seq)
    cache = _zip_map(lambda a, s: local_shard(a, s, mesh).clone(),
                     ref["cache"], specs)
    rows = step.rows({"token": ref["token"], "pos": ref["pos"]})
    mesh.zero()
    with torch.no_grad():
        logits, cache = step.model.decode_step(params, cache, rows["token"],
                                               rows["pos"])
    want = _zip_map(lambda a, s: local_shard(a, s, mesh), ref["dec_cache"],
                    specs)
    return dict(logits=logits, cache=cache, want=want, specs=specs,
                counts=_counts(mesh))


def _seq_cache(cfg, mesh_like):
    """Whether the rule lays the decode KV's sequence on ``model`` (a
    5-d leaf of ``CACHE`` rows whose spec has ``model`` there)."""
    whole = build_model(cfg).init_cache(B, CACHE, device="meta")
    specs = cache_shardings(whole, mesh_like, batch_size=B, cache_seq=CACHE,
                            seq_on_model=True)
    return cfg.num_heads > 0 and any(
        a.dim() == 5 and a.shape[2] == CACHE and s[2] == "model"
        for a, s in _pairs(whole, specs))


@pytest.fixture(scope="module")
def runs(ranks22):
    out = {}
    layout = ranks22[0]
    for case in CASES:
        cfg = _cfg(case)
        ref = _unsharded(cfg)
        seq = _seq_cache(cfg, layout)
        res = {}
        for kind in KINDS:
            lv = _levers(case, cfg, kind, seq)
            for name, levers in (("base", None), ("opt", lv)):
                if kind == "train":
                    for remat in (True, False):
                        res[kind, name, remat] = _threads(
                            4, lambda r: _train(ranks22[r], cfg,
                                                ref["whole"], levers, remat))
                else:
                    res[kind, name] = _threads(4, lambda r: _serve(
                        ranks22[r], cfg, ref, levers, kind))
        out[case] = (cfg, ref, seq, res)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_optimized_train_equals_baseline(runs, case):
    cfg, ref, _, res = runs[case]
    base, opt = res["train", "base", True], res["train", "opt", True]
    for b, o in zip(base, opt):
        for hb, ho in zip(b["hist"], o["hist"]):
            for k in hb:
                assert ho[k] == pytest.approx(hb[k], rel=TOL, abs=1e-9), k
    for part in ("params", "mu", "nu"):
        got, want = tree_leaves(opt[0][part]), tree_leaves(base[0][part])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            _close(a, b)
    # and the unsharded run's params
    for a, b in zip(tree_leaves(opt[0]["params"]),
                    tree_leaves(ref["params"])):
        _close(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_optimized_prefill_and_decode_equal_baseline(runs, case):
    cfg, ref, seq, res = runs[case]
    n = B // 2
    for kind in ("prefill", "decode"):
        for r, (b, o) in enumerate(zip(res[kind, "base"],
                                       res[kind, "opt"])):
            _close(o["logits"], b["logits"])
            d = r // 2
            want = ref["logits" if kind == "prefill" else "dec_logits"]
            _close(o["logits"], want[d * n:(d + 1) * n])
            if kind == "prefill":
                for x, y in zip(tree_leaves(o["cache"]),
                                tree_leaves(b["cache"])):
                    assert x.shape == y.shape
                    _close(x, y)
            else:
                # the slice of the baseline's cache that the optimized
                # layout (cache_shardings(seq_on_model=True)) gives
                for x, y in zip(tree_leaves(o["cache"]),
                                tree_leaves(o["want"])):
                    assert x.shape == y.shape
                    _close(x, y)
    # the smollm case's KV goes on the sequence (Hkv 1 does not divide 2);
    # every other case's kv heads divide 2
    assert seq == (case == "pairs")
    if seq:
        assert res["decode", "opt"][0]["specs"].k == (
            None, "data", "model", None, None)


def _blocks(cfg):
    """Blocks a layer of ``cfg`` runs (each a gather along T and a
    reduce-scatter or slice under sequence parallelism), and the layers:
    zamba2's groups count their Mamba2 blocks and the shared block's
    two."""
    if cfg.family == "hybrid":
        g = cfg.num_layers // cfg.attn_every
        return g * (cfg.attn_every + 2)
    per = {"ssm": 2, "encdec": 3}.get(cfg.family, 2 + bool(
        cfg.num_experts and cfg.dense_residual))
    return per * cfg.num_layers


@pytest.mark.parametrize("case", list(CASES))
def test_each_lever_adds_its_hand_counted_collectives(runs, case):
    """Train without remat, per step, on (model, data): sequence
    parallelism adds two collectives a block (forward: the gather and
    the reduce-scatter or slice for one all-reduce or none; backward:
    likewise), the embedding's slice (its backward gather) and the final
    gather, and one all-reduce of the norms' gradients where the model
    group summed none before (rwkv6's channel mix also slices its gate to
    the rank's rows: a gather in backward); ZeRO-1 replaces the one gradient all-reduce
    by a reduce-scatter of every leaf (each has a dim 2 divides), an
    all-gather of the params and the norm's all-reduce over data; 2-D
    experts add a gather and a reduce-scatter of the dispatched rows a
    layer and their two adjoints. A prefill takes 2-D experts' two a
    layer; a decode on a sequence-split cache drops one collective a
    layer (the merge's gather for the scores' all-reduce and the columns'
    gather)."""
    cfg, _, seq, res = runs[case]
    base = res["train", "base", False][0]["counts"][0]
    opt = res["train", "opt", False][0]["counts"][0]
    plan = sharding_mechanism(cfg, 2)
    shared_before = (cfg.family in ("ssm", "hybrid")
                     and plan.blocks.get("tmix" if cfg.family == "ssm"
                                         else "mamba") == "split")
    model = 2 + 2 * _blocks(cfg) + (0 if shared_before else 1)
    if cfg.family == "ssm":     # the channel mix's gate sliced: a gather back
        model += cfg.num_layers
    experts = 4 * cfg.num_layers if CASES[case][2] else 0
    # ZeRO-1: the gradient all-reduce -> reduce-scatter + all-gather + the
    # norm's sum over the data axis
    data = 2 + experts
    assert opt == (base[0] + model, base[1] + data), (base, opt)
    for kind in ("prefill", "decode"):
        b, o = res[kind, "base"][0]["counts"], res[kind, "opt"][0]["counts"]
        ex = 2 * cfg.num_layers if CASES[case][2] else 0
        dm = -cfg.num_layers if (kind == "decode" and seq) else 0
        assert o == (b[0] + dm, b[1] + ex), (kind, b, o)


@pytest.mark.parametrize("case", ["pairs", "moe-2d", "rwkv6"])
def test_zero1_moments_are_a_data_share(runs, case):
    """A rank's moments are 1 / data of the baseline's on every leaf with
    a dim that 2 divides (every leaf of these configs), the 2-D experts'
    their own slice's; the remat run and the run without it agree."""
    cfg, _, _, res = runs[case]
    base = res["train", "base", True][0]["moment_shapes"]
    opt = res["train", "opt", True][0]["moment_shapes"]
    assert len(base) == len(opt)
    for b, o in zip(base, opt):
        assert np.prod(o) * 2 == np.prod(b), (b, o)
    assert opt == res["train", "opt", False][0]["moment_shapes"]


def _gspmd_opt(jcfg, jmodel, jparams):
    """The reference's optimized GSPMD step at (data 1, model 2): the
    config's ``act_shard`` (sequence parallelism) and ZeRO-1 moment
    shardings, as its ``build_case(optimized=True)`` sets them."""
    mesh = jmesh.make_host_mesh(model=2)
    jcfg = dataclasses.replace(jcfg, act_shard=(jmesh.batch_axes(mesh),
                                                "model"))
    jmodel = jax_build_model(jcfg)
    with mesh:
        params = jax.device_put(jparams, jsh.param_shardings(jparams, mesh))
        z = jsh.zero1_shardings(jparams, mesh)
        opt = jopt.init_adamw(params)
        opt = jax.device_put(opt, jopt.AdamWState(
            step=NamedSharding(mesh, P()), mu=z, nu=z))
        step = jax.jit(jtrainer.make_train_step(jmodel, jopt.AdamWConfig(
            lr=OPT.lr, eps=OPT.eps, warmup_steps=OPT.warmup_steps,
            total_steps=OPT.total_steps), remat=True))
        it = iter(JaxStream(jcfg, JaxDataConfig(batch_size=B, seq_len=T)))
        hist = []
        for _ in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in next(it).items()}
            params, opt, m = step(params, opt, batch)
            hist.append({k: float(v) for k, v in m.items()})
    return hist, jax.tree.map(np.asarray, params)


def test_optimized_step_matches_reference_gspmd():
    ranks = make_ranks(1, 2)
    jcfg = jax_get_config("smollm-360m").reduced(**ODD_HEADS)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    arrays = jax.tree.map(np.asarray, jparams)
    jhist, jwant = _gspmd_opt(jcfg, jmodel, jparams)
    cfg = get_config("smollm-360m").reduced(**ODD_HEADS)
    levers = choose_levers(cfg, "train", 2)
    assert levers == Levers(seq_parallel=True, zero1=True)
    whole = bridge.params_from_numpy(arrays, cfg, device="cpu")
    res = _threads(2, lambda r: _train(ranks[r], cfg, whole, levers, True))
    for h, want in zip(res[0]["hist"], jhist):
        for k in ("loss", "lr", "grad_norm"):
            assert h[k] == pytest.approx(want[k], rel=REF_TOL, abs=1e-9), k
    got = res[0]["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(jwant):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        err = float(np.abs(leaf.numpy() - want).max())
        assert err <= REF_TOL * max(1.0, float(np.abs(want).max())), (
            path, err)


# --------------------------------------------------------------------------
# Every optimized case traces at (2, 2)
# --------------------------------------------------------------------------
SMALL = Layout({"data": 2, "model": 2})
SIZES = {"train_4k": (4, 16), "prefill_32k": (4, 16),
         "decode_32k": (4, 16), "long_500k": (1, 64)}


def _reduced(arch, shape):
    cfg = adjusted_config(arch, shape).reduced()
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=16)
    return cfg


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCHS
                                        for s in SHAPES])
def test_every_optimized_case_traces(arch, shape):
    """At (2, 2) on the reduced config: the row is ``ok``, ``optimized``,
    and lists the levers the rule picks at model 2 (the reduced MoEs are
    far below 8 GiB a chip, so 2-D experts only in their decodes; no
    reduced kv head count fails to divide 2, so no sequence-split
    cache)."""
    if skip_reason(arch, shape):
        return
    batch, seq = SIZES[shape]
    cfg = _reduced(arch, shape)
    row = dryrun.run_case(arch, shape, False, verbose=False, optimized=True,
                          layout=SMALL, cfg=cfg, batch=batch, seq=seq)
    assert row["status"] == "ok", row.get("error")
    assert row["optimized"] is True
    kind = shape_kind(shape)
    want = ({"train": ["seq_parallel", "zero1"]}.get(kind, [])
            + (["expert_2d"] if cfg.num_experts and kind == "decode"
               else []))
    if cfg.family == "hybrid" and kind != "decode":
        want.append("ssm_chunk")
    assert sorted(row["levers"]) == sorted(want)
    assert row["levers"] == list(choose_levers(cfg, kind, 2).taken())
    assert row["n_collectives"] > 0
