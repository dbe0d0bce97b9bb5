"""The expert-split MoE: ``models.mlp.moe_gshard`` on a rank's E / m
experts (``_moe_gshard_split``: the rank's kept (token, k) pairs
dispatched by index into ``[E/m, G, C, D]``, combined by gather, one f32
all-reduce), f32 on the CPU, on gloo groups between threads of this
process (``tests/test_torch_partition.py``'s ``ThreadRank``).

* **The split form alone** on a (data 1, model 2) and a (2, 2) group
  against the unsharded one-hot form, at the default capacity factor and
  at 0.5 (pairs dropped): the output, the aux loss and the gradients of
  x, the router and the experts within 1e-5 (of the largest magnitude,
  at least 1: ``test_torch_partition.TOL``); no capacity cell is taken twice, and the ranks'
  kept pairs are exactly the unsharded form's.
* **Against the reference**: the reduced qwen3-moe's sharded ``gshard``
  train step at (1, 2) (tensor parallelism: every dim divides) against
  the reference's GSPMD step within ``REF_TOL`` = 1e-4.
* **arctic**: the reduced arctic (its ``dense_residual`` adds the
  ``mlp`` block beside the experts) at (2, 2) against unsharded: the
  train step, the prefill and a decode step, with each program's
  collectives the hand count.
* **The dry run** of the reduced qwen3-moe at (2, 2): each kind's
  recorded collectives on the model group the hand count, one f32
  all-reduce of the rank's ``[rows, T, D]`` a MoE layer in a forward,
  and no all-gather of an expert leaf."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed")

import jax  # noqa: E402

import test_torch_partition as part  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cases import build_case  # noqa: E402
from repro_torch.launch.mesh import Layout  # noqa: E402
from repro_torch.models import build_model, mlp  # noqa: E402
from repro_torch.models.common import all_reduce  # noqa: E402
from repro_torch.training.data import TokenStream  # noqa: E402
from repro_torch.training.optimizer import init_adamw  # noqa: E402
from repro_torch.training.trainer import (make_sharded_train_step,  # noqa
                                          sharding_mechanism)

REF_TOL = part.REF_TOL
G, T = 4, 16                 # the split form's groups and their tokens


def _gshard(arch):
    return dataclasses.replace(get_config(arch).reduced(), moe_impl="gshard")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks():
    return {(1, 2): part.make_ranks(1, 2), (2, 2): part.make_ranks(2, 2)}


# --------------------------------------------------------------------------
# The split form alone
# --------------------------------------------------------------------------
def _layer(cfg, seed):
    """One layer's MoE weights, x [G, T, D] and the loss's weights r, all
    f32 from numpy's seeded generator."""
    rng = np.random.default_rng(seed)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(
            np.float32))
    p = {"router": normal((D, E), D ** -0.5),
         "w_gate": normal((E, D, Fd), E ** -0.5),
         "w_up": normal((E, D, Fd), E ** -0.5),
         "w_down": normal((E, Fd, D), E ** -0.5)}
    return p, normal((G, T, D), 1.0), normal((G, T, D), 1.0)


def _loss_grads(p, cfg, x, r, cf, data_group=None):
    """The MoE's output and aux, and the gradients of ``sum(out · r) +
    aux`` with respect to x and every leaf of p."""
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    x = x.clone().requires_grad_()
    with torch.enable_grad():
        out, aux = mlp.moe_gshard(p, cfg, x, capacity_factor=cf,
                                  data_group=data_group)
        grads = torch.autograd.grad((out * r).sum() + aux,
                                    [x] + [p[k] for k in sorted(p)])
    return out.detach(), aux.detach(), dict(zip(["x"] + sorted(p), grads))


def _routing(p, cfg, x, cf):
    """(topi, slot, C) of the unsharded routing of x."""
    Gx, S, D = x.shape
    K = cfg.experts_per_token
    C = max(1, int(np.ceil(S * K / cfg.num_experts * cf)))
    _, _, topi, _ = mlp._route(p, cfg, x.reshape(Gx * S, D))
    topi = topi.reshape(Gx, S, K)
    return topi, mlp.gshard_slots(topi, cfg.num_experts), C


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("layout", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_split_gshard_equals_unsharded(ranks, layout, cf):
    cfg = dataclasses.replace(_gshard("qwen3-moe-30b-a3b"), num_experts=8)
    p, x, r = _layer(cfg, 11)
    want_out, want_aux, want = _loss_grads(p, cfg, x, r, cf)
    topi, slot, C = _routing(p, cfg, x, cf)
    # the slots are the one-hot form's: the reference's exclusive cumsum
    onehot = torch.nn.functional.one_hot(topi, cfg.num_experts).float()
    flat = onehot.reshape(G, -1, cfg.num_experts)
    ref_slot = ((torch.cumsum(flat, 1) - flat) * flat).sum(-1)
    assert torch.equal(slot, ref_slot.reshape(slot.shape).to(torch.int32))
    dropped = int((slot >= C).sum())
    if cf < 1:
        assert dropped > 0
    data, model = layout
    mesh = ranks[layout]
    e_loc, rows = cfg.num_experts // model, G // data

    def run(i):
        m = mesh[i]
        sl = slice(m.m * e_loc, (m.m + 1) * e_loc)
        ps = {k: v if k == "router" else v[sl].clone() for k, v in p.items()}
        c = dataclasses.replace(cfg, tp_axis=m.model_group)
        own = slice(m.d * rows, (m.d + 1) * rows)
        out, aux, g = _loss_grads(ps, c, x[own], r[own], cf, m.data_group)
        # the data group's rows: the leaves' gradients are summed over it
        g = {k: v if k == "x" else all_reduce(v, m.data_group)
             for k, v in g.items()}
        cell, keep = mlp.gshard_cells(topi[own], slot[own], m.m * e_loc,
                                      e_loc, C)
        return out, aux, g, cell[keep], keep, own, sl
    kept = torch.zeros_like(slot, dtype=torch.int32)
    for out, aux, g, cells, keep, own, sl in part._threads(len(mesh), run):
        part._close(out, want_out[own])
        part._close(aux, want_aux)
        part._close(g["x"], want["x"][own])
        part._close(g["router"], want["router"])
        for k in ("w_down", "w_gate", "w_up"):
            part._close(g[k], want[k][sl])
        # no capacity cell of the rank is written twice
        assert cells.unique().numel() == cells.numel() == int(keep.sum())
        kept[own] += keep.to(torch.int32)
    # each pair below capacity is some rank's, once; the dropped none's
    assert torch.equal(kept, (slot < C).to(torch.int32))
    assert int((kept == 0).sum()) == dropped


# --------------------------------------------------------------------------
# Against the reference's GSPMD step at (1, 2)
# --------------------------------------------------------------------------
def test_split_step_matches_reference_gspmd(ranks):
    jcfg = dataclasses.replace(jax_get_config("qwen3-moe-30b-a3b").reduced(),
                               moe_impl="gshard")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    arrays = jax.tree.map(np.asarray, jparams)
    jhist, jwant = part._gspmd(jcfg, jmodel, jparams)
    cfg = _gshard("qwen3-moe-30b-a3b")
    whole = bridge.params_from_numpy(arrays, cfg, device="cpu")
    mesh = ranks[(1, 2)]

    def run(r):
        step = make_sharded_train_step(build_model(cfg), part.OPT, mesh[r],
                                       remat=True)
        p = step.shard(part._clone(whole))
        opt = init_adamw(p)
        it = iter(TokenStream(cfg, part.DATA))
        hist = []
        for _ in range(part.STEPS):
            p, opt, m = step(p, opt, next(it))
            hist.append({k: float(v) for k, v in m.items()})
        return step.plan, hist, step.gather(p), tuple(
            p["layers"]["moe"]["w_gate"].shape)
    res = part._threads(2, run)
    for plan, _, _, shape in res:
        assert plan.mechanism == "tensor" and plan.blocks["experts"] == "split"
        assert shape[1] == cfg.num_experts // 2
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
# arctic at (2, 2): the experts and the dense residual FFN both split
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def arctic_run(ranks):
    cfg = _gshard("arctic-480b")
    ref = part._unsharded(cfg)
    mesh = ranks[(2, 2)]
    res = part._threads(4, lambda r: part._rank_run(
        mesh[r], cfg, ref, ("train", "prefill", "decode")))
    return {"arctic": (cfg, ref, mesh, res)}


def test_arctic_plan():
    cfg = _gshard("arctic-480b")
    plan = sharding_mechanism(cfg, 2)
    assert plan.mechanism == "tensor"
    assert plan.blocks["experts"] == plan.blocks["mlp"] == "split"
    full = dataclasses.replace(get_config("arctic-480b"), moe_impl="gshard")
    plan = sharding_mechanism(full, 16)
    assert plan.mechanism == "per-leaf" and plan.axes["core"] == "pairs"
    assert plan.blocks["experts"] == plan.blocks["mlp"] == "split"


def test_arctic_train_step_equals_unsharded(arctic_run):
    part.test_train_step_equals_unsharded(arctic_run, "arctic")


def test_arctic_prefill_and_decode_equal_unsharded(arctic_run):
    part.test_prefill_and_decode_equal_unsharded(arctic_run, "arctic")


# --------------------------------------------------------------------------
# The dry run on the split experts
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,batch,seq", [
    ("train_4k", 4, 16), ("prefill_32k", 4, 16), ("decode_32k", 4, 16)])
def test_dryrun_records_the_split_moe(shape, batch, seq):
    """The reduced qwen3-moe's rank 0 at (data 2, model 2) traced under
    fake tensors: tensor parallelism with split experts; its records on
    the model group are the hand count; a forward's MoE all-reduces its
    rank's rows once, in f32; no all-gather carries an expert leaf (the
    only gathers are the logits', or the loss's row maxima)."""
    # bf16, so that wo's all-reduce (bf16) is not the combine's size
    cfg = dataclasses.replace(_gshard("qwen3-moe-30b-a3b"),
                              dtype=torch.bfloat16)
    layout = Layout({"data": 2, "model": 2})
    case = build_case("qwen3-moe-30b-a3b", shape, layout, cfg=cfg,
                      batch=batch, seq=seq)
    traced = dryrun.trace_case(case)
    kind = {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode"}[shape]
    assert case.mechanism == "tensor"
    assert case.plan.blocks["experts"] == "split"
    on_model = [r for r in traced["records"]
                if r["name"].startswith("model/")]
    assert len(on_model) == part._hand_count(cfg, case.plan, kind, 2)
    rows, D = batch // 2, cfg.d_model
    T_ = 1 if kind == "decode" else seq
    moe_reduce = 4.0 * rows * T_ * D
    reduces = [r for r in on_model if r["op"] == "all-reduce"
               and r["operand_bytes"] == moe_reduce]
    # each layer's f32 combine, once (remat's second forward stops
    # before it)
    assert len(reduces) == cfg.num_layers
    E, Fd = cfg.num_experts, cfg.d_ff
    leaf = 2.0 * (E // 2) * D * Fd          # a layer's expert leaf, bf16
    gathers = [r for r in on_model if r["op"] == "all-gather"]
    assert len(gathers) == 1
    assert all(r["operand_bytes"] not in (leaf, 2 * leaf) for r in gathers)
