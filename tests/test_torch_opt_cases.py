"""The optimized cases (``launch.cases.build_case(optimized=True)``) on
the CPU: the levers the port takes for every (arch × shape) at (data 1,
model 2) against those the reference's ``build_case(optimized=True)``
sets on a 2-device host mesh (its ``act_shard``, ``ssm_chunk``, an expert
leaf split on ``data``, ZeRO-1 moment shardings in train, and the decode
cache's pinned spec with ``model`` on the sequence), each case built on
fake tensors (``tests/test_torch_opt_levers.py`` traces every optimized
case at (data 2, model 2)); the hybrid's
``ssm_chunk`` of 128 taking the chunked SSD on the CPU as on the card;
a multi-pod layout's ZeRO-1 step recording its reduce-scatter on the
data axis and its sum across the pods; and a real optimized rank's
counts equal to its trace's (thread ranks, ``test_torch_partition``'s
``ThreadRank``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.launch import cases as jcases  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cases import (SHAPES, build_case,  # noqa: E402
                                      shape_kind, skip_reason)
from repro_torch.launch.mesh import Layout, VirtualRank  # noqa: E402
from test_torch_partition import (ODD_HEADS, _threads,  # noqa: E402
                                  make_ranks)
from repro_torch.models import build_model, mamba2  # noqa: E402
from repro_torch.models.common import Levers  # noqa: E402

CASES = [(a, s) for a in ARCHS for s in SHAPES]


def _reference_levers(arch, shape):
    """The levers the reference's ``build_case(optimized=True)`` takes on
    ``make_host_mesh(model=2)``, read off its case."""
    mesh = jmesh.make_host_mesh(model=2)
    case = jcases.build_case(arch, shape, mesh, optimized=True)
    params = case.in_shardings[0]
    expert_2d = any(
        "data" in tuple(s.spec) for p, s in
        jax.tree_util.tree_leaves_with_path(params)
        if "moe" in jsh._path_str(p))
    kv = case.cfg.kv_cache_spec
    return Levers(
        seq_parallel=case.cfg.act_shard is not None,
        ssm_chunk=case.cfg.ssm_chunk, expert_2d=expert_2d,
        zero1=shape_kind(shape) == "train",
        seq_cache=kv is not None and len(kv) > 1 and kv[1] == "model")


@pytest.mark.parametrize("arch,shape", CASES)
def test_the_levers_are_the_references(arch, shape):
    if skip_reason(arch, shape):
        with pytest.raises(ValueError, match="skipped"):
            build_case(arch, shape, Layout({"data": 1, "model": 2}), True)
        return
    case = build_case(arch, shape, Layout({"data": 1, "model": 2}), True)
    assert case.levers == _reference_levers(arch, shape)
    assert case.cfg.levers == case.levers
    if case.levers.ssm_chunk:
        assert case.cfg.ssm_chunk == case.levers.ssm_chunk


def test_the_hybrid_chunk_takes_the_chunked_ssd_on_the_cpu():
    """``ssm_chunk`` 128 (the lever) runs the chunked SSD on the CPU
    where it divides T, the card's form, and equals the token-by-token
    scan within 1e-5 (f32)."""
    cfg = get_config("zamba2-2.7b").reduced()
    chunked = dataclasses.replace(cfg, ssm_chunk=128)
    assert mamba2.default_chunk(chunked, 256, "cpu") == 128
    assert mamba2.default_chunk(cfg, 256, "cpu") == 0
    assert mamba2.default_chunk(chunked, 200, "cpu") == 0
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = mamba2.forward_full(params, cfg, tokens)[0]
        got = mamba2.forward_full(params, chunked, tokens)[0]
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), err
    case = build_case("zamba2-2.7b", "prefill_32k",
                      Layout({"data": 1, "model": 2}), True)
    assert case.cfg.ssm_chunk == 128 and case.levers.ssm_chunk == 128


def test_a_multi_pod_zero1_step_splits_on_the_data_axis():
    """On (pod 2, data 2, model 1) the batch folds into a data group of 4
    but ZeRO-1 cuts the moments on the data axis (2), as the reference's
    rules do: the recorded step reduce-scatters its gradients over 2 and
    sums the slices across the 2 pods; the moments are half the
    params."""
    layout = Layout({"pod": 2, "data": 2, "model": 1})
    rank = VirtualRank(layout)
    assert rank.data == 4 and rank.data_group.size == 4
    assert rank.data_axis_group.size == 2 and rank.pod_group.size == 2
    cfg = get_config("smollm-360m").reduced()
    case = build_case("smollm-360m", "train_4k", layout, True, cfg=cfg,
                      batch=8, seq=16)
    row = dryrun.trace_case(case)
    ops = [(r["op"], r["name"].split("/")[0]) for r in row["records"]]
    assert ("reduce-scatter", "data") in ops
    assert ("all-reduce", "pod") in ops and ("all-gather", "data") in ops
    p = sum(a.numel() for a in torch.utils._pytree.tree_leaves(
        case.args[0]))
    mu = sum(a.numel() for a in torch.utils._pytree.tree_leaves(
        case.args[1].mu))
    assert 2 * mu == p


@pytest.mark.parametrize("dm,shape", [((1, 2), "train_4k"),
                                      ((1, 2), "decode_32k"),
                                      ((2, 1), "train_4k")])
def test_a_real_optimized_rank_counts_what_its_trace_counts(dm, shape):
    """The optimized program run on real tensors over real groups
    (``dryrun.run_rank(optimized=True)``, phase 29's job) counts in its
    warm run exactly the FLOPs, bytes and collectives of its trace at the
    same layout: a reduce-scatter's and a dim-0 gather's buffers are the
    group's, no op of the program, on both sides. Head dim 32 (no
    kernel), so both run the plain paths."""
    cfg = get_config("smollm-360m").reduced(head_dim=32, **ODD_HEADS)
    layout = Layout({"data": dm[0], "model": dm[1]})
    fake = build_case("smollm-360m", shape, layout, True, cfg=cfg, batch=2,
                      seq=16)
    traced = dryrun.trace_case(fake)
    ranks = make_ranks(*dm)
    got = _threads(2, lambda r: dryrun.run_rank(
        ranks[r], "smollm-360m", shape, batch=2, seq=16, runs=1, cfg=cfg,
        optimized=True))
    assert got[0]["levers"] == list(fake.levers.taken())
    assert sum(got[0]["warm"]["collectives"].values()) == len(
        traced["records"])
    assert (got[0]["warm"]["flops"], got[0]["warm"]["bytes"]) == (
        traced["flops"], traced["bytes"])
