"""The port's dry-run cases (``repro_torch.launch.cases``) and analytic
roofline formulas (``repro_torch.launch.roofline``): the reference's
``tests/test_cases.py`` mirrored on the port, then both held against the
JAX package for every arch x shape — ``skip_reason``, ``adjusted_config``
field by field, ``input_specs`` shapes and dtypes, and
``analytic_flops_global`` / ``analytic_min_bytes`` (16x16, 2x16x16, 1x1)
/ ``model_flops`` within 1e-12 (relative)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch import cases as jcases  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.migration import tree_leaves  # noqa: E402
from repro_torch.launch.cases import (SHAPES, adjusted_config,  # noqa: E402
                                      build_case, input_specs, shape_kind,
                                      skip_reason)
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.roofline import (analytic_flops_global,  # noqa: E402
                                         analytic_min_bytes, model_flops)

ASSIGNED = [a for a in ARCHS if a != "llama3.2-3b"]
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 1})
REL = 1e-12


# ---- tests/test_cases.py, on the port --------------------------------------
def test_shapes_table():
    assert SHAPES["train_4k"]["global_batch"] == 256
    assert SHAPES["long_500k"]["seq_len"] == 524_288
    assert shape_kind("decode_32k") == "decode"
    assert shape_kind("prefill_32k") == "prefill"


def test_skip_matrix():
    skips = [(a, s) for a in ASSIGNED for s in SHAPES
             if skip_reason(a, s)]
    assert skips == [("whisper-large-v3", "long_500k")]


def test_adjusted_config_long_context():
    for arch in ("qwen2.5-14b", "arctic-480b", "qwen2-vl-7b"):
        cfg = adjusted_config(arch, "long_500k")
        assert cfg.sliding_window == 8192, "dense/MoE/VLM need sub-quadratic"
    assert adjusted_config("rwkv6-7b", "long_500k").sliding_window == 0
    assert adjusted_config("zamba2-2.7b", "long_500k").sliding_window == 0


def test_adjusted_config_moe_uses_gshard():
    assert adjusted_config("qwen3-moe-30b-a3b", "train_4k").moe_impl == \
        "gshard"
    assert get_config("qwen3-moe-30b-a3b").moe_impl == "dense"


@pytest.mark.parametrize("arch", ASSIGNED)
def test_analytic_flops_positive_and_ordered(arch):
    cfg = adjusted_config(arch, "train_4k")
    f_train = analytic_flops_global(cfg, "train_4k", 4096, 256)
    cfg_d = adjusted_config(arch, "decode_32k")
    f_dec = analytic_flops_global(cfg_d, "decode_32k", 32768, 128)
    assert f_train > f_dec > 0
    # executed >= matmul-core model flops
    assert f_train >= model_flops(cfg, "train_4k", 4096, 256) * 0.99


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "arctic-480b", "rwkv6-7b"])
def test_analytic_bytes_floor(arch):
    cfg = adjusted_config(arch, "decode_32k")
    b16 = analytic_min_bytes(cfg, "decode_32k", 32768, 128,
                             {"data": 16, "model": 16})
    b32 = analytic_min_bytes(cfg, "decode_32k", 32768, 128,
                             {"pod": 2, "data": 16, "model": 16})
    assert b16 > 0
    assert b32 <= b16  # more chips -> less per chip
    train = analytic_min_bytes(cfg, "train_4k", 4096, 256,
                               {"data": 16, "model": 16})
    assert train > b16  # optimizer traffic dominates


def test_sliding_window_shrinks_decode_flops():
    full = adjusted_config("qwen2.5-14b", "decode_32k")
    win = adjusted_config("qwen2.5-14b", "long_500k")
    f_full = analytic_flops_global(full, "decode_32k", 32768, 1)
    f_win = analytic_flops_global(win, "long_500k", 524_288, 1)
    # 500k with window 8192 does LESS attention than 32k full
    assert f_win < f_full


# ---- held against the JAX package -------------------------------------------
def test_the_same_archs_and_shapes():
    assert ARCHS == list(JAX_ARCHS)
    assert SHAPES == jcases.SHAPES
    assert jcases.SLIDING_WINDOW_LONG == 8192


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_case_tables_match_the_reference(arch, shape):
    assert skip_reason(arch, shape) == jcases.skip_reason(arch, shape)
    tc = adjusted_config(arch, shape)
    jc = jcases.adjusted_config(arch, shape)
    for f in dataclasses.fields(tc):
        # the port's own runtime fields (a rank's groups, its plan, its
        # levers), which the reference's config has not
        if f.name not in ("dtype", "tp_axis", "tp_plan", "tp_rows",
                          "levers", "seq_parallel", "tp_data"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.dtype == torch.bfloat16 and jc.dtype == jnp.bfloat16
    # input stand-ins: the same names, shapes and dtypes, on no storage
    ti, ji = input_specs(arch, shape), jcases.input_specs(arch, shape)
    assert sorted(ti) == sorted(ji)
    for k, t in ti.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ji[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(ji[k].dtype) or (
            t.dtype == torch.bool and ji[k].dtype == jnp.bool_), k
    # the analytic terms, on the same configs
    sp = SHAPES[shape]
    T, B = sp["seq_len"], sp["global_batch"]
    pairs = [(analytic_flops_global(tc, shape, T, B),
              jroof.analytic_flops_global(jc, shape, T, B)),
             (model_flops(tc, shape, T, B), jroof.model_flops(jc, shape, T,
                                                              B))]
    pairs += [(analytic_min_bytes(tc, shape, T, B, m),
               jroof.analytic_min_bytes(jc, shape, T, B, m)) for m in MESHES]
    for got, want in pairs:
        assert want > 0
        assert got == pytest.approx(want, rel=REL)


def test_build_case_refuses_the_optimized_levers_and_skips():
    """The optimized levers run (no refusal since the port has them):
    a 16x16 train case takes sequence parallelism and ZeRO-1, whose
    moments are a sixteenth of the baseline's; the skip stands."""
    mesh = make_production_mesh()
    opt = build_case("qwen2.5-14b", "train_4k", mesh, optimized=True)
    base = build_case("qwen2.5-14b", "train_4k", mesh)
    assert opt.levers.taken() == ("seq_parallel", "zero1")
    assert base.levers is None

    def numel(tree):
        return sum(a.numel() for a in tree_leaves(tree))
    assert 16 * numel(opt.args[1].mu) == numel(base.args[1].mu)
    with pytest.raises(ValueError, match="skipped"):
        build_case("whisper-large-v3", "long_500k", mesh)
