"""The port's roofline (``repro_torch.launch.roofline``) and the recording
rank its dry run traces (``repro_torch.launch.mesh.VirtualRank``): the
reference's roofline tests (``tests/test_shardings.py``) on the H100's
constants, ``collective_wire_bytes`` equal to the JAX function's on the
same records, and the collectives a reduced dense decoder's prefill and
decode record at (data 2, model 2), against a count spelled out here."""
import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.cost import H100  # noqa: E402
from repro_torch.launch.cases import adjusted_config, build_case  # noqa: E402
from repro_torch.launch.dryrun import trace_case  # noqa: E402
from repro_torch.launch.mesh import (Layout, RecordingCollectives,  # noqa: E402
                                     VirtualRank, make_production_mesh)
from repro_torch.launch.roofline import (Roofline,  # noqa: E402
                                         collective_wire_bytes, model_flops)


def test_roofline_terms_and_dominance():
    rl = Roofline(arch="x", shape="train_4k", mesh="16x16",
                  flops_per_chip=989e12, bytes_per_chip=0.0,
                  collective_bytes_per_chip=0.0, num_chips=256,
                  model_flops_global=989e12 * 256 / 2)
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.dominant == "compute"
    assert rl.useful_flops_ratio == pytest.approx(0.5)
    # the H100's published rates price every term
    rl = Roofline(arch="x", shape="decode_32k", mesh="16x16",
                  flops_per_chip=0.0, bytes_per_chip=3.35e12,
                  collective_bytes_per_chip=2 * 450e9, num_chips=256,
                  model_flops_global=1.0)
    assert (rl.t_memory, rl.t_collective) == (pytest.approx(1.0),
                                              pytest.approx(2.0))
    assert rl.dominant == "collective"
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw) == (989e12, 3.35e12,
                                                           450e9)
    assert set(rl.row()) == set(jroof.Roofline(
        "x", "s", "m", 1.0, 1.0, 1.0, 1, 1.0).row())


def test_model_flops_scaling():
    cfg = get_config("smollm-360m")
    train = model_flops(cfg, "train_4k", 4096, 256)
    dec = model_flops(cfg, "decode_32k", 32768, 128)
    assert train > dec
    assert train == pytest.approx(3 * model_flops(cfg, "prefill_32k", 4096,
                                                  256), rel=1e-6)


RECORDS = [
    dict(op="all-reduce", name="a", operand_bytes=8 * 4096 * 4.0,
         result_bytes=8 * 4096 * 4.0, mult=1),
    dict(op="all-gather", name="b", operand_bytes=4 * 256 * 2.0,
         result_bytes=64 * 256 * 2.0, mult=1),
    dict(op="reduce-scatter", name="c", operand_bytes=8 * 4096 * 4.0,
         result_bytes=4096 * 4.0, mult=28),
    dict(op="all-to-all", name="d", operand_bytes=1000.0,
         result_bytes=1000.0, mult=3),
    dict(op="collective-permute", name="e", operand_bytes=0.0,
         result_bytes=128 * 256 * 2.0, mult=1),
    dict(op="all-gather", name="f", operand_bytes=64.0, result_bytes=0.0),
]


def test_collective_wire_bytes_equal_the_reference():
    got = collective_wire_bytes(RECORDS)
    assert got == jroof.collective_wire_bytes(RECORDS)
    assert got == (2 * 8 * 4096 * 4 + 64 * 256 * 2 + 28 * 8 * 4096 * 4
                   + 3 * 1000 + 128 * 256 * 2 + 64)


def test_virtual_rank_folds_the_batch_axes():
    rank = VirtualRank(make_production_mesh(multi_pod=True))
    assert (rank.data, rank.model, rank.size) == (32, 16, 512)
    assert rank.shape == {"data": 32, "model": 16}
    assert rank.coords == {"data": 0, "model": 0}
    assert rank.model_group.size == 16 and rank.data_group.size == 32
    one = VirtualRank(Layout({"data": 1, "model": 1}))
    assert one.model_group is None and one.data_group is None
    g = RecordingCollectives(1, 4, "model")
    x = torch.ones((2, 3), dtype=torch.bfloat16)
    assert g.all_reduce(x) is x
    assert tuple(g.all_gather(x, 0).shape) == (8, 3)
    assert [r["op"] for r in g.records] == ["all-reduce", "all-gather"]
    assert g.records[1]["result_bytes"] == 4 * g.records[1]["operand_bytes"]


def _reduced_llama(shape):
    return adjusted_config("llama3.2-3b", shape).reduced()


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_a_tensor_parallel_rank_records_its_collectives(shape):
    """Reduced llama (d 256, 4 / 2 heads, d_ff 512, vocab 512, 2 layers,
    bf16) at (data 2, model 2): every dim divides, so the model group
    runs tensor parallelism. B 4 splits into 2 rows a rank; the prefill
    runs T 32 tokens, the decode one. By hand: the vocab-split
    embedding's all-reduce of [2, t, 256] bf16, the wo and w_down
    all-reduces of each layer (the same bytes), and the logits' all-gather
    of the last token's [2, 1, 256] (its V / 2 columns) into [2, 1,
    512]; no collective on the data group."""
    cfg = _reduced_llama(shape)
    case = build_case("llama3.2-3b", shape, Layout({"data": 2, "model": 2}),
                      cfg=cfg, batch=4, seq=32)
    assert case.mechanism == "tensor" and case.rows == 2
    recs = trace_case(case)["records"]
    t = 32 if shape == "prefill_32k" else 1
    act = 2 * t * 256 * 2
    want = ([("all-reduce", act, act)] * (1 + 2 * cfg.num_layers)
            + [("all-gather", 2 * 256 * 2, 2 * 512 * 2)])
    assert [(r["op"], r["operand_bytes"], r["result_bytes"])
            for r in recs] == want
    assert all(r["name"].startswith("model/") and r["mult"] == 1
               for r in recs)
    assert collective_wire_bytes(recs) == (2 * act * (1 + 2 * cfg.num_layers)
                                           + 2 * 512 * 2)
