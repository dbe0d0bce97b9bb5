"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: one
rank's program of every family (reduced) and kind traced under fake
tensors at (data 2, model 2), its row carrying every key of the
reference's; the traced FLOPs against the analytic formula (a decode
lacks exactly the embedding lookup's ``2·V·d·B``, a prefill also the
unembedding of every token but each row's last and the causal half of
the scores that #6 skips); context-parallel decode
(``models.attention.context_parallel_decode``) over a real 2-rank gloo
group (two threads of this process) equal to the unsharded
``decode_step`` within 1e-5 in f32; the command line on one case; and
``--opt`` running the levers."""
import dataclasses
import json
import threading

import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.cases import adjusted_config, build_case  # noqa: E402
from repro_torch.launch.mesh import Layout  # noqa: E402
from repro_torch.launch.roofline import analytic_flops_global  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

# the reference's row: Roofline.row() plus these (t_lower + t_compile are
# the port's one t_trace)
REF_KEYS = set(jroof.Roofline("x", "s", "m", 1.0, 1.0, 1.0, 1, 1.0).row()) | {
    "status", "optimized", "output_bytes"}
FAMILIES = {"dense": "llama3.2-3b", "moe": "qwen3-moe-30b-a3b",
            "vlm": "qwen2-vl-7b", "ssm": "rwkv6-7b", "hybrid": "zamba2-2.7b",
            "encdec": "whisper-large-v3"}
# (shape, global batch, sequence) at reduced size
KINDS = (("train_4k", 4, 16), ("prefill_32k", 4, 16), ("decode_32k", 4, 16),
         ("long_500k", 1, 64))
SMALL = Layout({"data": 2, "model": 2})
CP_TOL = 1e-5


def _reduced(arch, shape, **over):
    cfg = adjusted_config(arch, shape).reduced(**over)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=16)
    return cfg


@pytest.mark.parametrize("kind", KINDS, ids=[k[0] for k in KINDS])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_and_kind_traces(family, kind):
    shape, batch, seq = kind
    arch = FAMILIES[family]
    if arch == "whisper-large-v3" and shape == "long_500k":
        row = dryrun.run_case(arch, shape, False, verbose=False)
        assert row["status"] == "skipped"
        return
    row = dryrun.run_case(arch, shape, False, verbose=False, layout=SMALL,
                          cfg=_reduced(arch, shape), batch=batch, seq=seq)
    assert row["status"] == "ok", row.get("error")
    assert REF_KEYS <= set(row) and "t_trace" in row
    assert row["mesh"] == "2x2" and row["optimized"] is False
    assert row["flops_hlo_per_chip"] > 0 and row["bytes_hlo_per_chip"] > 0
    assert row["arg_bytes_per_chip"] > 0 and row["temp_bytes_per_chip"] > 0
    assert row["n_collectives"] > 0         # the model group, at least
    # the mechanism the sharded trainer picks (the MoE's gshard experts
    # split like its other blocks; zamba2's Mamba2 cuts miss its heads'
    # edges, so its blocks split per leaf); long_500k splits the ring (or
    # zamba2's sites) over data, rwkv6's state has no sequence axis
    assert row["mechanism"] == {"hybrid": "per-leaf"}.get(family, "tensor")
    assert row["context_parallel"] == (shape == "long_500k"
                                       and family != "ssm")


def _traced(shape, batch, seq):
    cfg = _reduced("llama3.2-3b", shape)
    case = build_case("llama3.2-3b", shape, Layout({"data": 1, "model": 1}),
                      cfg=cfg, batch=batch, seq=seq)
    flops = dryrun.trace_case(case)["flops"]
    return cfg, flops, analytic_flops_global(cfg, shape, seq, batch)


def test_traced_flops_against_the_formula():
    """Decode: the formula less the lookup's 2·V·d·B, exactly. Prefill:
    also less the unembedding of all but each row's last token,
    2·V·d·B·(T - 1), and the keys past each query that #6 does not
    compute, 2·L·B·H·Dh·T·(T - 1) of the formula's full 4·L·B·H·Dh·T²."""
    cfg, got, formula = _traced("decode_32k", 3, 40)
    Vd = cfg.vocab_size * cfg.d_model
    assert got == formula - 2 * Vd * 3
    cfg, got, formula = _traced("prefill_32k", 2, 24)
    causal = 2 * cfg.num_layers * 2 * cfg.num_heads * cfg.head_dim * 24 * 23
    assert got == formula - 2 * Vd * 2 * 24 - 2 * Vd * 2 * 23 - causal


def test_traffic_counts_the_rows_a_gather_or_scatter_addresses():
    """A lookup of 3 rows of a [100, 8] f32 table reads its int64 indices
    and the 3 rows and writes them (24 + 2 · 96 bytes), not the table; an
    in-place write of those rows into a [100, 8] f32 buffer reads the
    indices and the values and writes the values (24 + 2 · 96); an
    elementwise op its tensor operand and its result (2 · 96)."""
    table = torch.zeros((100, 8))
    idx = torch.tensor([1, 5, 7])
    traffic = dryrun.Traffic()
    with traffic:
        rows = torch.nn.functional.embedding(idx, table)
        table.index_put_((idx,), rows)
        rows + 1.0
    assert traffic.bytes == 2 * (24 + 2 * 96) + 2 * 96


@pytest.fixture(scope="module")
def pair():
    """Two ranks of one gloo group in this process (a thread each)."""
    store = dist.HashStore()
    pgs = [None, None]

    def join(r):
        pgs[r] = mesh_mod._gloo(store, r, 2)
    threads = [threading.Thread(target=join, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive(), "the group did not form in 120 s"
    return [mesh_mod.Collectives(pgs[r], r, 2) for r in range(2)]


def _on_ranks(pair, fn):
    out, errors = [None, None], []

    def run(r):
        try:
            out[r] = fn(r, pair[r])
        except BaseException as e:     # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive(), "a rank did not finish in 120 s"
    if errors:
        raise errors[0]
    return out


CP_CASES = (  # (arch, window, cache rows, positions of the 2 rows)
    ("llama3.2-3b", 16, 16, (37, 5)),      # a wrapped ring; row 1 on rank 0
    ("llama3.2-3b", 0, 24, (23, 10)),      # a full slab; rank 1 half empty
    ("zamba2-2.7b", 0, 24, (19, 2)),       # the shared block's sites
)


@pytest.mark.parametrize("arch,window,rows,pos", CP_CASES,
                         ids=["ring", "slab", "zamba2"])
def test_context_parallel_decode_equals_unsharded(pair, arch, window, rows,
                                                  pos):
    cfg = adjusted_config(arch, "decode_32k", dtype=torch.float32).reduced(
        sliding_window=window)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    cache = model.init_cache(2, rows, device="cpu")
    leaves = ([cache.k, cache.v] if cfg.family != "hybrid" else
              [cache["kv"].k, cache["kv"].v, cache["conv"], cache["ssm"]])
    for leaf in leaves:
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    token = torch.tensor([3, 7], dtype=torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32)

    def clone(c):
        if isinstance(c, dict):
            return {k: clone(v) for k, v in c.items()}
        return type(c)(*(a.clone() for a in c)) if isinstance(
            c, tuple) else c.clone()
    with torch.no_grad():
        want, ref = model.decode_step(params, clone(cache), token, pos)
    kv = (lambda c: c["kv"]) if cfg.family == "hybrid" else (lambda c: c)
    half = rows // 2

    def shard(c, r):
        c = clone(c)
        piece = type(kv(c))(*(a[:, :, r * half:(r + 1) * half].clone()
                              for a in kv(c)))
        if cfg.family == "hybrid":
            c["kv"] = piece
            return c
        return piece

    def rank(r, group):
        with torch.no_grad():
            return model.decode_step(params, shard(cache, r), token, pos,
                                     seq_group=group)
    (l0, c0), (l1, c1) = _on_ranks(pair, rank)
    scale = want.abs().max().item()
    for got in (l0, l1):
        assert (got - want).abs().max().item() <= CP_TOL * scale
    # the written rows land on their owner (layer 0's bit for bit; later
    # layers' K/V come from activations the merge rounded differently)
    for a, b, whole in zip(kv(c0), kv(c1), kv(ref)):
        got = torch.cat([a, b], dim=2)
        assert torch.equal(got[0], whole[0])
        assert (got - whole).abs().max().item() <= CP_TOL * whole.abs().max()
    if cfg.family == "hybrid":
        for name in ("conv", "ssm"):
            assert (c0[name] - ref[name]).abs().max().item() <= CP_TOL


def test_the_command_line(tmp_path, capsys):
    """One case at both layouts, in two worker processes (``--jobs``)."""
    out = tmp_path / "rows.json"
    dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k",
                 "--mesh", "both", "--jobs", "2", "--out", str(out)])
    text = capsys.readouterr().out
    assert "2 ok / 0 skipped / 0 FAILED of 2" in text
    rows = json.loads(out.read_text())
    assert [r["mesh"] for r in rows] == ["16x16", "2x16x16"]
    for row in rows:
        assert row["status"] == "ok" and row["context_parallel"]
        assert REF_KEYS <= set(row)
    # the batch axes fold: the ring splits over 16, then 32 data ranks
    assert rows[1]["arg_bytes_per_chip"] < rows[0]["arg_bytes_per_chip"]


def test_the_optimized_levers_are_refused(tmp_path, capsys):
    """``--opt`` runs (no refusal since the port has the levers): one
    sequence-split decode row on the command line, and ``run_case`` of a
    reduced train case, each row ``optimized`` with its levers."""
    out = tmp_path / "opt.json"
    dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--opt",
                 "--out", str(out)])
    assert "1 ok / 0 skipped / 0 FAILED of 1" in capsys.readouterr().out
    row, = json.loads(out.read_text())
    assert row["optimized"] is True and row["levers"] == ["seq_cache"]
    assert row["plan_axes"]["cache"] == "seq"     # Hkv 5 does not divide 16
    row = dryrun.run_case("qwen2.5-14b", "train_4k", False, verbose=False,
                          optimized=True, layout=SMALL,
                          cfg=_reduced("qwen2.5-14b", "train_4k"), batch=4,
                          seq=16)
    assert row["status"] == "ok", row.get("error")
    assert row["optimized"] is True
    assert row["levers"] == ["seq_parallel", "zero1"]
