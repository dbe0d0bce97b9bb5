"""The per-leaf forms of rwkv6, zamba2 and whisper on a training mesh's
model group (``training.trainer.sharding_mechanism``'s plans for the
families), f32 on the CPU, with the helpers of
``tests/test_torch_partition.py`` (its thread ranks, ``_rank_run``,
``_hand_count``): a file of its own, so that ``--dist loadfile`` gives it
a worker of its own.

* **Sharded == unsharded** (``CASES``): each family reduced at (data 2,
  model 2) on thread ranks — rwkv6 (every block split on whole heads:
  its WKV recurrence on the rank's heads, its channel mix on its share
  of F), zamba2 (its Mamba2 blocks split: the projection's and the
  conv's cuts miss the heads' edges and are joined by all-gathers of
  activations, the SSD on the rank's heads; the shared block on its
  heads), whisper with 3 heads and a vocabulary of 511 (the layout of
  whisper-large-v3 at model 16: attention split, its core over (row,
  head) pairs, the self-KV cache on its head dim, the tied embedding
  gathered at its use); and zamba2 at (data 1, model 3) with d_model
  192, where the Mamba2 block's projection and conv do not divide 3:
  its blocks gather their split leaves (``ln_gate``, ``w_out``) and its
  decode state (on the conv window's 3 rows and the SSD heads) at their
  use (the fallback), the attention splits.
  Two AdamW steps (remat) — loss, xent, grad norm, the params after
  them — the prefill's logits and state slices, and a decode step's,
  equal the unsharded port within ``TOL`` = 1e-5; each program's
  collectives on the model group equal the hand count; no all-gather
  takes a weight leaf, but the fallback's.
* **Against the reference**: each family's reduced config at (1, 2)
  against the reference's GSPMD step within ``REF_TOL`` = 1e-4.
* **The dry run**: each family's three programs at (2, 2) traced under
  fake tensors: the row's plan, its recorded collectives the hand
  count, its traced FLOPs within 2x of the analytic share.
* **A rank's prefill and decode** through ``launch.cases.
  rank_prefill_decode`` (the card phase's job), its state against
  ``local_shard`` of ``cache_shardings`` (``SERVE_CASES``): whisper at
  (1, 2) (its encoder frames a prefill extra, its cross K/V split on
  them), zamba2 at (1, 2) at a batch equal to ``attn_every`` (its states
  on the batch rows) and zamba2 split at (1, 3) (its conv state on the
  window's 3 rows)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.migration import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cases import (_zip_map, adjusted_config,  # noqa: E402
                                      build_case, rank_prefill_decode)
from repro_torch.launch.mesh import Layout  # noqa: E402
from repro_torch.launch.shardings import (cache_shardings,  # noqa: E402
                                          local_shard)
from repro_torch.models import build_model, mamba2  # noqa: E402
from repro_torch.training.data import TokenStream  # noqa: E402
from repro_torch.training.optimizer import init_adamw  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    make_sharded_train_step, sharding_mechanism)
from test_torch_partition import (B, CACHE, DATA, OPT, REF_TOL,  # noqa: E402
                                  RWKV, STEPS, TOL, WHISPER, ZAMBA, G, S,
                                  _clone, _close, _gspmd, _hand_count,
                                  _rank_run, _threads, _unsharded,
                                  make_ranks)

# zamba2 at model 3: the Mamba2 block's projection and conv (812 and 416
# wide) do not divide 3 while its gated norm and w_out (d_inner 384) do,
# so the block runs whole and gathers those two split leaves at their use
SMALL_ZAMBA = dict(d_model=192, num_heads=3, num_kv_heads=3)
# case -> (arch, reduced(**over), (data, model), plan (mechanism, blocks))
CASES = {
    "rwkv6": ("rwkv6-7b", {}, (2, 2), ("tensor", RWKV)),
    "zamba2": ("zamba2-2.7b", {}, (2, 2), ("per-leaf", ZAMBA)),
    "whisper-pairs": ("whisper-large-v3",
                      dict(num_heads=3, num_kv_heads=3, vocab_size=511),
                      (2, 2), ("per-leaf", dict(WHISPER, embed=G))),
    "zamba2-model-3": ("zamba2-2.7b", SMALL_ZAMBA, (1, 3),
                       ("per-leaf", dict(ZAMBA, embed=G, unembed=G,
                                         mamba=G, mlp=G))),
}
FAMILY_ARCHS = ("rwkv6-7b", "zamba2-2.7b", "whisper-large-v3")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks():
    """``ranks(data, model)``: the thread ranks of that layout, made once
    for the module."""
    made = {}

    def of(data, model):
        if (data, model) not in made:
            made[data, model] = make_ranks(data, model)
        return made[data, model]
    return of


@pytest.fixture(scope="module")
def runs(ranks):
    out = {}
    for case, (arch, over, layout, _) in CASES.items():
        cfg = get_config(arch).reduced(**over)
        ref = _unsharded(cfg)
        mesh = ranks(*layout)
        res = _threads(len(mesh), lambda r: _rank_run(
            mesh[r], cfg, ref, ("train", "prefill", "decode")))
        out[case] = (cfg, ref, mesh, res)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_family_train_step_equals_unsharded(runs, case):
    cfg, ref, ranks, res = runs[case]
    plan = res[0]["plan"]
    assert (plan.mechanism, plan.blocks) == CASES[case][3]
    for r in res:
        for h, want in zip(r["hist"], ref["hist"]):
            for k in ("loss", "xent", "grad_norm", "lr"):
                assert h[k] == pytest.approx(want[k], rel=TOL, abs=1e-9), k
    assert res[0]["gathered"] is not None
    for a, b in zip(tree_leaves(res[0]["gathered"]),
                    tree_leaves(ref["params"])):
        _close(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_family_prefill_and_decode_equal_unsharded(runs, case):
    """Each rank's logits (its rows) and every leaf of its state slices
    (rwkv6's ``S`` on heads and token-shift rows on D, zamba2's conv
    state on its channels and SSD state on its heads, whisper's self-KV
    and cross-KV) as ``cache_shardings`` lays them out, after the
    prefill and after a decode step."""
    cfg, ref, ranks, res = runs[case]
    n = B // ranks[0].data
    for r, mesh in zip(res, ranks):
        rows = slice(mesh.d * n, (mesh.d + 1) * n)
        _close(r["logits"], ref["logits"][rows])
        _close(r["dec_logits"], ref["dec_logits"][rows])
        for key, whole in (("cache", ref["cache"]),
                           ("dec_cache", ref["dec_cache"])):
            want = _zip_map(lambda a, s: local_shard(a, s, mesh), whole,
                            r["specs"])
            for got, w in zip(tree_leaves(r[key]), tree_leaves(want)):
                assert got.shape == w.shape
                _close(got, w)


@pytest.mark.parametrize("case", list(CASES))
def test_family_collectives_are_the_hand_count(runs, case):
    """Each program's collectives on the model group equal the count
    written from the code (``_hand_count``), on every rank and step, and
    none but the fallback's all-gathers a weight leaf: at (1, 3) the
    Mamba2 blocks gather their five split leaves at their use."""
    cfg, ref, ranks, res = runs[case]
    plan = res[0]["plan"]
    model = ranks[0].model
    for r in res:
        assert [c[0] for c in r["train_counts"]] == [
            _hand_count(cfg, plan, "train", model)] * STEPS
        assert r["prefill_counts"][0] == _hand_count(cfg, plan, "prefill",
                                                     model)
        assert r["decode_counts"][0] == _hand_count(cfg, plan, "decode",
                                                    model)
        assert r["prefill_counts"][1] == r["decode_counts"][1] == 0
        if plan.blocks.get("mamba") == G:
            # each block's split leaves (ln_gate, w_out) in two train steps
            # (forward and remat's rerun), a prefill, a decode
            split = [n for n, (_, w) in mamba2.split_widths(cfg).items()
                     if w % model == 0]
            assert split == ["ln_gate", "w_out"]
            assert len(r["gathered_leaves"]) == len(split) * (
                cfg.num_layers * (2 * STEPS + 2))
        else:
            assert r["gathered_leaves"] == []


# --------------------------------------------------------------------------
# Against the reference's GSPMD step at (1, 2)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_step_matches_reference_gspmd(ranks, arch):
    """The port's seeded weights (the two packages' trees share their
    layout, ``bridge.py``) as the reference's params."""
    cfg = get_config(arch).reduced()
    whole = build_model(cfg).init(0, device="cpu")
    jcfg = jax_get_config(arch).reduced()
    jparams = jax.tree.map(jnp.asarray, tree_map(
        lambda a: a.detach().numpy().copy(), whole))
    jhist, jwant = _gspmd(jcfg, jax_build_model(jcfg), jparams)
    mesh = ranks(1, 2)

    def run(r):
        step = make_sharded_train_step(build_model(cfg), OPT, mesh[r],
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
    assert res[0][0] == ("per-leaf" if arch == "zamba2-2.7b" else "tensor")
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
# The dry run of the families on their plans
# --------------------------------------------------------------------------
# (shape, global batch, sequence): a sequence of 24, a length no state
# dim of the reduced configs has (the rule skips a dim of the cache's
# length), so each leaf lies where the split blocks compute on it
DRY_KINDS = (("train_4k", 4, 24), ("prefill_32k", 4, 24),
             ("decode_32k", 4, 24))
DRY_PLANS = {"rwkv6-7b": ("tensor", RWKV),
             "zamba2-2.7b": ("per-leaf", ZAMBA),
             "whisper-large-v3": ("tensor", WHISPER)}


@pytest.mark.parametrize("shape,batch,seq", DRY_KINDS,
                         ids=[k[0] for k in DRY_KINDS])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_dryrun_traces_the_plan(arch, shape, batch, seq):
    """Rank 0's program of each family reduced at (data 2, model 2)
    traced under fake tensors: the row carries the plan, its recorded
    collectives on the model group are the hand count (no all-gather of
    the tree or of the state), none takes a weight leaf, its traced FLOPs
    are within 2x of the analytic share (the gathered whole model was
    8.5-16x at 16)."""
    cfg = adjusted_config(arch, shape).reduced()
    layout = Layout({"data": 2, "model": 2})
    case = build_case(arch, shape, layout, cfg=cfg, batch=batch, seq=seq)
    traced = dryrun.trace_case(case)
    rl = dryrun.roofline_of(case, traced, "2x2", layout)
    assert (case.mechanism, case.plan.blocks) == DRY_PLANS[arch]
    kind = {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode"}[shape]
    on_model = [r for r in traced["records"] if r["name"].startswith(
        "model/")]
    assert len(on_model) == _hand_count(cfg, case.plan, kind, 2)
    assert traced["weight_gathers"] == []
    assert rl.flops_hlo_per_chip <= 2 * rl.flops_per_chip


# --------------------------------------------------------------------------
# The card phase's prefill and decode job, and the decode state's layout
# --------------------------------------------------------------------------
# case -> (arch, reduced(**over), (data, model), batch, {leaf path: the dim
# the rule puts ``model`` on})
SERVE_CASES = {
    # tensor parallelism; the self-KV on kv heads, the cross K/V on the
    # encoder's 16 frames (a prefill extra), 8 a rank
    "whisper": ("whisper-large-v3", {}, (1, 2), B,
                {"self_kv/0": 3, "cross_kv/0": 2}),
    # a batch equal to attn_every (2): the rule's batch axis is then the
    # blocks' dim 1, so the conv and SSD states lie on the batch rows
    "zamba2-rows": ("zamba2-2.7b", {}, (1, 2), 2,
                    {"conv": 2, "ssm": 2, "kv/0": 3}),
    # the Mamba2 blocks split at model 3 (d_inner 384, N 12: every cut
    # divides) while the rule puts the conv state on the window's 3 rows
    "zamba2-model-3": ("zamba2-2.7b", dict(d_model=192, ssm_state=12,
                                           num_heads=3, num_kv_heads=3),
                       (1, 3), B, {"conv": 3, "ssm": 3, "kv/0": 3}),
}


def _spec_at(specs, path):
    for key in path.split("/"):
        specs = specs[int(key)] if key.isdigit() else (
            getattr(specs, key) if hasattr(specs, "_fields") else specs[key])
    return specs


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_family_rank_prefill_decode_equals_unsharded(ranks, case):
    """``cases.rank_prefill_decode`` at (1, m): each rank's prefill logits
    and every leaf of its decode state, and its decode step's, equal the
    unsharded model's on the same weights, the state laid out as
    ``cache_shardings`` lays out the whole one (the prefill makes it so;
    a block computing on another layout gathers it at its use)."""
    arch, over, layout, batch, dims = SERVE_CASES[case]
    cfg = get_config(arch).reduced(**over)
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    r = np.random.default_rng(5)
    tokens = torch.from_numpy(r.integers(0, cfg.vocab_size, (batch, 12),
                                         dtype=np.int32))
    extras = ({"audio_embeds": torch.from_numpy(r.normal(0, 1, (
        batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}
        if cfg.family == "encdec" else {})
    token = tokens[:, -1].clone()
    pos = torch.full((batch,), 12, dtype=torch.int32)
    with torch.no_grad():
        logits, cache = model.prefill(params, tokens, cache_len=CACHE,
                                      **extras)
        first = tree_map(torch.clone, cache)
        dl, cache = model.decode_step(params, cache, token, pos)
    mesh = ranks(*layout)
    got = _threads(len(mesh), lambda i: rank_prefill_decode(
        mesh[i], cfg, 3, tokens, CACHE, token, pos, extras=extras))
    specs = cache_shardings(first, mesh[0], batch_size=batch,
                            cache_seq=CACHE)
    for path, dim in dims.items():
        assert _spec_at(specs, path).index("model") == dim, path
    for g in got:
        assert g["mechanism"] == sharding_mechanism(cfg, layout[1]).mechanism
        _close(g["logits"], logits)
        _close(g["decode_logits"], dl)
        rank = mesh[g["rank"]]
        for key, whole in (("cache", first), ("decode_cache", cache)):
            want = _zip_map(lambda a, s: local_shard(a, s, rank), whole,
                            specs)
            for a, b in zip(tree_leaves(g[key]), tree_leaves(want)):
                assert a.shape == b.shape
                _close(a, b)


def test_family_plans_split_every_leaf_at_16():
    """At a model axis of 16 no family gathers a weight block but
    whisper's tied embedding (51866 does not divide 16), and no plan is
    the whole-model gather of before."""
    for arch in FAMILY_ARCHS:
        plan = sharding_mechanism(get_config(arch), 16)
        gathered = {b for b, m in plan.blocks.items() if m == G}
        assert gathered == ({"embed"} if arch == "whisper-large-v3"
                            else set()), (arch, plan.blocks)
        assert plan.mechanism in ("tensor", "per-leaf")
        assert "model" not in plan.blocks and S in plan.blocks.values()
        cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
        assert sharding_mechanism(cfg, 2).blocks["core"] == S
