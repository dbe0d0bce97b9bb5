"""Sharded training in the port, f32 on the CPU: the training layout's
rules against the reference's, and the decoder families' sharded step
(``training.trainer.make_sharded_train_step`` on a data x model
``launch.mesh.TrainMesh``) against the port's unsharded step and the
reference's GSPMD step (conftest gives JAX two virtual devices).

One 2-rank group serves the module: this process (rank 0) and one
``launch.train_worker``, reshaped between (data 1, model 2) and (data 2,
model 1). Each family (reduced: 2 layers) takes 2 AdamW steps on B 4 x
T 32 of ``TokenStream`` with remat (each layer's forward, and its
collectives, run again in backward), as the unsharded step it is held
to.

* **Rules.** ``param_spec`` equals the reference's ``PartitionSpec`` (as
  a tuple) on every arch's reduced and full-width trees at model 2 and
  16, with and without the 2-D expert option; ``zero1_shardings``,
  ``batch_shardings`` and ``cache_shardings`` equal the reference's on
  the (1, 2) and (2, 1) host meshes.
* **Sharded == unsharded** (dense, MoE, VLM at (1, 2) under tensor
  parallelism; dense and MoE at (2, 1), the MoE's data-split aux against
  the whole batch's): ``loss``, ``xent``, ``aux``, ``grad_norm`` within
  ``METRIC_TOL`` = 1e-5 (relative) and equal on every rank; the AdamW
  moments within ``MOMENT_TOL`` = 1e-4 of each leaf's largest magnitude
  (gradients summed over the 128 positions in another order: the tied
  embedding's read 1.1e-5; ``tests/test_torch_training.py`` holds the
  port's gradients to the reference's at 5e-4); the parameters within
  1e-5 of the largest magnitude (at least 1). The steps run AdamW at
  ``eps`` 1e-5: its first steps move an element by ``lr * g / (|g| +
  eps)``, so at the default 1e-8 a gradient element near 1e-7 whose f32
  sums run in another order (~5e-8 apart) moves its parameter up to ~8%
  of lr apart (measured 7.9e-5 at lr 1e-3 here, and rwkv6's ``w_k`` 5.1e-4
  between the port and the reference unsharded, its next gradient norm
  0.27% apart); at 1e-5 such an element moves at most ``lr * 5e-8 /
  1e-5``. A parameter updated on the wrong shard would be off by ~lr.
* **Against the reference**: the same runs against ``jax.jit(
  make_train_step)`` over ``param_shardings`` on ``make_host_mesh(
  model=2)``, on the bridged weights: metrics within 1e-4 (relative),
  parameters within 1e-4 of the largest magnitude.
* **The launcher** (its own AdamW, eps 1e-8): ``launch.train --devices
  cpu,cpu --model-parallel 2`` against one rank (losses within 1e-5), its
  ``--ckpt`` read by the reference's ``load_checkpoint`` (within 1e-4 of
  the one-rank checkpoint: read 1.03e-5 apart); refusals; the mechanism
  by config."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro.training.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.training.data import TokenStream as JaxStream  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.migration import tree_leaves  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shardings as tsh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            init_adamw)
from repro_torch.training.trainer import (ShardedRun,  # noqa: E402
                                          batch_to, make_train_step,
                                          sharding_mechanism,
                                          train_sharded)

METRIC_TOL, MOMENT_TOL, REF_TOL = 1e-5, 1e-4, 1e-4
STEPS, B, T = 2, 4, 32
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS, eps=1e-5)
DATA = DataConfig(batch_size=B, seq_len=T)
DECODERS = ["smollm-360m", "qwen3-moe-30b-a3b", "qwen2-vl-7b"]
# one family of each mechanism (and the MoE's aux) at (data 2, model 1)
RUNS = ([(a, (1, 2)) for a in DECODERS]
        + [("smollm-360m", (2, 1)), ("qwen3-moe-30b-a3b", (2, 1))])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.make_train_mesh(2, ["cpu", "cpu"])
    yield m
    m.close()


def _bridged(arch):
    jcfg = jax_get_config(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jcfg, jmodel, jparams, jax.tree.map(np.asarray, jparams)


def _unsharded(cfg, arrays):
    """The port's unsharded step, STEPS steps: (metrics, params, opt)."""
    model = build_model(cfg)
    params = bridge.params_from_numpy(arrays, cfg, device="cpu")
    opt = init_adamw(params)
    step = make_train_step(model, OPT, remat=True)
    it = iter(TokenStream(cfg, DATA))
    hist = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, batch_to(next(it), "cpu"))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, params, opt


def _gspmd(jcfg, jmodel, jparams, model_parallel=2):
    """The reference's sharded step: ``jax.jit(make_train_step)`` on
    params laid out by ``param_shardings`` on the host mesh."""
    mesh = jmesh.make_host_mesh(model=model_parallel)
    jcfg_opt = jopt.AdamWConfig(lr=OPT.lr, eps=OPT.eps,
                                warmup_steps=OPT.warmup_steps,
                                total_steps=OPT.total_steps)
    with mesh:
        params = jax.device_put(jparams, jsh.param_shardings(jparams, mesh))
        opt = jopt.init_adamw(params)
        step = jax.jit(jtrainer.make_train_step(jmodel, jcfg_opt))
        it = iter(JaxStream(jcfg, JaxDataConfig(batch_size=B, seq_len=T)))
        hist = []
        for _ in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in next(it).items()}
            params, opt, m = step(params, opt, batch)
            hist.append({k: float(v) for k, v in m.items()})
    return hist, jax.tree.map(np.asarray, params)


def _close_params(got, want, tol):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        b = b.detach()
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), (err, b.shape)


def _close_tree(got, want, tol):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol * scale, tuple(b.shape)


def _metrics_close(hist, ref, tol, keys=None):
    for h, r in zip(hist, ref):
        for k in keys or r:
            assert h[k] == pytest.approx(r[k], rel=tol, abs=1e-9), (k, h, r)


# --------------------------------------------------------------------------
# The rules against the reference's
# --------------------------------------------------------------------------
def _shape_paths(tree):
    return [(jsh._path_str(p), tuple(leaf.shape)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_param_spec_equals_reference(arch):
    """Every leaf of the reduced tree (the port's own: the same paths and
    shapes as the reference's) and of the full-width shape tree, at model
    2 and 16, plain and with the 2-D expert option at data 2 and 16."""
    jcfg = jax_get_config(arch)
    full = _shape_paths(jax.eval_shape(jax_build_model(jcfg).init,
                                       jax.random.PRNGKey(0)))
    red_j = _shape_paths(jax.eval_shape(
        jax_build_model(jcfg.reduced()).init, jax.random.PRNGKey(0)))
    port = build_model(get_config(arch).reduced()).init(0, device="cpu")
    red_t = sorted((p, tuple(a.shape)) for p, a in tsh.param_leaves(port))
    assert red_t == sorted(red_j)
    for path, shape in full + red_j:
        for model in (2, 16):
            assert tsh.param_spec(path, shape, model) == tuple(
                jsh.param_spec(path, shape, model)), (path, shape, model)
            for data in (2, 16):
                want = jsh.param_spec(path, shape, model, expert_2d=True,
                                      data_size=data)
                assert tsh.param_spec(path, shape, model, expert_2d=True,
                                      data_size=data) == tuple(want)


def _spec_leaves(tree):
    """The spec leaves of a port spec tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if hasattr(tree, "_fields"):
        return [s for t in tree for s in _spec_leaves(t)]
    return [tree]


@pytest.mark.parametrize("model_parallel", [2, 1])
def test_zero1_batch_cache_shardings_equal_reference(model_parallel):
    jm = jmesh.make_host_mesh(model=model_parallel)
    tm = tmesh.make_host_mesh(model=model_parallel, n=2)
    assert tm.shape == dict(jm.shape)
    assert tmesh.batch_axes(tm) == jmesh.batch_axes(jm)
    for arch in ("smollm-360m", "qwen3-moe-30b-a3b", "rwkv6-7b",
                 "zamba2-2.7b", "whisper-large-v3", "qwen2-vl-7b"):
        jcfg = jax_get_config(arch).reduced()
        jmodel = jax_build_model(jcfg)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        want = {jsh._path_str(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    jsh.zero1_shardings(shapes, jm))[0]}
        port = build_model(get_config(arch).reduced())
        params = port.init(0, device="cpu")
        assert tsh.zero1_shardings(params, tm) == want, arch
        assert tsh.param_shardings(params, tm) == {
            jsh._path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jsh.param_shardings(shapes, jm))[0]}
        for bsz in (2, 3):
            batch = TokenStream(port.cfg, DataConfig(batch_size=bsz,
                                                     seq_len=8)).__next__()
            got = tsh.batch_shardings(batch, tm)
            ref = jsh.batch_shardings(
                {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in batch.items()}, jm)
            assert got == {k: tuple(v.spec) for k, v in ref.items()}
        for kw in (dict(batch_size=2, cache_seq=16),
                   dict(batch_size=2, cache_seq=16, seq_on_model=True),
                   dict(batch_size=1, cache_seq=16, context_parallel=True)):
            cache = port.init_cache(kw["batch_size"], kw["cache_seq"],
                                    device="cpu")
            jcache = jax.eval_shape(lambda: jmodel.init_cache(
                kw["batch_size"], kw["cache_seq"]))
            got = _spec_leaves(tsh.cache_shardings(cache, tm, **kw))
            ref = [tuple(s.spec) for s in jax.tree.leaves(
                jsh.cache_shardings(jcache, jm, **kw))]
            assert got == ref, (arch, kw)
    assert tsh.replicated(tm) == tuple(jsh.replicated(jm).spec)


def test_layouts_and_mechanisms():
    """The reference's layouts; the mechanism by config."""
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).axis_names == (
        "pod", "data", "model")
    assert tmesh.batch_axes(tmesh.make_production_mesh(multi_pod=True)) \
        == ("pod", "data")
    assert tmesh.make_host_mesh(model=4, n=2).shape == {"data": 1,
                                                        "model": 2}
    assert tmesh.make_host_mesh(model=2, n=8).shape == {"data": 4,
                                                        "model": 2}
    got = {a: sharding_mechanism(get_config(a), 2)[0] for a in (
        "llama3.2-3b", "smollm-360m", "qwen3-moe-30b-a3b", "qwen2-vl-7b",
        "rwkv6-7b", "zamba2-2.7b", "whisper-large-v3")}
    # smollm at full width: H 15, Hkv 5 do not divide 2
    assert got == {"llama3.2-3b": "tensor", "smollm-360m": "gather",
                   "qwen3-moe-30b-a3b": "tensor", "qwen2-vl-7b": "tensor",
                   "rwkv6-7b": "gather", "zamba2-2.7b": "gather",
                   "whisper-large-v3": "gather"}
    gshard = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                                 moe_impl="gshard")
    assert sharding_mechanism(gshard, 2)[0] == "gather"
    assert sharding_mechanism(get_config("llama3.2-3b"), 1)[0] == \
        "replicated"


def test_refusals():
    """Ranks that do not split into model groups are refused before any
    process starts; so is nccl on ranks sharing a device."""
    with pytest.raises(ValueError, match="do not split"):
        tmesh.make_train_mesh(2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="one rank per card"):
        tmesh.make_train_mesh(2, ["cpu", "cpu"], "nccl")
    with pytest.raises(SystemExit, match="do not split into model groups"):
        launch_train.main(["--device", "cpu", "--devices", "cpu,cpu,cpu",
                           "--model-parallel", "2", "--reduced"])


def test_backend_follows_devices():
    """With no backend named, the devices settle it: gloo on the CPU or
    where ranks share a card, nccl when each rank has a card of its own;
    nccl named on a shared card is refused, and so is a card without its
    index, before any rank starts."""
    check = tmesh._check_backend
    assert check(["cpu", "cpu"], None) == "gloo"
    assert check(["cuda:0", "cuda:0"], None) == "gloo"
    assert check(["cuda:0", "cuda:1"], None) == "nccl"
    assert check(["cuda:0", "cuda:1"], "gloo") == "gloo"
    with pytest.raises(ValueError, match="one rank per card"):
        check(["cuda:0", "cuda:0"], "nccl")
    with pytest.raises(ValueError, match="name the card"):
        check(["cuda", "cuda"], None)


# --------------------------------------------------------------------------
# The sharded step: against the port's unsharded step and the reference
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(mesh):
    """Every run of RUNS on the module's group, and its references."""
    out = {}
    for arch in DECODERS:
        jcfg, jmodel, jparams, arrays = _bridged(arch)
        cfg = get_config(arch).reduced()
        ref = _unsharded(cfg, arrays)
        gspmd = _gspmd(jcfg, jmodel, jparams)
        for a, layout in RUNS:
            if a == arch:
                res = mesh.run(train_sharded, ShardedRun(
                    cfg, STEPS, OPT, DATA, init=arrays,
                    remat=True, gather=True), layout=layout)
                out[(arch, layout)] = (res, ref, gspmd)
    return out


@pytest.mark.parametrize("arch,layout", RUNS,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in RUNS])
def test_sharded_step_equals_unsharded(runs, arch, layout):
    res, (ref_hist, ref_params, ref_opt), _ = runs[(arch, layout)]
    want = "tensor" if layout[1] > 1 else "replicated"
    assert [r["mechanism"] for r in res] == [want] * 2
    assert [r["coords"] for r in res] == [
        {"data": r // layout[1], "model": r % layout[1]} for r in range(2)]
    for r in res:
        _metrics_close(r["history"], ref_hist, METRIC_TOL)
        # the metrics are the whole batch's, the same on every rank
        assert r["history"] == [dict(h, ms=x["ms"]) for h, x in
                                zip(res[0]["history"], r["history"])]
    if get_config(arch).num_experts:     # the data-split aux: the batch's
        assert res[0]["history"][0]["aux"] > 0
    _close_tree(res[0]["mu"], ref_opt.mu, MOMENT_TOL)
    _close_tree(res[0]["nu"], ref_opt.nu, MOMENT_TOL)
    _close_params(res[0]["params"], ref_params, METRIC_TOL)
    # the shards: split leaves half as wide on each rank at model 2
    if layout[1] == 2:
        cfg = get_config(arch).reduced()
        wq = res[1]["shard_shapes"]["layers/attn/wq"]
        assert wq[-1] == cfg.num_heads * cfg.head_dim // 2
        assert res[1]["collectives"]["model (1x2)"][0] > 0
    else:
        assert res[1]["collectives"]["data (2x1)"][0] > 0
    assert res[1]["forbidden_modules"] == []


@pytest.mark.parametrize("arch", DECODERS)
def test_sharded_step_matches_reference_gspmd(runs, arch):
    res, _, (jhist, jparams) = runs[(arch, (1, 2))]
    _metrics_close(res[0]["history"], jhist, REF_TOL,
                   keys=("loss", "lr", "grad_norm"))
    got = res[0]["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        scale = max(1.0, float(np.abs(want).max()))
        err = float(np.abs(leaf.numpy() - want).max())
        assert err <= REF_TOL * scale, (path, err)


def test_launcher_sharded_equals_one_rank_and_checkpoint_crosses(
        tmp_path, capsys):
    """``launch.train --devices cpu,cpu --model-parallel 2`` prints the
    mechanism first and the reference's lines; its losses equal one
    rank's within 1e-5; its checkpoint (the gathered whole tree) loads
    in the reference, within 1e-4 of the one-rank run's (AdamW at eps
    1e-8, see the module's docstring)."""
    argv = ["--device", "cpu", "--arch", "smollm-360m", "--reduced",
            "--steps", "4", "--batch", "2", "--seq", "16"]
    p1, p2 = str(tmp_path / "one.npz"), str(tmp_path / "two.npz")
    one = launch_train.main(argv + ["--ckpt", p1])
    capsys.readouterr()
    two = launch_train.main(argv + ["--devices", "cpu,cpu",
                                    "--model-parallel", "2", "--ckpt", p2])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("2 ranks on cpu,cpu over gloo: (data 1, "
                                 "model 2); tensor parallelism")
    assert printed[1].startswith("step    1 loss") and "saved" in printed[-1]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    like = jax_build_model(jax_get_config("smollm-360m").reduced()).init(
        jax.random.PRNGKey(0))
    a, sa = jckpt.load_checkpoint(p1, like)
    b, sb = jckpt.load_checkpoint(p2, like)
    assert sa == sb == 4
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert np.abs(x - y).max() <= REF_TOL * max(1.0, np.abs(x).max())
