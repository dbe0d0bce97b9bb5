"""Sharded training of the families outside the dense decoders (rwkv6,
zamba2, whisper: each block on the rank's shard, the recurrences on the
rank's heads) and of a decoder whose kv heads do not divide the model
axis (the per-leaf partition: its blocks split, q / k / v gathered on
whole heads), on a data x model ``launch.mesh.TrainMesh`` against the
port's unsharded step and the reference's GSPMD step; and the
reference's ``core.bidask`` / ``core.refinement`` import paths.

One 2-rank group serves the module (this process and one
``launch.train_worker``). Each family (reduced: 2 layers) takes 2 AdamW
steps on B 4 x T 32 of ``TokenStream``; every rank stores its shard by
``param_spec`` and all-gathers the activations its split blocks need,
no weight leaf. Both steps are held to the unsharded trajectory from the
same init. One number is not: rwkv6's second step is ill-conditioned
(ROADMAP Queue 3), so far that the unsharded f32 trajectory's step-2
gradient norm lands farther than the tolerance from the exact (f64) one
(``test_rwkv6_second_step_is_ill_conditioned`` holds that witness). At
(1, 2) rwkv6's ``w_o`` sums its rows in two partial sums, so that norm
is held from a common state instead: the sharded second step against
the unsharded step from the sharded run's own state after its first
(``test_sharded_step_from_common_state``).
Tolerances
as ``tests/test_torch_sharded_training.py`` (AdamW at eps 1e-5, which
it explains): metrics within 1e-5 (relative; 1e-4 against the
reference) and equal on every rank, the AdamW moments within 1e-4 of
each leaf's largest magnitude, parameters within 1e-5 (1e-4) of the
largest magnitude (at least 1)."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import bidask as jbidask  # noqa: E402
from repro.core import refinement as jrefinement  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro.training.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.training.data import TokenStream as JaxStream  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.control import bidask as tbidask  # noqa: E402
from repro_torch.control import refinement as trefinement  # noqa: E402
from repro_torch.core import bidask as core_bidask  # noqa: E402
from repro_torch.core import refinement as core_refinement  # noqa: E402
from repro_torch.core.migration import tree_leaves  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            AdamWState, init_adamw)
from repro_torch.training.trainer import (ShardedRun,  # noqa: E402
                                          batch_to, make_train_step,
                                          train_sharded)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import gather_witness  # noqa: E402

METRIC_TOL, MOMENT_TOL, REF_TOL = 1e-5, 1e-4, 1e-4
STEPS, B, T = 2, 4, 32
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS, eps=1e-5)
DATA = DataConfig(batch_size=B, seq_len=T)
# a decoder whose kv heads (3) do not divide 2 while its flattened wq /
# wk / wv (384 / 192 wide) do: param_spec splits them, and the per-leaf
# partition runs them split (its decode cache would split on the head dim)
ODD_HEADS = dict(num_heads=6, num_kv_heads=3)
FAMILIES = {"rwkv6-7b": {}, "zamba2-2.7b": {}, "whisper-large-v3": {},
            "smollm-360m": ODD_HEADS}
RUNS = [(a, (1, 2)) for a in FAMILIES] + [("rwkv6-7b", (2, 1))]
# (arch, layout) -> the (step index, metric) of its trajectory that is
# held from a common state (``test_sharded_step_from_common_state``), not
# on the trajectory: rwkv6's ill-conditioned step-2 gradient norm where
# the model axis reorders its sums
FROM_COMMON_STATE = {("rwkv6-7b", (1, 2)): {(1, "grad_norm")}}


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


def _unsharded(cfg, arrays, state=None):
    """The port's unsharded steps: ``STEPS`` of them from the bridged
    init, or with ``state`` (a sharded run's gathered ``params``, ``mu``
    and ``nu`` after its first step) the steps after the first from that
    state. Returns the metrics of each step taken, the params and the
    AdamW state."""
    model = build_model(cfg)
    it = iter(TokenStream(cfg, DATA))
    if state is None:
        params = bridge.params_from_numpy(arrays, cfg, device="cpu")
        opt, first = init_adamw(params), 0
    else:
        params, first = state["params"], 1
        opt = AdamWState(torch.ones((), dtype=torch.int32), state["mu"],
                         state["nu"])
        next(it)
    step = make_train_step(model, OPT)
    hist = []
    for _ in range(first, STEPS):
        params, opt, m = step(params, opt, batch_to(next(it), "cpu"))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, params, opt


def _gspmd(jcfg, jmodel, jparams):
    """``jax.jit(make_train_step)`` over ``param_shardings`` on
    ``make_host_mesh(model=2)``."""
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


@pytest.fixture(scope="module")
def runs(mesh):
    out = {}
    for arch, over in FAMILIES.items():
        jcfg = jax_get_config(arch).reduced(**over)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        arrays = jax.tree.map(np.asarray, jparams)
        cfg = get_config(arch).reduced(**over)
        ref = _unsharded(cfg, arrays)
        gspmd = _gspmd(jcfg, jmodel, jparams)
        for a, layout in RUNS:
            if a == arch:
                res = mesh.run(train_sharded, ShardedRun(
                    cfg, STEPS, OPT, DATA, init=arrays,
                    gather=("params", "mu", "nu")), layout=layout)
                common = None
                if (arch, layout) in FROM_COMMON_STATE:
                    # the unsharded steps after the first from the
                    # sharded run's own state after it
                    first = mesh.run(train_sharded, ShardedRun(
                        cfg, 1, OPT, DATA, init=arrays,
                        gather=("params", "mu", "nu")), layout=layout)[0]
                    common = _unsharded(cfg, arrays, state=first)
                out[(arch, layout)] = (cfg, res, ref, gspmd, common, arrays)
    return out


def _metrics_close(hist, ref, tol, keys=None, skip=()):
    """Each step's metrics (``keys``, default all) within ``tol``, but
    the ``(step index, key)`` pairs in ``skip``."""
    for i, (h, r) in enumerate(zip(hist, ref)):
        for k in keys or r:
            if (i, k) not in skip:
                assert h[k] == pytest.approx(r[k], rel=tol, abs=1e-9), (
                    k, h, r)


def _state_close(res, ref_params, ref_opt):
    """A sharded run's gathered AdamW moments and params against the
    unsharded ones."""
    for got, want_tree in ((res[0]["mu"], ref_opt.mu),
                           (res[0]["nu"], ref_opt.nu)):
        for a, b in zip(tree_leaves(got), tree_leaves(want_tree)):
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= MOMENT_TOL * scale
    for a, b in zip(tree_leaves(res[0]["params"]), tree_leaves(ref_params)):
        b = b.detach()
        assert float((a - b).abs().max()) <= METRIC_TOL * max(
            1.0, float(b.abs().max()))


@pytest.mark.parametrize("arch,layout", RUNS,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in RUNS])
def test_gathered_step_equals_unsharded(runs, arch, layout):
    cfg, res, (ref_hist, ref_params, ref_opt), *_ = runs[(arch, layout)]
    # the decoder's kv heads do not divide, zamba2's Mamba2 cuts miss its
    # heads' edges: the per-leaf partition; rwkv6 and whisper split every
    # block on whole heads
    want = ("replicated" if layout[1] == 1 else "per-leaf"
            if arch in ("smollm-360m", "zamba2-2.7b") else "tensor")
    assert [r["mechanism"] for r in res] == [want] * 2
    for r in res:
        _metrics_close(r["history"], ref_hist, METRIC_TOL,
                       skip=FROM_COMMON_STATE.get((arch, layout), ()))
        assert r["history"] == [dict(h, ms=x["ms"]) for h, x in
                                zip(res[0]["history"], r["history"])]
    _state_close(res, ref_params, ref_opt)
    shapes = res[1]["shard_shapes"]
    if layout[1] == 2:
        # the rank stores half of each split leaf and gathers it a step
        whole = {p: tuple(a.shape) for p, a in
                 zip(_sorted_paths(ref_params), tree_leaves(ref_params))}
        halved = [p for p in shapes if shapes[p] != whole[p]]
        assert halved and all(
            np.prod(shapes[p]) * 2 == np.prod(whole[p]) for p in halved)
        assert res[1]["collectives"]["model (1x2)"][0] >= STEPS * len(
            halved)
    assert res[1]["forbidden_modules"] == []


@pytest.mark.parametrize("arch,layout", list(FROM_COMMON_STATE),
                         ids=[f"{a}-{d}x{m}" for a, (d, m)
                              in FROM_COMMON_STATE])
def test_sharded_step_from_common_state(runs, arch, layout):
    """The sharded run's steps after the first, every metric, and its
    params and moments after them, against the unsharded steps from its
    own state after the first step."""
    _, res, _, _, (hist, params, opt), _ = runs[(arch, layout)]
    for r in res:
        _metrics_close(r["history"][1:], hist, METRIC_TOL)
    _state_close(res, params, opt)


def test_rwkv6_second_step_is_ill_conditioned(runs):
    """The witness for ``FROM_COMMON_STATE``: the unsharded steps in f64
    (``tools/gather_witness.py``) from the same init. The unsharded f32
    trajectory's step-2 gradient norm lands more than ``METRIC_TOL`` from
    the exact one, its step 1 well within it: f32 does not determine that
    number to the tolerance, whatever the order of its sums. The sharded
    run lands no farther from the exact value than the unsharded one."""
    cfg, res, (ref_hist, _, _), _, _, arrays = runs[("rwkv6-7b", (1, 2))]
    init = bridge.params_from_numpy(arrays, cfg, device="cpu")
    batches = [batch_to(b, "cpu") for b, _ in
               zip(TokenStream(cfg, DATA), range(STEPS))]
    with gather_witness.float64_everywhere():
        exact, _ = gather_witness.steps(
            build_model(cfg), gather_witness._map(init, torch.Tensor.double),
            batches, OPT)

    def gaps(hist):
        return [abs(h["grad_norm"] - e["grad_norm"]) / e["grad_norm"]
                for h, e in zip(hist, exact)]
    unsharded, sharded = gaps(ref_hist), gaps(res[0]["history"])
    assert unsharded[0] < 0.5 * METRIC_TOL < METRIC_TOL < unsharded[1], (
        unsharded)
    assert sharded[1] <= unsharded[1], (sharded, unsharded)


def _sorted_paths(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return [prefix]
    return [p for k in sorted(tree) for p in _sorted_paths(
        tree[k], f"{prefix}/{k}" if prefix else k)]


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_gathered_step_matches_reference_gspmd(runs, arch):
    _, res, _, (jhist, jparams), *_ = runs[(arch, (1, 2))]
    _metrics_close(res[0]["history"], jhist, REF_TOL,
                   keys=("loss", "lr", "grad_norm"))
    got = res[0]["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        err = float(np.abs(leaf.numpy() - want).max())
        assert err <= REF_TOL * max(1.0, float(np.abs(want).max())), (
            path, err)


@pytest.mark.parametrize("port,ref,names", [
    (core_bidask, jbidask, ("KEEP_EARLIEST", "OVERLOAD_FACTOR",
                            "STARVATION_THRESHOLD", "Bid", "MigRequest",
                            "ReceiverState", "SenderState", "is_overloaded",
                            "select_receiver")),
    (core_refinement, jrefinement, ("BoundaryRefiner", "divide_evenly",
                                    "memory_based_split", "optimal_split",
                                    "quantity_based_split"))],
    ids=["bidask", "refinement"])
def test_core_shims_reexport_the_control_plane(port, ref, names):
    """``core.bidask`` / ``core.refinement`` hold the control plane's own
    objects under the reference's shims' names (its every public name)."""
    control = tbidask if port is core_bidask else trefinement
    public = {n for n in vars(ref) if not n.startswith("_")
              and n not in ("annotations",)}
    assert public == set(names)
    for n in names:
        assert getattr(port, n) is getattr(control, n)
