"""The port's training stack vs the JAX reference, f32 on the CPU:
``Model.loss`` and its gradients against ``jax.value_and_grad`` of the
reference's loss for the six families of ``tests/test_models_consistency.
py``'s ``CONSISTENCY_ARCHS`` (reduced, bridged weights, with and without
remat, masked), the autograd-wrapped #6 against autograd through its
plain version, one ``adamw_update`` against the reference's, the tests of
``tests/test_training.py`` mirrored (schedule, clip, convergence, the
stream, a 40-step run whose loss falls, the checkpoint round trip and its
errors), ``TokenStream`` batches bit-equal to the reference's, checkpoints
written by one package and loaded by the other both ways, and the
``launch.train`` CLI.

Tolerances: the loss within ``LOSS_TOL`` = 1e-5 (relative); each
gradient leaf within ``GRAD_TOL`` = 5e-4 of its largest magnitude (f32
sums over every position in another order: rwkv6's token-shift weights
read 1.4e-4); the schedule within 1e-6 (relative); the AdamW step's
parameters within 1e-6 and its moments within 1e-6 of their largest
magnitudes; the wrapped #6's gradients within 1e-6."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import synthetic_batch as jax_synthetic_batch  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.training.data import TokenStream as JaxStream  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.migration import tree_leaves  # noqa: E402
from repro_torch.kernels import prefill_attention as pk  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model, synthetic_batch  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.training.trainer import (TrainConfig,  # noqa: E402
                                          make_train_step, train)

CONSISTENCY_ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b", "qwen2-vl-7b",
                     "rwkv6-7b", "zamba2-2.7b", "whisper-large-v3"]
LOSS_TOL, GRAD_TOL = 1e-5, 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The steps here are small: one intra-op thread runs them as fast,
    and keeps them fast beside other test processes on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(a):
    return torch.from_numpy(np.array(a))


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _mask(B, T):
    m = np.random.default_rng(9).random((B, T)) < 0.7
    m[:, 0] = False
    return m


# --------------------------------------------------------------------------
# The loss and its gradients, every family
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", CONSISTENCY_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg = jax_get_config(arch).reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    B, T = 2, 12
    jb = dict(jax_synthetic_batch(jcfg, B, T))
    tb = synthetic_batch(cfg, B, T, device="cpu")
    jb["loss_mask"] = jnp.asarray(_mask(B, T))
    tb["loss_mask"] = t(_mask(B, T))

    def jloss(p):
        return jmodel.loss(p, jb)
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    for remat in (False, True):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss, aux = model.loss(params, tb, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=LOSS_TOL)
        aux = {k: float(v.detach()) for k, v in aux.items()}
        np.testing.assert_allclose(aux["xent"], float(jaux["xent"]),
                                   rtol=LOSS_TOL)
        if "aux" in jaux:
            np.testing.assert_allclose(aux["aux"], float(jaux["aux"]),
                                       rtol=LOSS_TOL, atol=1e-7)
        by_id = {id(p): g for p, g in zip(leaves, grads)}
        for path, want in jax.tree_util.tree_leaves_with_path(jg):
            got = by_id[id(_leaf(params, path))]
            want = np.asarray(want)
            got = np.zeros_like(want) if got is None else got.numpy()
            scale = max(float(np.abs(want).max()), 1e-6)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_TOL * scale,
                                       err_msg=f"{arch} {path}")
    if cfg.num_experts:
        assert aux["aux"] > 0


def test_wrapped_prefill_grads_equal_plain_autograd():
    """``causal_prefill`` (#6 forward, the plain version differentiated
    in backward) against autograd straight through
    ``prefill_attention_plain``, G 1 and G 3, with one input not needing
    a gradient; it calls the kernel wrapper once a forward."""
    gen = torch.Generator().manual_seed(0)
    for H, Hkv in ((4, 4), (6, 2)):
        q, k, v = (torch.randn(2, 9, n, 64, generator=gen)
                   for n in (H, Hkv, Hkv))
        w = torch.randn(2, 9, H, 64, generator=gen)
        full = torch.full((2,), 9, dtype=torch.int32)
        a = [x.clone().requires_grad_() for x in (q, k, v)]
        b = [x.clone().requires_grad_() for x in (q, k, v)]
        (tattn.causal_prefill(*a) * w).sum().backward()
        (pk.prefill_attention_plain(*b, full) * w).sum().backward()
        for x, y in zip(a, b):
            torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=1e-6)
        kk = k.clone()                 # k needs no gradient
        qq, vv = q.clone().requires_grad_(), v.clone().requires_grad_()
        out = tattn.causal_prefill(qq, kk, vv)
        gq, gv = torch.autograd.grad((out * w).sum(), (qq, vv))
        torch.testing.assert_close(gq, a[0].grad, rtol=0, atol=0)
        torch.testing.assert_close(gv, a[2].grad, rtol=0, atol=0)


def test_loss_runs_the_prefill_wrapper_once_a_layer(monkeypatch):
    """The decoder's loss reaches #6's wrapper once a layer a forward:
    L without remat, 2 L with it (the checkpointed layer runs its
    forward again in backward); backward never calls it."""
    calls = []
    real = tattn.prefill_attention

    def spy(q, k, v, lengths=None):
        calls.append(tuple(q.shape))
        return real(q, k, v, lengths)
    monkeypatch.setattr(tattn, "prefill_attention", spy)
    cfg = get_config("llama3.2-3b").reduced(num_layers=3)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = synthetic_batch(cfg, 2, 8, device="cpu")
    for remat, want in ((False, 3), (True, 6)):
        calls.clear()
        opt = topt.init_adamw(params)
        make_train_step(model, topt.AdamWConfig(), remat=remat)(
            params, opt, batch)
        assert len(calls) == want, (remat, calls)


# --------------------------------------------------------------------------
# AdamW, the schedule, the stream (tests/test_training.py, mirrored)
# --------------------------------------------------------------------------
def test_adamw_update_matches_reference():
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "b": (5,), "nested": {"m": (2, 3, 4), "s": (3,)}}

    def draw(tree, scale=1.0):
        return {k: (draw(v, scale) if isinstance(v, dict) else
                    (rng.normal(0, scale, v)).astype(np.float32))
                for k, v in tree.items()}
    p, g = draw(shapes), draw(shapes, 3.0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    jp, jst = jax.tree.map(jnp.asarray, p), jopt.init_adamw(
        jax.tree.map(jnp.asarray, p))
    tp = jax.tree.map(t, p)
    tst = topt.init_adamw(tp)
    for _ in range(3):
        jp, jst, jinfo = jopt.adamw_update(jopt.AdamWConfig(**cfg),
                                           jax.tree.map(jnp.asarray, g),
                                           jst, jp)
        tp, tst, tinfo = topt.adamw_update(topt.AdamWConfig(**cfg),
                                           jax.tree.map(t, g), tst, tp)
    assert int(tst.step) == int(jst.step) == 3
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                   rtol=1e-6)
    for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            w = np.asarray(w)
            np.testing.assert_allclose(_leaf(got, path).numpy(), w, rtol=0,
                                       atol=1e-6 * max(1, np.abs(w).max()))
    # the result keeps each parameter's dtype
    bf = {"w": torch.ones(3, 3, dtype=torch.bfloat16)}
    out, st, _ = topt.adamw_update(topt.AdamWConfig(), {"w": torch.ones(
        3, 3, dtype=torch.bfloat16)}, topt.init_adamw(bf), bf)
    assert out["w"].dtype == torch.bfloat16
    assert st.mu["w"].dtype == torch.float32


def test_schedule_warmup_and_decay():
    cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                           min_lr_frac=0.1)
    lrs = [float(topt.schedule(cfg, s)) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=1e-2)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in range(0, 120, 7):
        assert float(topt.schedule(cfg, torch.tensor(s))) == pytest.approx(
            float(jopt.schedule(jcfg, jnp.asarray(s))), rel=1e-6)


def test_grad_clip():
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}
    st = topt.init_adamw(params)
    cfg = topt.AdamWConfig(grad_clip=1.0, weight_decay=0.0)
    _, _, info = topt.adamw_update(cfg, grads, st, params)
    assert float(info["grad_norm"]) == pytest.approx(400.0)


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([5.0])}
    st = topt.init_adamw(params)
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=1000,
                           weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}        # d/dw w²
        params, st, _ = topt.adamw_update(cfg, grads, st, params)
    assert abs(float(params["w"][0])) < 0.5


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-large-v3",
                                  "qwen2-vl-7b"])
def test_token_stream_bit_equal_to_reference(arch):
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    a = TokenStream(cfg, DataConfig(batch_size=3, seq_len=40, seed=7))
    b = JaxStream(jcfg, JaxDataConfig(batch_size=3, seq_len=40, seed=7))
    for _ in range(3):
        x, y = next(a), next(b)
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    c = next(iter(TokenStream(cfg, DataConfig(seed=7))))
    d = next(iter(TokenStream(cfg, DataConfig(seed=7))))
    assert np.array_equal(c["tokens"], d["tokens"])
    assert c["tokens"].shape == (8, 128)


def test_train_loss_decreases_and_checkpoints(tmp_path):
    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    stream = TokenStream(cfg, DataConfig(batch_size=4, seq_len=32))
    path = str(tmp_path / "ck.npz")
    hist = train(model, params, stream,
                 TrainConfig(steps=40, log_every=10, ckpt_path=path,
                             opt=topt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                                  total_steps=40)))
    assert hist["loss"][-1] < hist["loss"][0]
    restored, step = tckpt.load_checkpoint(path, model.init(1, device="cpu"))
    assert step == 40
    for a, b in zip(tree_leaves(hist["params"]), tree_leaves(restored)):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    tree = {"a": torch.zeros((2, 2))}
    path = str(tmp_path / "x.npz")
    tckpt.save_checkpoint(path, tree)
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, {"a": torch.zeros((3, 3))})
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(path, {"b": torch.zeros((2, 2))})


def test_checkpoints_cross_the_packages(tmp_path):
    """The optimizer state (a named tuple of a step and two param-shaped
    trees) written by the port loads in the reference and back, keys
    equal; params written by the reference (f32, and bf16 as its raw
    bits) load in the port."""
    cfg = get_config("smollm-360m").reduced()
    jcfg = jax_get_config("smollm-360m").reduced()
    params = build_model(cfg).init(0, device="cpu")
    st = topt.init_adamw(params)
    st = st._replace(step=torch.tensor(5, dtype=torch.int32),
                     mu=jax.tree.map(lambda a: a + 0.5, st.mu))
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, st, 5)
    jlike = jopt.init_adamw(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    back, step = jckpt.load_checkpoint(path, jlike)
    assert step == 5 and int(back.step) == 5
    for got, want in ((back.mu, st.mu), (back.nu, st.nu)):
        for path_, leaf in jax.tree_util.tree_leaves_with_path(got):
            np.testing.assert_array_equal(np.asarray(leaf),
                                          _leaf(want, path_).numpy())
    with np.load(path) as z:
        keys = set(z.files)
    jpath = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(jpath, jlike, 5)
    with np.load(jpath) as z:
        assert set(z.files) == keys
    # reference -> port, f32 params and bf16 ones
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        jpath = str(tmp_path / f"ref_{jdtype.__name__}.npz")
        jckpt.save_checkpoint(jpath, jax.tree.map(
            lambda a: a.astype(jdtype), jparams), 7)
        like = build_model(dataclasses.replace(cfg, dtype=dtype)).init(
            1, device="cpu")
        got, step = tckpt.load_checkpoint(jpath, like)
        assert step == 7
        for path_, leaf in jax.tree_util.tree_leaves_with_path(jparams):
            g = _leaf(got, path_)
            assert g.dtype == dtype
            np.testing.assert_array_equal(
                g.float().numpy(),
                np.asarray(leaf.astype(jdtype).astype(jnp.float32)))
    # port bf16 -> reference bf16 (written as f32, exact)
    bf = build_model(dataclasses.replace(cfg, dtype=torch.bfloat16)).init(
        2, device="cpu")
    path = str(tmp_path / "port_bf16.npz")
    tckpt.save_checkpoint(path, bf)
    back, _ = jckpt.load_checkpoint(path, jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), jparams))
    for path_, leaf in jax.tree_util.tree_leaves_with_path(back):
        np.testing.assert_array_equal(np.asarray(leaf.astype(jnp.float32)),
                                      _leaf(bf, path_).float().numpy())


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------
def test_launch_train_cli(tmp_path, capsys):
    path = str(tmp_path / "cli.npz")
    out = launch_train.main(["--device", "cpu", "--reduced", "--steps", "6",
                             "--batch", "2", "--seq", "16", "--ckpt", path])
    assert os.path.exists(path) and len(out["losses"]) == 6  # every step
    assert all(np.isfinite(out["losses"]))
    printed = capsys.readouterr().out
    assert "step    1 loss" in printed and "saved" in printed
    with pytest.raises(SystemExit, match="tensor parallelism"):
        launch_train.main(["--device", "cpu", "--model-parallel", "2"])
