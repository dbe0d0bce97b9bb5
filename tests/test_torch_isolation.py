"""The port stands alone: importing every module of ``repro_torch`` loads
neither ``jax`` nor the JAX package, no module of the port (nor
``chip_smoke.py`` or the port's tools) names either in an import, and
none carries the reference's TPU v5e cost constants."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('repro_torch')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 15                       # every module imported
    # the modules of the int8, preemption, host tier and fault paths, and
    # the contiguous kernels' oracles and entry points
    assert {"repro_torch.sched.policy", "repro_torch.sched.slo",
            "repro_torch.control.faults", "repro_torch.serving.block_pool",
            "repro_torch.sim.metrics", "repro_torch.kernels.ref",
            "repro_torch.kernels.api"} <= loaded
    # the simulator, its cost model and the experiment driver
    assert {"repro_torch.sim." + m for m in (
        "events", "costmodel", "instance", "cluster", "profiler",
        "experiment", "workload")} <= loaded
    assert "repro_torch.kernels.cost" in loaded
    # the MoE and VLM decoder families' modules
    assert {"repro_torch.models." + m for m in (
        "mlp", "attention", "transformer", "model")} <= loaded
    # the hybrid and encoder-decoder families and the training stack
    assert {"repro_torch.models.mamba2", "repro_torch.models.whisper",
            "repro_torch.launch.train"} | {
        "repro_torch.training." + m for m in (
            "optimizer", "data", "checkpoint", "trainer")} <= loaded
    # tensor-parallel serving: the mesh, the sharding rules, the worker;
    # sharded training's rank process; the reference's import shims
    assert {"repro_torch.launch." + m for m in (
        "mesh", "shardings", "tp_worker", "train_worker")} <= loaded
    assert {"repro_torch.core.bidask", "repro_torch.core.refinement"} \
        <= loaded


def test_the_tp_worker_loads_no_jax_and_no_repro():
    """A tensor-parallel worker's process, as ``make_tp_mesh`` starts it
    (``python -m repro_torch.launch.tp_worker``), imports neither JAX nor
    the JAX package: its module and everything it pulls in."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['tp_worker', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.tp_worker',\n"
        "                     run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.serving.engine' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_the_train_worker_loads_no_jax_and_no_repro():
    """A training rank's process, as ``make_train_mesh`` starts it
    (``python -m repro_torch.launch.train_worker``), and the job it runs
    (``training.trainer.train_sharded``) import neither JAX nor the JAX
    package."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['train_worker', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.train_worker',\n"
        "                     run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "import repro_torch.training.trainer\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {n}"


# the reference's TPU v5e constants (repro.kernels.cost: PEAK_FLOPS,
# HBM_BW, ICI_BW, HOST_STAGING_BW): the port prices on its own chip
TPU_CONSTANTS = (197e12, 819e9, 50e9, 16e9)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_carries_the_tpu_constants(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant)
                and isinstance(node.value, (int, float))
                and not isinstance(node.value, bool)):
            assert node.value not in TPU_CONSTANTS, \
                f"{path.name}:{node.lineno} holds {node.value!r}"
