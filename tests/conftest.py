import os
import sys

# src-layout import path (tests runnable without install)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Two virtual host devices so the tensor-parallel serving tests
# (tests/test_tp_engine.py, DESIGN.md §Sharded serving) get a real
# 2-device mesh on CPU. Must land before the first jax import anywhere
# in the session — conftest is imported before every test module, and
# launch/dryrun.py uses the same flag for its 512-chip dry run.
# Single-device code paths are unaffected: default placement stays on
# device 0 and tp=1 engines never enter shard_map.
if "xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=2")

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# Optional-dependency shim: ``hypothesis`` drives the property tests but is
# not part of the core runtime. When it is missing, install a stub module
# whose ``@given`` marks the test skipped (instead of failing collection of
# the whole module). Real hypothesis, when installed, is used untouched.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    import types

    def _given(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed (see requirements.txt)")(fn)
        return deco

    def _settings(*_a, **_k):
        def deco(fn):
            return fn
        return deco

    class _Strategy:
        """Inert placeholder: composable like a strategy, never executed."""

        def __call__(self, *a, **k):
            return self

        def __getattr__(self, _name):
            return self

    _st = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "floats", "lists", "tuples", "booleans",
                  "sampled_from", "text", "composite", "just", "one_of",
                  "dictionaries", "fixed_dictionaries"):
        setattr(_st, _name, _Strategy())

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.assume = lambda *_a, **_k: True
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


# ---------------------------------------------------------------------------
# Drain-time leak check (DESIGN.md §Fault tolerance): after every test,
# walk all engines constructed so far and assert their allocator state is
# consistent — a migration rollback or crash path that leaks block
# reservations fails the very test that leaked, not some later one.
# Engines a test deliberately crashed are flagged ``_faulted`` and skipped.
# The engine module is looked up via sys.modules so tests that never touch
# the (jax-heavy) serving stack pay nothing.
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _engine_leak_check():
    yield
    eng_mod = sys.modules.get("repro.serving.engine")
    if eng_mod is None:
        return
    live = []
    for ref in eng_mod._LIVE_ENGINES:
        eng = ref()
        if eng is None:
            continue
        live.append(ref)
        if getattr(eng, "_faulted", False) or eng.cache is None:
            continue
        eng.check_drained(strict=False)
    eng_mod._LIVE_ENGINES[:] = live


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one (run on the "
        "card with `python -m pytest -m gpu tests/test_torch_kernels.py`)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def qoe_linear():
    """A hand-built QoE model with plausible positive coefficients."""
    from repro.core.qoe import QoEModel
    return QoEModel(np.array([5e-3, 5e-4, 2e-7, 1e-12, 3e-7]))
