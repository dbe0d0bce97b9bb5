"""On the card: tensor-parallel engines with two ranks on one card
(``cuda:0,cuda:0`` over gloo) against the CPU's tp=1 engine on the same
weights (llama3.2-3b at full width, 2 layers, f32): equal greedy streams
on the fused, flat and grid backends, each rank launching the backend's
kernels layers x forwards times, no token read on the worker. Every test
here needs a CUDA card and skips without one; none imports JAX."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as dk  # noqa: E402
from repro_torch.kernels import mixed_attention as tk  # noqa: E402
from repro_torch.kernels import prefill_attention as pk  # noqa: E402
from repro_torch.launch.mesh import make_tp_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest, State  # noqa: E402

LENS = [(40, 6), (130, 6), (17, 6)]
KW = dict(max_slots=4, max_seq=512, token_budget=1024)
# backend -> the launch counters its engine runs (module, attribute)
KERNELS = {"fused": [(tk, "LAUNCHES", "fused")],
           "flat": [(dk, "LAUNCHES", "flat_decode"),
                    (pk, "LAUNCHES", "chunked_prefill")],
           "grid": [(dk, "GRID_LAUNCHES", "grid_decode"),
                    (pk, "LAUNCHES", "chunked_prefill")]}


@pytest.fixture(scope="module")
def card():
    """The card, decided here (never at import or collection time), and
    a mesh of two ranks on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_tp_mesh(2, ["cuda:0", "cuda:0"], "gloo")
    yield mesh
    mesh.close()


def _cpu(tree):
    return {k: _cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def _drive(eng, vocab):
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(i, rng.integers(0, vocab, p).astype(np.int32), n)
            for i, (p, n) in enumerate(LENS)]
    for r in reqs:
        eng.submit(r)
    for _ in range(400):
        eng.step()
        if all(r.state is State.FINISHED for r in reqs):
            return [list(r.generated) for r in reqs]
    raise AssertionError("requests did not finish")


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "flat", "grid"])
def test_tp2_on_one_card_equals_cpu_tp1(card, backend):
    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=2,
                              dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    want = _drive(Engine(0, model, _cpu(params), attn_backend="dense", **KW),
                  cfg.vocab_size)
    for m, a, _ in KERNELS[backend]:
        setattr(m, a, 0)
    card.zero_worker_stats()
    a0 = engine_mod.ATTN_CALLS
    eng = Engine(0, model, params, attn_backend=backend, tp=2, mesh=card,
                 **KW)
    got = _drive(eng, cfg.vocab_size)
    forwards = engine_mod.ATTN_CALLS - a0
    worker = card.worker_stats()[0]
    eng.shutdown()
    assert got == want
    assert worker["attn_calls"] == forwards and worker["d2h"] == 0
    leader = sum(getattr(m, a) for m, a, _ in KERNELS[backend])
    assert leader == cfg.num_layers * forwards
    assert sum(worker["launches"][k] for _, _, k in KERNELS[backend]) \
        == leader
