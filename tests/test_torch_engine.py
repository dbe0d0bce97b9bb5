"""The port's Engine (CPU, plain attention) vs the JAX fused engine on the
same weights: identical greedy streams on the trace of
``tests/test_fused_attention.py`` (prompts 5/23/12, chunk budget 8, 8 new
tokens), one attention-bearing forward per step, at most one d2h per step
(exactly one when decodes or first tokens are live), a warm prefix
resubmit, and a clean drain."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.serving.engine as jax_engine_mod  # noqa: E402
import repro_torch.serving.engine as engine_mod  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.request import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest  # noqa: E402

PROMPTS = (5, 23, 12)
NEW = 8


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("smollm-360m").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    return jmodel, jparams, build_model(cfg), params, prompts


@pytest.fixture
def engines():
    """Engines made by a test; each is checked for a clean drain after it
    (the shared conftest check walks only the JAX engine registry)."""
    made = []
    yield made
    for eng in made:
        eng.check_drained()


def _drain(eng, reqs, max_iters=200):
    for r in reqs:
        eng.submit(r)
    out = []
    for _ in range(max_iters):
        out += eng.step()
        if len(out) == len(reqs):
            return out
    raise AssertionError("engine did not drain")


def test_greedy_streams_match_jax_fused_engine(setup, engines):
    jmodel, jparams, model, params, prompts = setup
    jeng = jax_engine_mod.Engine(0, jmodel, jparams, max_slots=3,
                                 max_seq=64, attn_backend="fused",
                                 prefill_token_budget=8)
    assert jeng.fused_mixed
    jreqs = [JaxRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _drain(jeng, jreqs)
    eng = Engine(0, model, params, max_slots=3, max_seq=64,
                 prefill_token_budget=8)
    engines.append(eng)
    assert eng.device.type == "cpu"
    reqs = [ServeRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    _drain(eng, reqs)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [len(r.generated) for r in reqs] == [NEW] * len(PROMPTS)
    assert [r.first_token_step for r in reqs] == \
        [r.first_token_step for r in jreqs]
    assert eng.steps == jeng.steps


def test_one_attn_call_and_at_most_one_d2h_per_step(setup, engines,
                                                    monkeypatch):
    jmodel, jparams, model, params, prompts = setup
    calls = []
    real = engine_mod.d2h
    monkeypatch.setattr(engine_mod, "d2h",
                        lambda x: calls.append(1) or real(x))
    eng = Engine(0, model, params, max_slots=3, max_seq=64,
                 prefill_token_budget=8)
    engines.append(eng)
    reqs = [ServeRequest(i, p.copy(), NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    done = []
    fused = 0
    while len(done) < len(reqs):
        calls.clear()
        a0 = engine_mod.ATTN_CALLS
        gen0 = sum(len(r.generated) for r in reqs)
        done += eng.step()
        assert engine_mod.ATTN_CALLS - a0 == 1
        fused += eng.last_grid["backend"] == "fused"
        # one transfer when tokens reach the host, none on pure-chunk steps
        assert len(calls) == (1 if sum(len(r.generated) for r in reqs)
                              > gen0 else 0)
    assert fused == eng.steps


def test_warm_prefix_resubmit(setup, engines):
    jmodel, jparams, model, params, prompts = setup
    eng = Engine(0, model, params, max_slots=3, max_seq=64,
                 prefill_token_budget=8)
    engines.append(eng)
    cold = ServeRequest(0, prompts[1].copy(), NEW)
    _drain(eng, [cold])
    cold_work = eng.prefill_work_blocks
    warm = ServeRequest(1, prompts[1].copy(), NEW)
    _drain(eng, [warm])
    assert warm.generated == cold.generated
    assert warm.cached_tokens > 0
    assert eng.cached_prompt_tokens_total == warm.cached_tokens
    assert eng.prefill_work_blocks - cold_work < cold_work


def test_rejects_prompts_that_never_fit(setup, engines):
    jmodel, jparams, model, params, prompts = setup
    eng = Engine(0, model, params, max_slots=2, max_seq=16,
                 prefill_token_budget=8)
    engines.append(eng)
    big = ServeRequest(0, prompts[1].copy(), 4)      # 23 + 1 > 16
    ok = ServeRequest(1, prompts[0].copy(), 4)
    _drain(eng, [big, ok])
    assert big.rejected and not big.generated
    assert len(ok.generated) == 4


def test_decode_burst_matches_single_steps(setup, engines, monkeypatch):
    """``step(burst=4)`` runs several decode forwards before its single
    transfer and emits the tokens of four ``step()`` calls."""
    jmodel, jparams, model, params, prompts = setup
    streams = {}
    for burst in (1, 4):
        calls = []
        real = engine_mod.d2h
        monkeypatch.setattr(engine_mod, "d2h",
                            lambda x: calls.append(1) or real(x))
        eng = Engine(0, model, params, max_slots=3, max_seq=64,
                     prefill_token_budget=64)
        engines.append(eng)
        reqs = [ServeRequest(i, p.copy(), 11) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        done, steps = [], 0
        while len(done) < len(reqs):
            calls.clear()
            done += eng.step(burst=burst)
            steps += 1
            assert len(calls) <= 1
        monkeypatch.setattr(engine_mod, "d2h", real)
        streams[burst] = ([r.generated for r in reqs], steps, eng.steps)
    assert streams[4][0] == streams[1][0]
    assert streams[4][1] < streams[1][1]          # fewer host round trips
    assert streams[4][2] == streams[1][2]         # same engine step count
