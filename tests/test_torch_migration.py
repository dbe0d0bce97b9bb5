"""Live KV migration through the port's engines, f32 on the CPU, same
weights as the JAX package: a request exported mid-decode or mid-prefill
from a JAX engine, carried through numpy (``repro_torch.bridge``) and
imported into a torch engine continues with the tokens the unmigrated
JAX run gives; the reverse direction holds too; and between two torch
engines the exported piece is exactly the request's written pool rows.
The wire is the contiguous ``[L, 1, written, Hkv, Dh]`` piece."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.attention import KVCache as JaxKVCache  # noqa: E402
from repro.serving import request as jreq_mod  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.migration import kv_bytes  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import request as treq_mod  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

PROMPT, NEW, BUDGET = 30, 14, 8
KW = dict(max_slots=2, max_seq=96, prefill_token_budget=BUDGET)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("smollm-360m").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, PROMPT).astype(np.int32)
    # the unmigrated JAX stream of the request
    eng = JaxEngine(0, jmodel, jparams, attn_backend="dense", **KW)
    ref = jreq_mod.ServeRequest(0, prompt.copy(), NEW)
    eng.submit(ref)
    _until_done(eng, ref)
    return jmodel, jparams, build_model(cfg), params, prompt, ref.generated


def _until_done(eng, req, limit=200):
    for _ in range(limit):
        if any(r is req for r in eng.step()):
            return
    raise AssertionError("request did not finish")


def _run_until(eng, req, *, prefilling):
    """Step until the request is mid-prefill (ctx_done of 2 chunks) or
    decoding with a few generated tokens; returns its slot."""
    for _ in range(50):
        eng.step()
        if prefilling and req.ctx_done == 2 * BUDGET:
            assert req.prefilling
            return req.slot
        if not prefilling and len(req.generated) >= 5:
            assert not req.prefilling
            return req.slot
    raise AssertionError("request never reached the export point")


def _carry(req, dst_mod):
    """The request's state as the destination package's ServeRequest."""
    out = dst_mod.ServeRequest(req.req_id, req.prompt.copy(),
                               req.max_new_tokens)
    out.generated = list(req.generated)
    out.ctx_done = req.ctx_done
    out.first_token_step = req.first_token_step
    out.state = dst_mod.State.RUNNING
    return out


@pytest.mark.parametrize("prefilling", [False, True],
                         ids=["mid-decode", "mid-prefill"])
def test_jax_to_torch_continues_like_the_unmigrated_run(setup, prefilling):
    jmodel, jparams, model, params, prompt, want = setup
    src = JaxEngine(0, jmodel, jparams, attn_backend="dense", **KW)
    req = jreq_mod.ServeRequest(0, prompt.copy(), NEW)
    src.submit(req)
    slot = _run_until(src, req, prefilling=prefilling)
    _, piece, nbytes = src.export_slot(slot)
    written = req.ctx_done if prefilling else req.length - 1
    assert piece.k.shape[:3] == (model.cfg.num_layers, 1, written)
    tpiece = bridge.pool_from_numpy(jax.tree.map(np.asarray, piece),
                                    device="cpu")
    moved = _carry(req, treq_mod)
    src.evict_slot(slot)
    dst = Engine(1, model, params, attn_backend="flat", **KW)
    assert dst.import_request(moved, tpiece)
    assert kv_bytes(tpiece) == nbytes
    assert dst.slots[moved.slot] is moved and moved.engine_id == 1
    _until_done(dst, moved)
    assert moved.generated == want
    dst.check_drained()
    src.check_drained()


@pytest.mark.parametrize("prefilling", [False, True],
                         ids=["mid-decode", "mid-prefill"])
def test_torch_to_jax_continues_like_the_unmigrated_run(setup, prefilling):
    jmodel, jparams, model, params, prompt, want = setup
    src = Engine(0, model, params, attn_backend="flat", **KW)
    req = treq_mod.ServeRequest(0, prompt.copy(), NEW)
    src.submit(req)
    slot = _run_until(src, req, prefilling=prefilling)
    _, piece, nbytes = src.export_slot(slot)
    k, v = bridge.pool_to_numpy(piece)
    moved = _carry(req, jreq_mod)
    src.evict_slot(slot)
    src.check_drained()
    dst = JaxEngine(1, jmodel, jparams, attn_backend="dense", **KW)
    assert dst.import_request(moved, JaxKVCache(jnp.asarray(k),
                                                jnp.asarray(v)))
    assert k.nbytes + v.nbytes == nbytes
    _until_done(dst, moved)
    assert moved.generated == want


@pytest.mark.parametrize("backend", ["flat", "fused"])
def test_torch_to_torch_piece_is_the_written_rows(setup, backend):
    """Between two torch engines: the piece holds exactly the request's
    written pool rows, the receiver's pool holds them after import, and
    the request continues with the unmigrated stream. The sender keeps
    nothing."""
    _, _, model, params, prompt, want = setup
    src = Engine(0, model, params, attn_backend=backend, **KW)
    dst = Engine(1, model, params, attn_backend=backend, **KW)
    req = treq_mod.ServeRequest(0, prompt.copy(), NEW)
    src.submit(req)
    slot = _run_until(src, req, prefilling=False)
    written = int(src.slot_len[slot]) - 1
    BS = src.block_size
    rows = np.concatenate([src.cache.k[:, b].numpy()
                           for b in src.block_tables[slot]], axis=1)
    _, piece, _ = src.export_slot(slot)
    np.testing.assert_array_equal(piece.k[:, 0].numpy(), rows[:, :written])
    assert dst.import_request(req, piece)
    src.evict_slot(slot)
    src.check_drained()
    got = np.concatenate([dst.cache.k[:, b].numpy()
                          for b in dst.block_tables[req.slot]], axis=1)
    np.testing.assert_array_equal(got[:, :written], rows[:, :written])
    assert len(dst.block_tables[req.slot]) == -(-req.length // BS)
    _until_done(dst, req)
    assert req.generated == want
    dst.check_drained()


def test_import_refuses_what_cannot_fit(setup):
    """A receiver with no free slot, or whose max_seq cannot hold the
    remaining generation, refuses the import and holds nothing."""
    _, _, model, params, prompt, _ = setup
    src = Engine(0, model, params, attn_backend="flat", **KW)
    req = treq_mod.ServeRequest(0, prompt.copy(), NEW)
    src.submit(req)
    slot = _run_until(src, req, prefilling=False)
    _, piece, _ = src.export_slot(slot)
    short = Engine(1, model, params, attn_backend="flat", max_slots=2,
                   max_seq=PROMPT + 8, prefill_token_budget=BUDGET)
    assert not short.import_request(req, piece)
    full = Engine(2, model, params, attn_backend="flat", max_slots=1,
                  max_seq=96, prefill_token_budget=BUDGET)
    other = treq_mod.ServeRequest(1, prompt[:9].copy(), 40)
    full.submit(other)
    full.step()
    assert not full.import_request(req, piece)
    assert req.slot == slot and req.engine_id == 0
    for eng in (short, full):
        assert eng.allocator.allocated_blocks == len(
            [b for r in eng.slots if r is not None
             for b in eng.block_tables[r.slot]])
    _until_done(src, req)
    _until_done(full, other)
    for eng in (src, short, full):
        eng.check_drained()
