"""The host-RAM KV tier in the port vs the JAX reference, f32 on the CPU.

The port's ``BlockAllocator``/``HostBlockStore`` copy runs the
reference's random engine-shaped programs (admit with two-tier chain
hits, promote, grow, publish, park/unpark, finish, materialize) in
lockstep with the reference's allocator: identical lookups, counters and
host occupancy after every operation, and the tiered invariants hold. A
partially dropped chain never promotes. On the engines: int8 blocks
demote with their scales and promote back bit-exactly; a warm re-admit
after reclaim promotes and decodes the cold tokens; and the demote /
drop / promote counters and streams equal the JAX engine's on the same
trace."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import block_pool as jpool  # noqa: E402
from repro.serving import request as jreq_mod  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import block_pool as tpool  # noqa: E402
from repro_torch.serving import request as treq_mod  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402


# --------------------------------------------------------------------------
# Allocator + host store, in lockstep with the reference
# --------------------------------------------------------------------------
def _observe(a, digests_seen):
    """What an engine can see of an allocator."""
    return (a.free_blocks, a.allocated_blocks, a.reserved_blocks,
            a.parked_blocks, a.headroom_blocks, a.host_blocks_used,
            a.cache_demotions, a.cache_drops, a.cache_promotions,
            sorted(a.head_digests()), sorted(a.host_head_digests()),
            [a.lookup_tiered(d) for d in digests_seen])


def _run_lockstep(seed: int, num_blocks: int, host_blocks: int,
                  n_ops: int) -> None:
    """The reference's tiered random program (``tests/test_prefix_cache.py``
    ``_run_random_tiered_program``) driven on the port's allocator and the
    reference's with the same choices; after every operation both must
    look the same and the port's invariants (device and host tier) hold."""
    rng = np.random.default_rng(seed)
    BS = 4
    allocs = [mod.BlockAllocator(num_blocks, BS, host_blocks=host_blocks)
              for mod in (tpool, jpool)]
    for a in allocs:
        a.set_demote_fetch(lambda b: ("snap", b))
    live = {}        # rid -> [digests, shared, owned, reserved, parked?]
    published = set()
    seen = []
    rid = 0
    for _ in range(n_ops):
        a = allocs[0]
        ops = ["admit", "materialize"]
        if live:
            ops += ["grow", "publish", "finish", "parkflip"]
        op = ops[rng.integers(0, len(ops))]
        if op == "admit":
            nblk = int(rng.integers(1, 5))
            prompt = np.repeat(rng.integers(0, 3, nblk).astype(np.int32), BS)
            digests = tpool.prompt_chain(prompt, BS)
            assert digests == jpool.prompt_chain(prompt, BS)
            seen.append(digests)
            worst = nblk + int(rng.integers(0, 3))
            dev, host_run = a.lookup_tiered(digests)
            need = worst - len(dev) + a.revival_cost(dev)
            if not a.can_reserve(need):
                assert not allocs[1].can_reserve(need)
                continue
            owned = None
            for x in allocs:
                x.reserve(worst - len(dev))
                if dev:
                    x.share(dev)
                payloads = [x.host_pop(h) for h in host_run]
                assert all(p is not None for p in payloads)
                got = x.allocate(nblk - len(dev))
                assert owned is None or got == owned
                owned = got
                for j, h in enumerate(host_run):
                    d0 = len(dev) + j
                    x.publish(owned[j], h, head=(d0 == 0),
                              parent=digests[d0 - 1] if d0 else 0)
            live[rid] = [digests, list(dev), owned, worst - len(dev), None]
            if host_run:
                published.add(rid)
            rid += 1
        elif op == "materialize":
            for x in allocs:
                x.host_materialize(lambda p: ("mat", p))
        elif op == "grow":
            r = sorted(live)[rng.integers(0, len(live))]
            _, _, owned, reserved, parked = live[r]
            if parked is None and reserved > len(owned):
                got = [x.allocate(1) for x in allocs]
                assert got[0] == got[1]
                owned.extend(got[0])
        elif op == "publish":
            r = sorted(live)[rng.integers(0, len(live))]
            if r in published:
                continue
            published.add(r)
            digests, shared, owned, _, _ = live[r]
            table = shared + owned
            for x in allocs:
                for j, h in enumerate(digests):
                    x.publish(table[j], h, head=(j == 0),
                              parent=digests[j - 1] if j else 0)
        elif op == "parkflip":
            r = sorted(live)[rng.integers(0, len(live))]
            digests, shared, owned, _, parked = live[r]
            if parked is not None:
                for x in allocs:
                    x.unpark(parked)
                live[r][4] = None
            elif shared + owned:
                live[r][4] = list(shared + owned)
                for x in allocs:
                    x.park(live[r][4])
        else:   # finish
            r = sorted(live)[rng.integers(0, len(live))]
            digests, shared, owned, reserved, parked = live.pop(r)
            for x in allocs:
                if parked is not None:
                    x.unpark(parked)
                if shared:
                    x.release(shared, owned=False)
                if owned:
                    x.release(owned, owned=True)
                x.unreserve(reserved)
        allocs[0].check_invariants()
        assert _observe(allocs[0], seen) == _observe(allocs[1], seen), op
        assert allocs[0].host_blocks_used <= host_blocks
    for r in sorted(live):                      # drain
        digests, shared, owned, reserved, parked = live.pop(r)
        for x in allocs:
            if parked is not None:
                x.unpark(parked)
            if shared:
                x.release(shared, owned=False)
            if owned:
                x.release(owned, owned=True)
            x.unreserve(reserved)
        allocs[0].check_invariants()
    allocs[0].check_drained()
    assert _observe(allocs[0], seen) == _observe(allocs[1], seen)
    assert allocs[0].cache_evictions == \
        allocs[0].cache_demotions + allocs[0].cache_drops


def _cases():
    """The reference's fixed seeds, then random interleavings drawn from
    a fixed generator (its property test's ranges)."""
    out = [(s, 8 + 2 * s, 1 + s, 60) for s in range(6)]
    rng = np.random.default_rng(2024)
    for _ in range(10):
        out.append((int(rng.integers(0, 2 ** 16)), int(rng.integers(6, 21)),
                     int(rng.integers(1, 11)), int(rng.integers(1, 61))))
    return out


@pytest.mark.parametrize("seed,num_blocks,host_blocks,n_ops", _cases())
def test_tiered_allocator_lockstep_with_reference(seed, num_blocks,
                                                  host_blocks, n_ops):
    _run_lockstep(seed, num_blocks, host_blocks, n_ops)


def test_host_store_lru_cascade_and_single_tier():
    """``HostBlockStore``: LRU eviction drops the oldest entry with every
    host-resident descendant; a re-published digest leaves the host tier
    (single-tier residence); pending payloads materialize once."""
    stores = [mod.HostBlockStore(3) for mod in (tpool, jpool)]
    for st in stores:
        ok = lambda p, st=st: p == 0 or p in st    # noqa: E731
        assert st.put(1, "a", 0, head=True, parent_ok=ok)
        assert st.put(2, "b", 1, head=False, parent_ok=ok)
        assert st.put(9, "z", 0, head=True, parent_ok=ok)
        assert st.materialize(lambda p: p.upper()) == 3
        assert st.materialize(lambda p: p + "!") == 0
        # full: admitting 7 evicts the LRU head 1 AND its child 2
        assert st.put(7, "c", 0, head=True, parent_ok=ok)
        st.discard(9)
        st.check(lambda d: d == 0 or d in st)
    a, b = stores
    assert (a.digests(), a.head_digests(), a.drops, len(a)) == \
        (b.digests(), b.head_digests(), b.drops, len(b))
    assert a.digests() == frozenset({7}) and a.drops == 2
    assert a.pop(7) == "c" and len(a) == 0


def test_partially_dropped_chain_never_promotes():
    """A chain whose demote was cut short (the host tier too small: making
    room for a later block evicted its own head) never advertises a
    promotable run; with room for all of it, the whole chain promotes."""
    prompt = np.repeat(np.arange(3, dtype=np.int32), 4)
    digests = tpool.prompt_chain(prompt, 4)
    for cap, want_host in ((3, 3), (2, 0)):
        a = tpool.BlockAllocator(num_blocks=4, block_size=4, host_blocks=cap)
        a.set_demote_fetch(lambda b: ("snap", b))
        a.reserve(3)
        ids = a.allocate(3)
        for j, h in enumerate(digests):
            a.publish(ids[j], h, head=(j == 0),
                      parent=digests[j - 1] if j else 0)
        a.release(ids)
        a.unreserve(3)
        a.reserve(4)
        a.allocate(4)                          # reclaims the whole chain
        a.check_invariants()
        dev, host_run = a.lookup_tiered(digests)
        assert dev == [] and len(host_run) == want_host
        assert a.host_blocks_used == want_host
        if want_host == 0:
            assert a.host_head_digests() == frozenset()
        assert a.cache_demotions + a.cache_drops >= 3


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("smollm-360m").reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m").reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
    pressure = rng.integers(0, cfg.vocab_size, 320).astype(np.int32)
    return jmodel, jparams, build_model(cfg), params, prompt, pressure


# the reference's pool for this trace: the pressure prompt (21 blocks
# worst) plus 2 of slack, so the cold chain (16 blocks) cannot stay on
# the device through the pressure serve
TIER_KW = dict(max_slots=2, max_seq=512, token_budget=23 * 16,
               block_size=16, prefill_token_budget=64, host_kv_budget=512)


def _drain(eng, req, max_steps=400):
    eng.submit(req)
    for _ in range(max_steps):
        if any(r is req for r in eng.step()):
            return
    raise AssertionError("request did not finish")


def _cold_pressure_warm(eng, mod, prompt, pressure):
    cold = mod.ServeRequest(0, prompt.copy(), 6)
    _drain(eng, cold)
    d0 = eng.cache_demotions
    _drain(eng, mod.ServeRequest(1, pressure.copy(), 6))
    assert eng.cache_demotions > d0, "pressure prompt demoted nothing"
    p0 = eng.cache_promotions
    warm = mod.ServeRequest(2, prompt.copy(), 6)
    _drain(eng, warm)
    assert eng.cache_promotions > p0, "warm re-admit promoted nothing"
    assert warm.cached_tokens > 0
    eng.check_drained()
    return cold, warm


def test_int8_scales_round_trip_demote_promote(setup):
    """The twin of the reference's int8 tier test: int8 blocks demote WITH
    their scales and promote back bit-exactly — the warm re-admit's
    promoted blocks hold the cold run's int8 rows and scales, and it
    decodes the cold tokens."""
    _, _, model, params, prompt, pressure = setup
    eng = Engine(0, model, params, attn_backend="fused", kv_dtype="int8",
                 **TIER_KW)
    cold = treq_mod.ServeRequest(0, prompt.copy(), 6)
    _drain(eng, cold)
    digests = eng._req_digests(cold)
    before = {h: [a[:, eng.allocator._index[h]].clone() for a in eng.cache]
              for h in digests}
    _drain(eng, treq_mod.ServeRequest(1, pressure.copy(), 6))
    assert eng.cache_demotions > 0
    warm = treq_mod.ServeRequest(2, prompt.copy(), 6)
    _drain(eng, warm)
    assert eng.cache_promotions > 0 and warm.cached_tokens > 0
    assert warm.generated == cold.generated
    promoted = 0
    for h, leaves in before.items():
        b = eng.allocator._index.get(h)
        if b is None:
            continue
        for a, want in zip(eng.cache, leaves):
            torch.testing.assert_close(a[:, b], want, rtol=0, atol=0)
        promoted += 1
    assert promoted == len(digests)
    eng.check_drained()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tier_counters_and_streams_match_jax(setup, kv_dtype):
    """Cold serve, a pressure serve that demotes the cold chain, then a
    warm re-admit that promotes it, on the JAX engine and the torch
    engine: the same demote/drop/promote counters, promoted blocks and
    cached tokens, and the warm run decodes the cold tokens on both."""
    jmodel, jparams, model, params, prompt, pressure = setup
    backends = (("fused", "fused") if kv_dtype == "int8"
                else ("dense", "flat"))
    jeng = JaxEngine(0, jmodel, jparams, attn_backend=backends[0],
                     kv_dtype=kv_dtype, **TIER_KW)
    teng = Engine(0, model, params, attn_backend=backends[1],
                  kv_dtype=kv_dtype, **TIER_KW)
    runs = {}
    for name, eng, mod in (("jax", jeng, jreq_mod), ("torch", teng,
                                                      treq_mod)):
        cold, warm = _cold_pressure_warm(eng, mod, prompt, pressure)
        assert warm.generated == cold.generated
        runs[name] = (cold.generated, warm.cached_tokens,
                      eng.cache_demotions, eng.cache_drops,
                      eng.cache_promotions, eng.promoted_blocks_total,
                      eng.allocator.host_blocks_used)
    assert runs["torch"] == runs["jax"]
