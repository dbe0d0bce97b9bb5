"""The port's cost model, migration timing, park-vs-recompute pricing,
QoE fit, event queue and workload generators against the JAX package's,
on the CPU.

The port prices on a ``Chip``; built here from the reference's TPU v5e
constants (read from ``repro.kernels.cost``, block 512, the reference
profile's ``t_fixed``), every pricing function of ``kernels/cost.py`` and
``sim/costmodel.py`` must give the reference's floats exactly, over
lengths, backends, KV dtypes, tensor-parallel ways and all eleven
configs. On the port's own ``H100`` the model is checked for what the
card's numbers imply."""
import dataclasses
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.migration as jmig  # noqa: E402
import repro.core.qoe as jqoe  # noqa: E402
import repro.kernels.cost as jcost  # noqa: E402
import repro.sched.policy as jpolicy  # noqa: E402
import repro.sim.costmodel as jcm  # noqa: E402
import repro.sim.events as jevents  # noqa: E402
import repro.sim.workload as jwl  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import migration as mig  # noqa: E402
from repro_torch.core import qoe  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.sched import policy  # noqa: E402
from repro_torch.sim import costmodel as cm  # noqa: E402
from repro_torch.sim import events  # noqa: E402
from repro_torch.sim import workload as wl  # noqa: E402

TPU = cost.Chip(
    name="reference constants", peak_flops=jcost.PEAK_FLOPS,
    hbm_bw=jcost.HBM_BW, link_bw=jcost.ICI_BW,
    launch_overhead_s=jcost.LAUNCH_OVERHEAD_S,
    skip_overhead_s=jcost.SKIP_OVERHEAD_S,
    host_staging_bw=jcost.HOST_STAGING_BW,
    staging_overhead_s=jcost.LAUNCH_OVERHEAD_S,
    attn_block=jcost.AttnSpec(1, 1, 1).block_s,
    t_fixed_s=jcm.HardwareProfile.__dataclass_fields__["t_fixed"].default)

# (q heads, kv heads, head dim, kv dtype)
SPECS = [(24, 8, 128, "bf16"), (24, 8, 128, "int8"), (32, 4, 128, "bf16"),
         (40, 8, 128, "int8"), (20, 20, 64, "bf16"), (32, 32, 80, "bf16")]
LENGTHS = [[], [1], [100], [512], [513, 7, 9000], [200] * 5 + [10000] * 5,
           [0, 3, 4096, 131000], list(range(1, 2000, 37))]
CHUNKS = [(1, 0), (100, 0), (256, 0), (256, 17), (256, 4096), (2048, 0),
          (37, 131000)]
MIXED = [([], [512, 7]), ([(256, 0)], []), ([(256, 4096)], [2048] * 8),
         ([(100, 17), (256, 0)], [5, 900, 65000]),
         ([(2048, 0), (1, 8191)], list(range(1, 3000, 101)))]
BACKENDS = ("padded", "ragged", "flat", "fused")
TPS = (1, 2, 4)


def specs(q, kv, dh, dtype, **kw):
    """(reference spec, port spec on TPU) of one shape."""
    b = jcost.kv_bytes_per_elem(dtype, dh)
    assert cost.kv_bytes_per_elem(dtype, dh) == b
    return (jcost.AttnSpec(q, kv, dh, kv_bytes=b, **kw),
            cost.AttnSpec(q, kv, dh, kv_bytes=b, chip=TPU, **kw))


def sid(s):
    return "-".join(map(str, s))


# --------------------------------------------------------------------------
# kernels/cost.py
# --------------------------------------------------------------------------
def test_chip_holds_the_reference_block_and_hashes():
    j, t = specs(24, 8, 128, "bf16")
    assert t.block_s == j.block_s == TPU.attn_block
    assert cost.AttnSpec(24, 8, 128).block_s == cost.H100.attn_block
    assert cost.AttnSpec(24, 8, 128, block_s=16, chip=TPU).block_s == 16
    assert hash(TPU) != hash(cost.H100)
    assert {TPU: 1, cost.H100: 2}[TPU] == 1


@pytest.mark.parametrize("shape", SPECS, ids=sid)
def test_block_time_equals_reference(shape):
    j, t = specs(*shape)
    assert cost.block_time_s(t) == jcost.block_time_s(j)
    for bs in (16, 64, 512):
        j2, t2 = specs(*shape, block_s=bs)
        assert cost.block_time_s(t2) == jcost.block_time_s(j2)


@pytest.mark.parametrize("lengths", LENGTHS, ids=lambda l: f"n{len(l)}")
@pytest.mark.parametrize("block_s", (16, 64, 512))
def test_block_counts_equal_reference(lengths, block_s):
    lens = [max(x, 1) for x in lengths] if lengths else lengths
    for pad_to in (None, 8192):
        assert cost.padded_blocks(lens, block_s, pad_to) == \
            jcost.padded_blocks(lens, block_s, pad_to)
    assert cost.ragged_blocks(lengths, block_s) == \
        jcost.ragged_blocks(lengths, block_s)
    for bucketed in (True, False):
        assert cost.flat_grid_blocks(lengths, block_s, bucketed) == \
            jcost.flat_grid_blocks(lengths, block_s, bucketed)
    for n in range(0, 70):
        assert cost.pow2_bucket(n) == jcost.pow2_bucket(n)


@pytest.mark.parametrize("lengths", LENGTHS, ids=lambda l: f"n{len(l)}")
@pytest.mark.parametrize("shape", SPECS, ids=sid)
def test_decode_attention_time_equals_reference(shape, lengths):
    j, t = specs(*shape)
    assert cost.decode_attn_time_flat_s(lengths, t) == \
        jcost.decode_attn_time_flat_s(lengths, j)
    for ragged, pad_to in itertools.product((False, True), (None, 16384)):
        assert cost.decode_attn_time_s(lengths, t, ragged, pad_to) == \
            jcost.decode_attn_time_s(lengths, j, ragged, pad_to)
    assert cost.heterogeneity_tax(lengths, t) == \
        jcost.heterogeneity_tax(lengths, j)


@pytest.mark.parametrize("chunk", CHUNKS, ids=sid)
@pytest.mark.parametrize("shape", SPECS, ids=sid)
def test_prefill_pricing_equals_reference(shape, chunk):
    j, t = specs(*shape)
    c, x = chunk
    assert cost.prefill_chunk_blocks(c, x, t.block_s) == \
        jcost.prefill_chunk_blocks(c, x, j.block_s)
    assert cost.prefill_chunk_flops(c, x, t) == \
        jcost.prefill_chunk_flops(c, x, j)
    assert cost.prefill_chunk_attn_time_s(c, x, t) == \
        jcost.prefill_chunk_attn_time_s(c, x, j)
    for cached in (0, x, c + x):
        assert cost.prefill_flops(c + x, t, cached) == \
            jcost.prefill_flops(c + x, j, cached)
        assert cost.prefill_flops_skipped(c + x, cached, t) == \
            jcost.prefill_flops_skipped(c + x, cached, j)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", range(len(MIXED)))
@pytest.mark.parametrize("shape", SPECS[:3], ids=sid)
def test_mixed_iteration_time_equals_reference(shape, case, backend):
    j, t = specs(*shape)
    chunks, lens = MIXED[case]
    assert cost.mixed_iter_time_s(chunks, lens, t, decode_backend=backend) \
        == jcost.mixed_iter_time_s(chunks, lens, j, decode_backend=backend)
    assert cost.fused_grid_items(chunks, lens, t.block_s) == \
        jcost.fused_grid_items(chunks, lens, j.block_s)


@pytest.mark.parametrize("n", (0, 1, 2, 4, 8))
def test_staging_and_collectives_equal_reference(n):
    for b in (0.0, 1.0, 1_835_008.0, 3.7e9):
        assert cost.h2d_block_time_s(b, chip=TPU) == jcost.h2d_block_time_s(b)
        assert cost.allreduce_time_s(b, n, chip=TPU) == \
            jcost.allreduce_time_s(b, n)
    assert cost.promote_cost_tokens(n, 16) == jcost.promote_cost_tokens(n, 16)


# --------------------------------------------------------------------------
# sim/costmodel.py on all eleven configs
# --------------------------------------------------------------------------
def test_config_registry_equals_reference():
    assert ARCHS == JARCHS
    for name in ARCHS:
        tc, jc = get_config(name), jax_get_config(name)
        for f in dataclasses.fields(tc):
            # tp_plan, tp_rows, levers, seq_parallel, tp_data: the port's
            # per-leaf partition, its data ranks and its levers, no
            # reference fields
            if f.name not in ("dtype", "tp_plan", "tp_rows", "levers",
                              "seq_parallel", "tp_data"):
                assert getattr(tc, f.name) == getattr(jc, f.name), \
                    (name, f.name)
    with pytest.raises(KeyError):
        get_config("gpt-2")


PROFILES = list(itertools.product(ARCHS, TPS, ("bf16", "int8"),
                                  ("padded", "ragged", "fused")))


def profiles(arch, tp, kv_dtype, backend):
    kw = dict(tp=tp, kv_dtype=kv_dtype, ragged_backend=backend == "ragged",
              fused_backend=backend == "fused")
    return (jcm.profile_from_config(jax_get_config(arch), **kw),
            cm.profile_from_config(get_config(arch), chip=TPU, **kw))


def same_profile(j, t):
    for f in dataclasses.fields(t):
        if f.name == "attn_spec":
            for g in dataclasses.fields(j.attn_spec):
                assert getattr(t.attn_spec, g.name) == \
                    getattr(j.attn_spec, g.name), g.name
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("key", PROFILES, ids=sid)
def test_profile_from_config_equals_reference(key):
    j, t = profiles(*key)
    same_profile(j, t)
    assert t.t_weights == j.t_weights
    for n in (0, 1, 300):
        assert t.t_collective(n) == j.t_collective(n)
    for tp in (1, 2, 4):
        same_profile(jcm.scale_profile_tp(j, tp), cm.scale_profile_tp(t, tp))


@pytest.mark.parametrize("key", PROFILES, ids=sid)
def test_iteration_pricing_equals_reference(key):
    j, t = profiles(*key)
    for lens in LENGTHS:
        assert cm.decode_iter_time(lens, t) == jcm.decode_iter_time(lens, j)
        if lens:
            assert cm.decode_rate(lens, t) == jcm.decode_rate(lens, j)
    for chunks, lens in MIXED:
        assert cm.mixed_iter_time(chunks, lens, t) == \
            jcm.mixed_iter_time(chunks, lens, j)
    for I, cached in ((1, 0), (1024, 0), (8192, 4096), (100_000, 99_999)):
        assert cm.prefill_time(I, t, cached) == jcm.prefill_time(I, j, cached)
    for bs in (16, 32):
        assert cm.kv_block_bytes(t, bs) == jcm.kv_block_bytes(j, bs)
        assert cm.capacity_blocks(60e9, t, bs) == \
            jcm.capacity_blocks(60e9, j, bs)
        for n in (0, 1, 37):
            assert cm.promote_time(n, t, bs) == jcm.promote_time(n, j, bs)
            assert cm.demote_time(n, t, bs) == jcm.demote_time(n, j, bs)


# --------------------------------------------------------------------------
# sched/policy.py and core/migration.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SPECS, ids=sid)
@pytest.mark.parametrize("chunk", (1, 64, 256))
def test_recompute_pricing_equals_reference(shape, chunk):
    j, t = specs(*shape)
    for kv, must in itertools.product((0, 1, 2, 16, 255, 256, 257, 4096),
                                      (0, 2)):
        assert policy.recompute_cost_s(kv, t, chunk) == \
            jpolicy.recompute_cost_s(kv, j, chunk)
        assert policy.park_or_recompute(must_free_blocks=must, kv_tokens=kv,
                                        spec=t, chunk=chunk) == \
            jpolicy.park_or_recompute(must_free_blocks=must, kv_tokens=kv,
                                      spec=j, chunk=chunk)


def test_park_restore_is_the_h100_launch():
    assert policy.PARK_RESTORE_COST_S == cost.H100.launch_overhead_s > 0
    h = cost.AttnSpec(24, 8, 128)
    assert policy.recompute_cost_s(1, h) > 0
    # one launch is cheaper than rebuilding a long context
    assert policy.park_or_recompute(must_free_blocks=0, kv_tokens=8192,
                                    spec=h) == "park"


@pytest.mark.parametrize("tokens", (0, 100, 256, 257, 4096, 100_000))
@pytest.mark.parametrize("rate", (0.0, 30.0, 5000.0))
def test_live_migration_plan_equals_reference(tokens, rate):
    for bpt, bw, stop in ((114_688.0, 25e9, 256), (2e5, 1e9, 64),
                          (1.0, 1e3, 0)):
        assert dataclasses.asdict(
            mig.plan_live_migration(tokens, rate, bpt, bw, stop)) == \
            dataclasses.asdict(
                jmig.plan_live_migration(tokens, rate, bpt, bw, stop))


def test_migration_manager_equals_reference():
    a, b = mig.MigrationManager(), jmig.MigrationManager()
    for step in range(12):
        for m in (a, b):
            if m.can_start(step % 3 != 0):
                m.start(step, step + 2.5)
            if step % 4 == 3:
                m.finish(step - 2)
        assert a.active == b.active and a.max_concurrent == b.max_concurrent


# --------------------------------------------------------------------------
# core/qoe.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("nonneg", (True, False))
def test_qoe_fit_equals_reference(seed, nonneg):
    rng = np.random.default_rng(seed)
    sets = [(rng.integers(16, 8000, n), rng.integers(1, 400, n))
            for n in rng.integers(1, 40, 300)]
    F = np.stack([qoe.batch_features(i, i + o) for i, o in sets])
    F_j = np.stack([jqoe.batch_features(i, i + o) for i, o in sets])
    assert np.array_equal(F, F_j)
    D = np.asarray([4e-3, 3e-5, 8e-8, 1e-12, 2e-8])
    Q = F @ D * rng.lognormal(0.0, 0.1, len(F))
    m = qoe.fit_qoe(F, Q, nonneg=nonneg)
    jm = jqoe.fit_qoe(F_j, Q, nonneg=nonneg)
    assert np.array_equal(m.D, jm.D)
    assert np.array_equal(qoe.relative_errors(m, F, Q),
                          jqoe.relative_errors(jm, F_j, Q))
    assert np.array_equal(qoe.static_baseline_errors(F, Q),
                          jqoe.static_baseline_errors(F_j, Q))
    i, o = sets[0]
    w = rng.random(len(i))
    assert m.batch_q(i, i + o, w) == jm.batch_q(i, i + o, w)
    assert m.request_q(F[3]) == jm.request_q(F_j[3])


# --------------------------------------------------------------------------
# sim/events.py and sim/workload.py
# --------------------------------------------------------------------------
def test_event_queue_equals_reference():
    logs = []
    for mod in (events, jevents):
        q, log = mod.EventQueue(), []
        for t in (3.0, 1.0, 1.0, 2.5, 0.0, 3.0):
            q.push(t, lambda t=t, n=len(log): log.append((t, n, q.now)))
        q.push(1.0, lambda: q.push(1.5, lambda: log.append(("late", q.now))))
        q.run_until(2.0)
        log.append(("mid", len(q), q.now))
        q.run_until(10.0)
        logs.append(log)
    assert logs[0] == logs[1]


def reqs(rs):
    return [dataclasses.astuple(r) for r in rs]


@pytest.mark.parametrize("seed", (0, 7))
def test_workload_generators_equal_reference(seed, tmp_path):
    assert reqs(wl.generate_longtail(3.0, 20.0, seed=seed)) == \
        reqs(jwl.generate_longtail(3.0, 20.0, seed=seed))
    assert reqs(wl.generate(wl.WorkloadSpec(5.0, 10.0, seed=seed,
                                            drift_mu=0.7))) == \
        reqs(jwl.generate(jwl.WorkloadSpec(5.0, 10.0, seed=seed,
                                           drift_mu=0.7)))
    sp, jsp = (m.shared_prefix_spec(4.0, 15.0, seed=seed) for m in (wl, jwl))
    assert dataclasses.asdict(sp) == dataclasses.asdict(jsp)
    assert reqs(wl.generate_shared_prefix(sp)) == \
        reqs(jwl.generate_shared_prefix(jsp))
    so, jso = (m.slo_spec(6.0, 30.0, seed=seed) for m in (wl, jwl))
    assert reqs(wl.generate_slo(so)) == reqs(jwl.generate_slo(jso))
    curves = (wl.ArrivalCurve(3.0, burst_every=5.0),
              jwl.ArrivalCurve(3.0, burst_every=5.0))
    windows = [m.burst_windows(c, 60.0, np.random.default_rng(seed))
               for m, c in zip((wl, jwl), curves)]
    assert windows[0] == windows[1]
    t = np.linspace(0.0, 60.0, 97)
    assert np.array_equal(wl.rate_at(curves[0], t, windows[0]),
                          jwl.rate_at(curves[1], t, windows[1]))
    (a, wa), (b, wb) = (m.arrival_times(c, 60.0, np.random.default_rng(seed))
                        for m, c in zip((wl, jwl), curves))
    assert np.array_equal(a, b) and wa == wb
    path = tmp_path / "trace.csv"
    rng = np.random.default_rng(seed)
    np.savetxt(path, rng.integers(1, 9000, (25, 2)), fmt="%d", delimiter=",")
    assert reqs(wl.trace_requests(str(path), 2.0, seed)) == \
        reqs(jwl.trace_requests(str(path), 2.0, seed))


# --------------------------------------------------------------------------
# the H100 chip itself
# --------------------------------------------------------------------------
def test_h100_carries_no_reference_constant():
    ref = {jcost.PEAK_FLOPS, jcost.HBM_BW, jcost.ICI_BW,
           jcost.HOST_STAGING_BW, jcost.SKIP_OVERHEAD_S,
           jcost.LAUNCH_OVERHEAD_S}
    h = cost.H100
    assert not ref & set(dataclasses.astuple(h)[1:])
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (989e12, 3.35e12, 450e9)
    assert h.attn_block == 64
    prof = cm.profile_from_config(get_config("llama3.2-3b"))
    assert (prof.peak, prof.hbm, prof.t_fixed) == \
        (h.peak_flops, h.hbm_bw, h.t_fixed_s)
    assert prof.attn_spec.chip is h


@pytest.mark.parametrize("arch", ("llama3.2-3b", "qwen2.5-14b",
                                  "qwen3-moe-30b-a3b"))
@pytest.mark.parametrize("lengths", ([512], [512] * 8, [4096] * 32,
                                     [256] * 7 + [8000]), ids=len)
def test_h100_decode_iteration_beats_the_reference_chip(arch, lengths):
    h = cm.profile_from_config(get_config(arch))
    j = jcm.profile_from_config(jax_get_config(arch))
    for fused in (False, True):
        hp = dataclasses.replace(h, fused_backend=fused)
        jp = dataclasses.replace(j, fused_backend=fused)
        assert cm.decode_iter_time(lengths, hp) < \
            jcm.decode_iter_time(lengths, jp)
        assert cm.mixed_iter_time([(256, 0)], lengths, hp) < \
            jcm.mixed_iter_time([(256, 0)], lengths, jp)
