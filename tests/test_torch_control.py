"""The port's copies of the framework-free planning and control modules
give the reference's outputs on the same random inputs: workload stats
and the two stage-partition solvers, the boundary refiner and its
ablation splits, bid-ask receiver selection, and the whole control plane
driven through one scripted cluster of fake instances (identical decision
logs, bounds and per-stage migration counts), the workload generators and
the server's trace replay."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.control import bidask as ref_bidask  # noqa: E402
from repro.control import plane as ref_plane  # noqa: E402
from repro.control import protocol as ref_protocol  # noqa: E402
from repro.control import refinement as ref_refinement  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro.core import qoe as ref_qoe  # noqa: E402
from repro.core import workload_stats as ref_stats  # noqa: E402
from repro.sched import slo as ref_slo  # noqa: E402
from repro_torch.control import bidask, plane, protocol, refinement  # noqa: E402
from repro_torch.core import partition, qoe, workload_stats  # noqa: E402
from repro_torch.sched import slo  # noqa: E402

D = np.array([5e-3, 5e-4, 2e-7, 1e-12, 3e-7])


def _requests(rng, n):
    return [(int(i), int(o)) for i, o in
            zip(rng.lognormal(6.0, 1.2, n).astype(int) + 16,
                rng.lognormal(5.0, 1.0, n).astype(int) + 8)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_and_partition_solvers_match(seed):
    rng = np.random.default_rng(seed)
    reqs = _requests(rng, 300)
    edges = ref_stats.exp_bucket_edges(20000, first=128)
    np.testing.assert_array_equal(
        workload_stats.exp_bucket_edges(20000, first=128), edges)
    rs = ref_stats.build_stats(reqs, edges)
    ts = workload_stats.build_stats(reqs, edges)
    np.testing.assert_array_equal(ts.acc, rs.acc)
    np.testing.assert_array_equal(ts.cross, rs.cross)
    rq, tq = ref_qoe.QoEModel(D), qoe.QoEModel(D)
    for E in (2, 4, 6):
        want = ref_partition.two_phase(rs, E, rq)
        got = partition.two_phase(ts, E, tq)
        assert [(s.lo, s.hi, s.num_instances) for s in got.stages] == \
            [(s.lo, s.hi, s.num_instances) for s in want.stages]
        assert got.quality == want.quality
    want = ref_partition.full_dp(rs, 4, rq, max_stages=3)
    got = partition.full_dp(ts, 4, tq, max_stages=3)
    assert [(s.lo, s.hi, s.num_instances) for s in got.stages] == \
        [(s.lo, s.hi, s.num_instances) for s in want.stages]
    assert got.quality == want.quality
    for length in (0.0, 300.0, 5000.0, 1e9):
        assert got.stage_for_length(length) == want.stage_for_length(length)


@pytest.mark.parametrize("seed", [3, 4])
def test_boundary_refiner_and_splits_match(seed):
    rng = np.random.default_rng(seed)
    rr = ref_refinement.BoundaryRefiner(ref_qoe.QoEModel(D), 800.0)
    tr = refinement.BoundaryRefiner(qoe.QoEModel(D), 800.0)
    for _ in range(12):
        def views(n):
            i = rng.integers(16, 3000, n).astype(float)
            return [(a, a + b) for a, b in
                    zip(i, rng.integers(1, 2000, n).astype(float))]
        own = views(int(rng.integers(0, 9)))
        succ = [views(int(rng.integers(0, 7)))
                for _ in range(int(rng.integers(0, 3)))]
        assert tr.refine(own, succ) == rr.refine(own, succ)
        flat = own + [r for s in succ for r in s]
        assert refinement.quantity_based_split(flat) == \
            ref_refinement.quantity_based_split(flat)
        assert refinement.memory_based_split(flat) == \
            ref_refinement.memory_based_split(flat)
    assert tr.history == rr.history


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_select_receiver_and_overload_match(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(0, 7))
        loads = rng.integers(0, 5, n).astype(float) * 100.0
        starts = rng.integers(0, 4, n).astype(float)
        order = rng.permutation(n)
        want = ref_bidask.select_receiver(
            [ref_bidask.Bid(i, l, s, int(o)) for i, (l, s, o)
             in enumerate(zip(loads, starts, order))])
        got = bidask.select_receiver(
            [bidask.Bid(i, l, s, int(o)) for i, (l, s, o)
             in enumerate(zip(loads, starts, order))])
        assert got == want
        own = float(rng.integers(0, 800))
        assert bidask.is_overloaded(own, list(loads)) == \
            ref_bidask.is_overloaded(own, list(loads))
    for name in ("interactive", "standard", "batch", "unknown"):
        assert slo.priority_of(name) == ref_slo.priority_of(name)
        assert slo.slo_of(name) == slo.SLO_CLASSES[
            ref_slo.slo_of(name).name]


# --------------------------------------------------------------------------
# The whole control plane over a scripted fake cluster
# --------------------------------------------------------------------------
class FakeInstance:
    """InstanceView of a toy instance: a request's length grows by 25
    tokens per tick until its output budget is spent."""

    def __init__(self, iid, req_view, cap=3000.0, slots=5):
        self.id, self._view, self.cap, self.slots = iid, req_view, cap, slots
        self.reqs = {}           # req_id -> [input_len, length, left, cls]

    def used_tokens(self):
        return float(sum(r[1] for r in self.reqs.values()))

    def load(self):
        return self.used_tokens()

    def free_tokens(self):
        return self.cap - self.used_tokens()

    def queued_tokens(self):
        return 0.0

    def requests(self):
        return [self._view(rid, rid, r[0], r[1], ctx_done=r[0],
                           ctx_total=r[0], slo_class=r[3])
                for rid, r in sorted(self.reqs.items())]

    all_requests = requests

    def prefix_digests(self):
        return frozenset()

    def request_view(self):
        return [(r[0], r[1]) for _, r in sorted(self.reqs.items())]

    def has_request(self, ref):
        return ref in self.reqs

    def can_accept(self, ref):
        return len(self.reqs) < self.slots and self.free_tokens() > 400


class FakeOps:
    def __init__(self, insts, table):
        self.insts, self.table = insts, table

    def dispatch(self, ref, iid):
        self.insts[iid].reqs[ref] = list(self.table[ref])

    def start_migration(self, ref, src, dst):
        entry = self.insts[src].reqs.pop(ref)
        self.insts[dst].reqs[ref] = entry
        return self.completed

    def set_boundary(self, stage_idx, hi):
        pass


def _drive(mod, proto, refqoe, plan_mod, policy, seed):
    rng = np.random.default_rng(seed)
    n_inst = 4
    insts = [FakeInstance(i, proto.ReqView) for i in range(n_inst)]
    plan = plan_mod.PipelinePlan([plan_mod.Stage(0.0, 300.0, 2),
                                  plan_mod.Stage(300.0, 1200.0, 1),
                                  plan_mod.Stage(1200.0, float("inf"), 1)],
                                 0.0)
    table, done = {}, []
    ops = FakeOps(insts, table)
    ops.completed = proto.MIG_COMPLETED
    cp = mod.ControlPlane(plan, refqoe.QoEModel(D),
                          mod.ControlConfig(policy=policy,
                                            max_migrations_per_tick=3,
                                            seed=seed),
                          ops=ops, instances=insts)
    classes = ("interactive", "standard", "batch")
    rid = 0
    for tick in range(60):
        for _ in range(int(rng.integers(0, 3)) if tick < 40 else 0):
            i = float(rng.integers(16, 900))
            table[rid] = [i, i, int(rng.integers(20, 700)),
                          classes[int(rng.integers(0, 3))]]
            cp.submit(rid, rid, i, slo_class=table[rid][3])
            rid += 1
        for inst in insts:
            for r, e in list(inst.reqs.items()):
                e[1] += 25.0
                e[2] -= 25
                if e[2] <= 0:
                    del inst.reqs[r]
                    done.append(r)
        if policy == "cascade":
            cp.begin_tick()
            cp.handover_all()
            if tick % 4 == 0:
                cp.balance()
            if tick % 8 == 0:
                cp.refine()
            cp.pump_all()
    return cp, done


@pytest.mark.parametrize("policy", ["cascade", "round-robin",
                                    "least-loaded"])
@pytest.mark.parametrize("seed", [0, 11])
def test_control_plane_decision_log_matches_reference(policy, seed):
    want, wdone = _drive(ref_plane, ref_protocol, ref_qoe, ref_partition,
                         policy, seed)
    got, gdone = _drive(plane, protocol, qoe, partition, policy, seed)
    assert got.decisions == want.decisions
    assert gdone == wdone
    assert got.bounds() == want.bounds()
    assert got.migrations == want.migrations
    assert dict(got.migrations_by_stage) == dict(want.migrations_by_stage)
    if policy == "cascade":
        assert got.migrations > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_workload_and_trace_replay_match(seed):
    """The copied ShareGPT-shaped and long-tail generators draw the
    reference's traces, and the server's trace replay turns them into the
    same prompts, budgets, classes and arrival steps."""
    from repro.serving.server import requests_from_trace as ref_replay
    from repro.sim import workload as ref_workload
    from repro_torch.serving.server import requests_from_trace
    from repro_torch.sim import workload
    for make, ref_make in ((workload.WorkloadSpec, ref_workload.WorkloadSpec),
                           (workload.longtail_spec,
                            ref_workload.longtail_spec)):
        got = workload.generate(make(rate=3.0, duration=6.0, seed=seed))
        want = ref_workload.generate(ref_make(rate=3.0, duration=6.0,
                                              seed=seed))
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want]
        for (r, at), (w, wat) in zip(
                requests_from_trace(got, vocab_size=500, max_seq=256,
                                    seed=seed),
                ref_replay(want, vocab_size=500, max_seq=256, seed=seed)):
            assert at == wat and r.max_new_tokens == w.max_new_tokens
            np.testing.assert_array_equal(r.prompt, w.prompt)
            assert (r.slo_class, r.prefix_group, r.prefix_len) == \
                (w.slo_class, w.prefix_group, w.prefix_len)
