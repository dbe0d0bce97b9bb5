"""``tools/profile_torch_engine.py``'s accounting on fake profiler events:
device busy is the union of kernel intervals, the MoE layer's kernels are
those inside the device-side ranges of its ``record_function``, and the
MoE layer's least time at qwen3-moe-30b-a3b's widths."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import profile_torch_engine as pte  # noqa: E402


def _event(start, end):
    """A profiler event's device interval (µs), as ``FunctionEvent``
    gives it."""
    return SimpleNamespace(time_range=SimpleNamespace(
        start=start, end=end, elapsed_us=lambda: end - start))


def test_busy_is_the_union_of_kernel_intervals():
    """Overlapping kernels (a launch may start before the previous one
    ends) count once; gaps count not at all."""
    events = [_event(20, 30), _event(0, 10), _event(5, 15), _event(12, 14)]
    assert pte.busy_ms(events) == pytest.approx((15 + 10) / 1e3)
    assert pte.busy_ms([]) == 0.0


def test_moe_kernels_are_those_inside_its_device_ranges():
    """A kernel counts for the MoE layer when its interval lies inside a
    device-side range; one that only overlaps a range's edge, or lies
    between ranges, does not."""
    spans = [_event(20, 30).time_range, _event(0, 10).time_range]
    inside = [_event(0, 3), _event(4, 10), _event(21, 29)]
    outside = [_event(9, 12), _event(15, 18), _event(29, 31), _event(40, 41)]
    got = pte.within(inside + outside, spans)
    assert got == inside
    assert pte.busy_ms(got) == pytest.approx((3 + 6 + 8) / 1e3)
    assert pte.within(inside, []) == []


def test_moe_layer_bound_at_qwen3_moe_widths():
    """A 48-layer decode step (one all-expert call a layer) reads 1.21 GB
    of expert weights: 17.32 ms at 3.35 TB/s, bytes-bound; 256 rows a
    call turn it operations-bound."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-30b-a3b")
    ms, by = pte.moe_layer_bound_ms(cfg, 48, 48 * 8)
    assert by == "bytes"
    assert ms == pytest.approx(17.323, abs=1e-3)
    ms, by = pte.moe_layer_bound_ms(cfg, 1, 4096)
    assert by == "operations"
    assert ms == pytest.approx(4096 * 128 * 6 * 2048 * 768 / 989e12 * 1e3,
                               rel=1e-3)
