"""The trace reduction's arithmetic on hand-made intervals: the idle time
inside the host's graph launches, and the device's idle share that leaves
it out."""
from types import SimpleNamespace

import pytest

from bench.harness import spec, trace


@pytest.mark.parametrize("spans, idle", [
    ([(5, 35), (60, 70)], 25),      # 5–10 and 20–30, then 60–70
    ([(12, 18)], 0),                # inside one busy interval
    ([(0, 100)], 70),               # around all three
    ([], 0),
])
def test_idle_inside_the_launches(spans, idle):
    merged = [(10, 20), (30, 40), (50, 60)]
    assert trace._idle_inside(spans, merged) == idle


def test_idle_inside_a_launch_with_the_device_never_busy():
    assert trace._idle_inside([(0, 5)], []) == 5


def test_idle_share_leaves_the_launches_out():
    read = spec.metric_reader("device_idle_share")
    t = trace.TraceSummary(window_s=10.0, busy_s=6.0, n_kernels=1,
                           device_ops=[], idle_gaps=[], launch_idle_s=2.0)
    assert read(SimpleNamespace(trace=t)) == pytest.approx(25.0)
    t.launch_idle_s = 4.0           # every idle moment inside a launch
    assert read(SimpleNamespace(trace=t)) == pytest.approx(0.0)
    assert read(SimpleNamespace(trace=None)) is None
