"""The traced part of a run: ``torch.profiler`` over whole calls, reduced
from its raw events (no per-event Python objects are built, so a trace of
millions of kernels reduces in seconds).

``TraceSummary`` holds what the per-layer readers and the ``breakdown``
take: the traced window (the ``bench.window`` range the harness opens
around the traced calls), the union of device activity inside it, the
kernels by name, the idle gaps between device activity, each named by the
host ranges that were open at its middle, and the idle time that falls
inside the host's graph launches.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

WINDOW_RANGE = "bench.window"
#: the host call that launches a captured graph: under the profiler it
#: takes milliseconds to instrument a graph of thousands of nodes
GRAPH_LAUNCH = "cudaGraphLaunch"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    n_kernels: int
    device_ops: List[Tuple[str, float]]      # kernel name, seconds (top)
    idle_gaps: List[Tuple[str, float]]       # host activity, seconds (top)
    launch_idle_s: float = 0.0     # idle time inside the graph launches


def _get(e, name):
    fn = getattr(e, name, None)
    return fn() if fn is not None else None


def _span_ns(e):
    start = _get(e, "start_ns")
    if start is None:
        start = int(_get(e, "start_us") * 1000)
    dur = _get(e, "duration_ns")
    if dur is None:
        dur = int(_get(e, "duration_us") * 1000)
    return int(start), int(dur)


def summarize(prof, top: int = 10) -> TraceSummary:
    """Reduce a stopped ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    gpu_start, gpu_dur, gpu_name = [], [], []
    cpu = []
    window = None
    for e in events:
        start, dur = _span_ns(e)
        if e.device_type() == cuda:
            # a host range's mirror on the device timeline spans its
            # kernels and the gaps between them: not device activity
            if "annotation" in str(_get(e, "activity_type") or "") or \
                    e.name().startswith("bench."):
                continue
            gpu_start.append(start)
            gpu_dur.append(dur)
            gpu_name.append(e.name())
        else:
            name = e.name()
            if name == WINDOW_RANGE:
                window = (start, start + dur)
            cpu.append((start, start + dur, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    w0, w1 = window
    s = np.asarray(gpu_start, np.int64)
    d = np.asarray(gpu_dur, np.int64)
    inside = (s >= w0) & (s + d <= w1)
    names = [n for n, i in zip(gpu_name, inside) if i]
    s, d = s[inside], d[inside]
    order = np.argsort(s, kind="stable")
    s, e_ = s[order], (s + d)[order]
    # union of device intervals, and the gaps between them
    merged = []
    gaps = []
    cur_s = cur_e = None
    for a, b in zip(s.tolist(), e_.tolist()):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
            gaps.append((w0 if cur_e is None else cur_e, a))
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
        gaps.append((cur_e, w1))
    else:
        gaps.append((w0, w1))
    busy = sum(b - a for a, b in merged)
    launches = [(max(a, w0), min(b, w1)) for a, b, n in cpu
                if n.startswith(GRAPH_LAUNCH) and b > w0 and a < w1]
    kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for n, dur in zip(names, d.tolist()):
        by_name[n] = by_name.get(n, 0) + dur
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, n_kernels=len(kernels),
        device_ops=[(n, v / 1e9) for n, v in device_ops],
        idle_gaps=[(_host_at(cpu, (a + b) // 2), (b - a) / 1e9)
                   for a, b in gaps],
        launch_idle_s=_idle_inside(launches, merged) / 1e9)


def _idle_inside(spans, merged) -> int:
    """Nanoseconds of the ``spans`` (disjoint host intervals) in which no
    interval of ``merged`` (the device's busy intervals, sorted and
    disjoint) runs."""
    if not spans:
        return 0
    ms = np.asarray([a for a, _ in merged] or [0], np.int64)
    me = np.asarray([b for _, b in merged] or [0], np.int64)
    idle = 0
    for a, b in spans:
        lo = max(int(np.searchsorted(me, a, side="right")), 0)
        hi = int(np.searchsorted(ms, b, side="left"))
        covered = np.clip(np.minimum(me[lo:hi], b) - np.maximum(ms[lo:hi], a),
                          0, None).sum() if hi > lo else 0
        idle += (b - a) - int(covered)
    return idle


def _host_at(cpu, t) -> str:
    """The host ranges open at time ``t``, outermost first, joined by "/"
    (the outermost and the two innermost when there are more); with none
    open, the host event that ended last before ``t``."""
    open_ = sorted(((a, -(b - a), n) for a, b, n in cpu
                    if a <= t < b and n != WINDOW_RANGE))
    names = [n for _, _, n in open_]
    if not names:
        before = [(b, n) for a, b, n in cpu if b <= t and n != WINDOW_RANGE]
        return f"after {max(before)[1]}" if before else "host"
    if len(names) > 3:
        names = [names[0], "..."] + names[-2:]
    return "/".join(names)


def start():
    """A started profiler of host and device activity."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False)
    prof.start()
    return prof
