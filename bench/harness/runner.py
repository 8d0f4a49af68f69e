"""One run of one cell: set-up, the measured window, the per-layer
readers, the check against the reference, and the result line.

``run_cell`` is what ``bench/run.py`` calls after its look for a card; the
CPU tests call it with ``device="cpu"`` at a small size.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check as ck
from . import drivers, spec, trace

#: the traced calls of a ``--trace 1`` run, after the window has closed:
#: whole calls until this many seconds have passed, a whole number of the
#: driver's ``trace_period`` (the sweep's one call is longer)
TRACE_SECONDS = 2.0
#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What the per-layer readers read: the measured window (as a
    ``--trace 0`` run measures it) and the trace of the calls after it."""
    cell: "spec.Cell"
    driver: "drivers.Driver"
    device: str
    window_s: float = 0.0
    rounds: int = 0                     # scenario-rounds of the window
    flops: float = 0.0                  # model FLOPs of the window
    trace: Optional[trace.TraceSummary] = None
    rounds_traced: int = 0

    def loss_shape(self):
        return self.driver.loss_shape()

    def device_time_in_graph(self, fn, n: int = 20,
                             replays: int = 50) -> float:
        """Device seconds per call of ``fn``: ``fn`` captured ``n`` times in
        one CUDA graph, replayed ``replays`` times under the profiler, and
        the union of the replays' kernel intervals taken from its trace
        (no launch cost, no gap between replays)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
        g.replay()
        torch.cuda.synchronize()
        prof = trace.start()
        with torch.profiler.record_function(trace.WINDOW_RANGE):
            for _ in range(replays):
                g.replay()
            torch.cuda.synchronize()
        prof.stop()
        return trace.summarize(prof).busy_s / (replays * n)


def card_state() -> dict:
    """The card's SM clock, its maximum, the power limit and the active
    clock-throttle reasons, as ``nvidia-smi`` reads them; {} where it
    cannot."""
    keys = ("sm_clock_mhz", "max_sm_clock_mhz", "power_limit_w",
            "throttle_reasons")
    card = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0] or "0"
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", card, "--format=csv,noheader,nounits",
             "--query-gpu=clocks.sm,clocks.max.sm,power.limit,"
             "clocks_throttle_reasons.active"],
            capture_output=True, text=True, timeout=30).stdout.split(", ")
    except (OSError, subprocess.SubprocessError):
        return {}
    if len(out) != len(keys):
        return {}
    state = {}
    for k, v in zip(keys, out):
        try:
            state[k] = float(v)
        except ValueError:
            state[k] = v.strip()
    return state


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _window(drv, seconds: float, cuda: bool):
    """Calls back to back until ``seconds`` have passed (the call that
    crosses the line completes).  Returns the window's start and end and,
    per call, its device milliseconds (CUDA events recorded before the
    call and after its read-back; the host clock on the CPU) and its
    scenario-rounds."""
    calls = []
    t0 = time.perf_counter()
    while True:
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        s = time.perf_counter()
        with torch.profiler.record_function("bench.call"):
            n = drv.call()
        if cuda:
            e1.record()
        now = time.perf_counter()
        calls.append([s, now, (e0, e1) if cuda else None, n])
        if now - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    for c in calls:
        c[2] = c[2][0].elapsed_time(c[2][1]) if c[2] is not None \
            else (c[1] - c[0]) * 1e3
    return t0, now, calls


def _traced_calls(drv, cuda: bool):
    """Whole calls under ``torch.profiler`` for ``TRACE_SECONDS`` and a
    whole number of ``trace_period``s: (the stopped profiler, the calls'
    scenario-rounds)."""
    prof = trace.start()
    rounds, n = 0, 0
    t0 = time.perf_counter()
    with torch.profiler.record_function(trace.WINDOW_RANGE):
        while True:
            with torch.profiler.record_function("bench.call"):
                rounds += drv.call()
            n += 1
            if time.perf_counter() - t0 >= TRACE_SECONDS and \
                    n % drv.trace_period == 0:
                break
        if cuda:
            torch.cuda.synchronize()
    prof.stop()
    return prof, rounds


def run_cell(cell: "spec.Cell", seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             out=sys.stdout, err=sys.stderr) -> dict:
    """One run; prints the result line and returns it."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device != "cpu"
    # the configuration's precision: float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv = drivers.make(cell, seed, device)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    # what set-up made lives as long as the run: keep it out of the
    # collector's sweeps inside the window
    gc.collect()
    gc.freeze()
    t0, t1, calls = _window(drv, seconds, cuda)
    setup_s = t0 - t_start
    window_s = t1 - t0
    rounds = sum(c[3] for c in calls)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    # the clock the window ran at, read as it closes
    card = card_state() if cuda else {}

    metrics: Dict[str, dict] = {}
    run = Run(cell, drv, device, window_s=window_s, rounds=rounds,
              flops=sum(drv.call_flops(c) for c in drv.calls))
    if traced:
        prof, run.rounds_traced = _traced_calls(drv, cuda)
        gc.unfreeze()
        t_red = time.perf_counter()
        run.trace = trace.summarize(prof)
        print(f"bench: trace of {run.rounds_traced} scenario-rounds "
              f"reduced in {time.perf_counter() - t_red:.3f} s", file=err)
        readers = spec.readers(cell.per_layer)
        for m in cell.per_layer:
            v = readers[m.name](run)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
    else:
        gc.unfreeze()
        per_call_ms = [c[2] for c in calls]
        values = {"setup_s": setup_s,
                  "scenario_rounds_per_s": rounds / window_s,
                  "round_ms_p95": float(np.percentile(per_call_ms, 95))}
        for m in cell.end_to_end:
            metrics[m.name] = {"value": float(values[m.name]),
                               "unit": m.unit}

    t_check = time.perf_counter()
    numbers = drv.check()
    print(f"bench: setup {setup_s:.3f} s, window {window_s:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=err)
    print(f"bench: card {json.dumps(card)}", file=err)
    ok, rows = ck.verdict(numbers, cell.check["limits"])
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{bad}")
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(ok), "attempted": int(rounds), "failed": 0,
              "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    result["card"] = card
    result["checks"] = {name: {"value": _num(v), "limit": lim}
                        for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"check {name}: {_num(v)!r} limit {lim!r}", file=err)
    print(f"correct: {bool(ok)}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result


def _num(v):
    v = float(v)
    return v if math.isfinite(v) else str(v)
