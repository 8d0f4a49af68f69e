"""Share of the traced calls' time in which no operation runs on the
device, in %, with the time the device waits on the host's graph launches
left out: 100 × (window − busy − launch idle) ÷ (window − launch idle).
All three come from the profiler's trace of the same calls
(``harness/trace.py``): the traced window, the union of its kernel and
copy intervals, and the idle time inside the host's ``cudaGraphLaunch``.

Under the profiler a launch of the captured round (~5000 nodes) takes
8–19 ms of host time to instrument, during which a round-by-round loop
leaves the device idle; unprofiled, a launch takes 0.14–0.18 ms of host
time (PERF.md), which this share leaves out together with the profiler's
cost.  What remains is the host's work between the round graphs: the
read-back, the decode of the round's record, the next round's inputs.
Layer: the device."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    span = t.window_s - t.launch_idle_s
    if span <= 0:
        return None
    return 100.0 * (span - t.busy_s) / span
