#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. build the fusion-loss kernels from ``src/repro_torch/kernels`` (nvcc,
   ``sm_90a``) and print the build seconds and ``-Xptxas -v``;
2. set up the main path — ``MFLExperiment(dataset, K=10, n_samples=1200,
   engine="batched:seq+pallas")`` for CREMA-D and IEMOCAP — and hold every
   kernel against its plain PyTorch version on the card, in float32 and
   float64, at the shape each experiment's own client stack gives the
   kernels (labels, sample mask and modality ownership taken from it), and
   at an LM-like shape with one broadcast head (K=1, T=512, V=32000, M=3);
3. drive the main path — CREMA-D for 5 rounds, then IEMOCAP for 2 — with
   the launch counters set to 0 just before and read after each run, and
   check its output: finite params, every metric present, and small twin
   runs of both datasets on the card that agree with the plain path on the
   CPU;
4. time each kernel (CUDA events, after warm-up) beside its plain version
   and its bound, at every shape of phase 2.

Imports nothing of JAX.  Exits non-zero, printing no result, without CUDA.
The last line is ``{"ok": true, "device": {...}}``; the line before it the
per-kernel JSON, and before that the card's name and power limit.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 FLOP/s
#: outside the tensor cores — the kernels' bound is max(bytes, operations)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
DEVICE = "cuda"

#: where the TPU kernels this port replaces live in the JAX package
REPLACES = {
    "fusion_loss_fwd": "src/repro/kernels/fusion_loss/kernel.py:78",
    "fusion_loss_bwd": "src/repro/kernels/fusion_loss/kernel.py:215",
    "fusion_loss_reduce": "src/repro/kernels/fusion_loss/kernel.py:215",
}
SOURCE = "src/repro_torch/kernels/fusion_loss/csrc/fusion_loss.cu"
#: the kernels the main path launches (the training step reads no gsq/gdot,
#: so it launches no partial reduce)
PATH_KERNELS = ("fusion_loss_fwd", "fusion_loss_bwd")

#: the main path: each dataset with its rounds, at MFLExperiment's defaults
MAIN_PATH = (("crema_d", 5), ("iemocap", 2))
MAIN_KW = dict(K=10, n_samples=1200, engine="batched:seq+pallas")

# tolerances, float32 kernel against the plain version (another summation
# order): per-row losses and residuals, per-element gradients, and the
# gsq/gdot sums over K·T·V terms
TOL_FWD = dict(rtol=1e-5, atol=1e-5)
TOL_BWD = dict(rtol=1e-5, atol=2e-6)
TOL_SUM = dict(rtol=1e-4, atol=1e-6)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Per-call milliseconds from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, kernel: str, iters: int = 50):
    """Mean device time of ``kernel`` per launch from ``torch.profiler``,
    or None when the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if kernel in evt.key:
            total = (getattr(evt, "device_time_total", 0)
                     or getattr(evt, "cuda_time_total", 0))
            if total and evt.count:
                return total / evt.count / 1e3          # us -> ms
    return None


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def make_case(torch, labels, avail, mask, V, seg, seed):
    """Cohort inputs on the card for labels [K, T] and avail [M, K, T]:
    random logits (a broadcast head is [K, T/S, V]) and cotangents that are
    zero on the rows the sample mask pads."""
    rng = np.random.default_rng(seed)
    K, T = labels.shape
    M = avail.shape[0]
    t = lambda x: torch.as_tensor(x, device=DEVICE)     # noqa: E731
    logits = [t((rng.normal(size=(K, T // s if s else T, V)) * 3.0)
                .astype(np.float32)) for s in seg]
    d_fused = rng.normal(size=(K, T)).astype(np.float32) * mask
    d_modal = rng.normal(size=(M, K, T)).astype(np.float32) * mask
    return dict(logits=logits, labels=t(labels), avail=t(avail),
                d_fused=t(d_fused), d_modal=t(d_modal), seg=tuple(seg),
                shape=(K, T, V, M))


def path_case(torch, exp, seed):
    """The kernels' inputs at the shape the main path gives them: labels,
    sample mask and modality ownership from the experiment's own client
    stack, with one client unscheduled (avail 0, as the round runs it) and
    one row with no modality at all."""
    _, labels, smask = exp._get_stacked()
    labels = labels.cpu().numpy()
    mask = smask.cpu().numpy().astype(np.float32)
    T = labels.shape[1]
    own = np.array([[m in mods for mods in exp.client_mods]
                    for m in exp.all_mods], np.float32)         # [M, K]
    avail = np.repeat(own[:, :, None], T, axis=2)
    avail[:, -1] = 0.0
    avail[:, 0, 0] = 0.0
    return make_case(torch, labels, avail, mask, exp.train_ds.n_classes,
                     (0,) * len(exp.all_mods), seed)


def lm_case(torch):
    """An LM-like shape the main path does not run, with one broadcast
    head: K=1, T=512, V=32000, M=3, seg=(0, 0, 128)."""
    K, T, V, M = 1, 512, 32000, 3
    labels = np.random.default_rng(2).integers(0, V, (K, T))
    avail = np.ones((M, K, T), np.float32)
    avail[:, 0, 0] = 0.0
    mask = np.ones((K, T), np.float32)
    mask[:, -3:] = 0.0
    return make_case(torch, labels, avail, mask, V, (0, 0, 128), seed=2)


def work(case, nblk):
    """(bytes, operations) each kernel needs on this case: every input read
    once, every output written once.  The backward is counted as the main
    path runs it, without partials."""
    K, T, V, M = case["shape"]
    KT = K * T
    operands = sum(x.numel() for x in case["logits"]) * 4
    rows_in = KT * 4 + M * KT * 4                          # labels, avail
    fwd = (operands + rows_in + (3 * KT + 3 * M * KT) * 4,
           KT * V * (5 * M + 4))
    bwd = (operands + rows_in + (2 * KT + 2 * M * KT) * 4
           + M * KT * V * 4,
           KT * V * (11 * M + 5))
    red = (K * nblk * M * 2 * 4 + 2 * K * M * 4, K * nblk * M * 2)
    return {"fusion_loss_fwd": fwd, "fusion_loss_bwd": bwd,
            "fusion_loss_reduce": red}


def bound(bytes_ops):
    nbytes, ops = bytes_ops
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(torch, name, got, want, tol, errs):
    got = got.double()
    want = want.double()
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, **tol)
    print(f"  {name:34s} max|err| {err:.3e}  (rtol {tol['rtol']:g}, "
          f"atol {tol['atol']:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    errs.append(err)
    return err


def kernel_phase(torch, ops, ref, exps):
    """Kernel vs plain (float32 and float64) at each main-path experiment's
    shape and the LM-like one; returns the cases and the max abs error per
    kernel against the float32 plain."""
    cases = {name: path_case(torch, exp, seed=1 + i)
             for i, (name, exp) in enumerate(exps.items())}
    cases["lm"] = lm_case(torch)
    errs = {k: [] for k in REPLACES}
    for label, c in cases.items():
        K, T, V, M = c["shape"]
        print(f"[kernels] {label}: K={K} T={T} V={V} M={M} seg={c['seg']}")
        lg, lab, av = c["logits"], c["labels"], c["avail"]
        out = ops.fusion_loss_fwd(lg, lab, av, c["seg"])
        dl, gsq, gdot = ops.fusion_loss_bwd(lg, lab, av, c["d_fused"],
                                            c["d_modal"], out[3], out[5],
                                            c["seg"])
        _, gsq2, gdot2 = ops.fusion_loss_bwd(lg, lab, av, c["d_fused"],
                                             c["d_modal"], out[3], out[5],
                                             c["seg"])
        torch.cuda.synchronize()
        if not (torch.equal(gsq, gsq2) and torch.equal(gdot, gdot2)):
            raise AssertionError("gsq/gdot differ between two runs")
        print("  gsq/gdot bitwise equal across two runs: ok")
        # the training step's backward writes no partials: same dlogits
        dl_step, no_sq, no_dot = ops.fusion_loss_bwd(
            lg, lab, av, c["d_fused"], c["d_modal"], out[3], out[5],
            c["seg"], with_partials=False)
        if (no_sq is not None or no_dot is not None
                or not all(map(torch.equal, dl_step, dl))):
            raise AssertionError("backward without partials differs")
        print("  backward without partials: dlogits bitwise equal: ok")
        stack = ops._plain_stack(lg, c["seg"])
        names = ("fused_nll", "modal_nll", "fused_max", "fused_lse",
                 "modal_max", "modal_lse")
        for dtype in (torch.float32, torch.float64):
            tag = "f32" if dtype == torch.float32 else "f64"
            want = ref.fusion_loss_ref(stack, lab, av, dtype=dtype,
                                       save_residuals=True)
            sink = errs["fusion_loss_fwd"] if dtype == torch.float32 else []
            for n, g, w in zip(names, out, want):
                check(torch, f"fwd {n} vs plain {tag}", g, w, TOL_FWD, sink)
            d_w, gsq_w, gdot_w = ref.fusion_loss_ref_grads(
                stack, lab, av, c["d_fused"], c["d_modal"], dtype=dtype)
            f32 = dtype == torch.float32
            for m in range(M):
                check(torch, f"bwd dlogits[{m}] vs plain {tag}", dl[m],
                      d_w[m], TOL_BWD,
                      errs["fusion_loss_bwd"] if f32 else [])
            sink = errs["fusion_loss_reduce"] if f32 else []
            check(torch, f"reduce gsq vs plain {tag}", gsq, gsq_w.T,
                  TOL_SUM, sink)
            check(torch, f"reduce gdot vs plain {tag}", gdot, gdot_w.T,
                  TOL_SUM, sink)
        # the autograd Function: broadcast head folded back to [K, B, V]
        xs = [x.clone().requires_grad_() for x in lg]
        f_nll, m_nll = ops.FusionLoss.apply(c["seg"], lab, av, *xs)
        torch.autograd.backward((f_nll, m_nll), (c["d_fused"], c["d_modal"]))
        for m, (x, s) in enumerate(zip(xs, c["seg"])):
            want = dl[m] if not s else dl[m].reshape(K, -1, s, V).sum(2)
            check(torch, f"autograd grad[{m}] vs bwd kernel", x.grad, want,
                  TOL_BWD, [])
    return cases, {k: max(v) for k, v in errs.items()}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def run_experiment(torch, exp, metric_keys, dataset, rounds):
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec = exp.run_round()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[main] {dataset} round {rec.round}: {dt * 1e3:.3f} ms "
              f"(sched {rec.sched_time_s * 1e3:.3f} ms) "
              f"part={rec.participants} fail={rec.failures} "
              f"E={rec.energy_total:.6f} J "
              f"acc={rec.metrics.get('multimodal', float('nan')):.4f} "
              f"loss={rec.metrics.get('loss', float('nan')):.4f}")
        if tuple(sorted(rec.metrics)) != tuple(sorted(
                metric_keys(exp.all_mods))):
            raise AssertionError(f"metrics {sorted(rec.metrics)} incomplete")
        if not all(math.isfinite(v) for v in rec.metrics.values()):
            raise AssertionError(f"non-finite metrics {rec.metrics}")
    from repro_torch.core.trees import tree_leaves
    for x in tree_leaves(exp.global_params):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("non-finite global params")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_round(torch, exp):
    """One more round under ``torch.profiler``: the device's busy share of
    the round's wall time, the host scheduler's share, and the kernels that
    take the device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec = exp.run_round()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats the time of the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda]
    if not events:
        print("[profile] the trace shows no device events: device busy "
              "share not measured")
        return
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"[profile] crema_d round {rec.round}: wall {wall_ms:.3f} ms, "
          f"host scheduler {rec.sched_time_s * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.2%} of wall; idle "
          f"{1 - busy_ms / wall_ms:.2%}), {launches} device ops")
    for e in sorted(events, key=_device_us, reverse=True)[:8]:
        print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def twin_phase(torch, MFLExperiment, dataset, rounds):
    """A small run on the card (kernel loss) against the same run on the CPU
    (plain loss): same participants, params within 1e-4."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.trees import tree_leaves
    kw = dict(K=4, n_samples=160)
    gpu = MFLExperiment(dataset, engine="batched:seq+pallas", **kw)
    cpu = MFLExperiment(dataset, engine="batched:seq", device="cpu", **kw)
    for _ in range(rounds):
        rg, rc = gpu.run_round(), cpu.run_round()
        if rg.participants != rc.participants:
            raise AssertionError(f"participants {rg.participants} (card) != "
                                 f"{rc.participants} (cpu)")
    a = tree_leaves(params_to_numpy(gpu.global_params))
    b = tree_leaves(params_to_numpy(cpu.global_params))
    err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    print(f"[main] {dataset} twin run ({rounds} rounds) card/pallas vs "
          f"cpu/plain: participants equal, params max|err| {err:.3e} "
          f"(tol 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"{dataset}: card and cpu twin runs disagree")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def timing_phase(torch, ops, ref, cases):
    from repro_torch.kernels.fusion_loss.build import load
    per_shape = {}
    for label, c in cases.items():
        lgs, lab, av, shape = ops._kernel_operands(
            c["logits"], c["labels"], c["avail"], c["seg"])
        out = ops._launch_fwd(lgs, lab, av, c["seg"], shape)
        df, dm = c["d_fused"], c["d_modal"]
        _, partials = ops._launch_bwd(lgs, lab, av, df, dm, out[3], out[5],
                                      c["seg"], shape)
        # the backward is timed as the training step runs it: no partials
        stack = ops._plain_stack(c["logits"], c["seg"])
        calls = {
            "fusion_loss_fwd": (
                lambda: ops._launch_fwd(lgs, lab, av, c["seg"], shape),
                lambda: ref.fusion_loss_ref(stack, lab, av,
                                            save_residuals=True),
                None, "fusion_fwd_kernel"),
            "fusion_loss_bwd": (
                lambda: ops._launch_bwd(lgs, lab, av, df, dm, out[3],
                                        out[5], c["seg"], shape, False),
                lambda: ref.fusion_loss_ref_grads(stack, lab, av, df, dm),
                None, "fusion_bwd_kernel"),
            "fusion_loss_reduce": (
                lambda: ops._launch_reduce(partials),
                lambda: partials.sum(dim=1),
                lambda: partials.sum(dim=1), "fusion_partials_reduce"),
        }
        w = work(c, load().fusion_loss_bwd_blocks(shape[1]))
        rows = {}
        for name, (kern, plain, lib, kname) in calls.items():
            b_ms, b_by = bound(w[name])
            row = {"ms": time_ms(torch, kern),
                   "device_ms": device_ms(torch, kern, kname),
                   "plain_ms": time_ms(torch, plain, iters=20, warmup=3),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": (time_ms(torch, lib) if lib else None)}
            rows[name] = row
            lib_txt = (f"{row['library_ms']:.6f} ms (partials.sum(dim=1))"
                       if lib else "none: no single PyTorch call computes "
                                   "this function")
            dev_txt = ("not measured" if row["device_ms"] is None
                       else f"{row['device_ms']:.6f} ms")
            print(f"[time] {label:7s} {name:18s} {row['ms']:.6f} ms/launch "
                  f"(device {dev_txt}), plain {row['plain_ms']:.6f} ms, "
                  f"bound {b_ms:.6f} ms ({b_by}), library {lib_txt}")
        per_shape[label] = rows
    return per_shape


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 1
    from repro_torch.fl.eval import metric_keys
    from repro_torch.fl.runtime import MFLExperiment
    from repro_torch.kernels.fusion_loss import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = gpu_line()
    print(f"[gpu] {card}")

    # phase 1: build
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    print(f"[build] fusion_loss kernels built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")

    # phase 2: the main path's experiments, and the kernels against their
    # plain versions at the shapes those experiments give them
    exps = {}
    for dataset, _ in MAIN_PATH:
        t0 = time.perf_counter()
        exps[dataset] = MFLExperiment(dataset, **MAIN_KW)
        print(f"[main] {dataset}: set-up {time.perf_counter() - t0:.3f} s")
    cases, max_err = kernel_phase(torch, ops, ref, exps)

    # phase 3: the main path, counters set to 0 just before and read after
    # each run
    ops.reset_launch_counts()
    seen = ops.launch_counts()
    for dataset, rounds in MAIN_PATH:
        run_experiment(torch, exps[dataset], metric_keys, dataset, rounds)
        now = ops.launch_counts()
        print(f"[main] {dataset} launches: "
              f"{ {k: now[k] - seen[k] for k in now} }")
        for name in PATH_KERNELS:
            if now[name] == seen[name]:
                raise AssertionError(f"{name} was not launched by {dataset}")
        seen = now
    launches = seen
    if launches["fusion_loss_reduce"]:
        raise AssertionError("the training step launched the partial reduce")
    for dataset, rounds in MAIN_PATH:
        twin_phase(torch, MFLExperiment, dataset, min(rounds, 2))
    profile_round(torch, exps["crema_d"])

    # phase 4: times
    times = timing_phase(torch, ops, ref, cases)

    def shape_txt(label):
        K, T, V, M = cases[label]["shape"]
        seg = cases[label]["seg"]
        return (f"K={K} T={T} V={V} M={M}"
                + (f" seg={seg}" if any(seg) else ""))

    def entry(name):
        row = times["crema_d"][name]
        return {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "shape": shape_txt("crema_d"),
            "other_shapes": {label: dict(times[label][name],
                                         shape=shape_txt(label))
                             for label in times if label != "crema_d"},
        }

    # the partial reduce runs only where gsq/gdot are asked for
    # (fusion_loss_grads), not on the main path
    print("[reduce] " + json.dumps(entry("fusion_loss_reduce")))
    kernels = [entry(name) for name in PATH_KERNELS]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
