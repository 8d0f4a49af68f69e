#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. build the three kernel libraries from ``src/repro_torch/kernels`` (one
   nvcc per source, all started together, ``sm_90a``) and print the build
   seconds and each ``-Xptxas -v``;
2. set up the main path — the paper's ``MFLExperiment(dataset, K=10,
   n_samples=1200, engine="batched:seq+pallas")`` for CREMA-D and IEMOCAP,
   and the same with ``arch="transformer"`` and ``arch="ssd"`` — and hold
   every kernel against its plain PyTorch version on the card, in float32
   and float64:
   * the fusion loss at the shape each paper experiment's own client stack
     gives it (labels, sample mask and modality ownership taken from it)
     and at an LM-like shape with one broadcast head (K=1, T=512, V=32000,
     M=3);
   * flash attention and the SSD chunk kernel on the operands the backbone
     experiments' own forward passes hand them (captured from the client
     stacks and the test split), and at the JAX package's kernel-sweep
     shapes (tests/test_kernels.py; attention in bfloat16 too), with the
     autograd Functions' gradients against plain autograd;
3. drive the main path — paper CREMA-D for 3 rounds and IEMOCAP for 1, then
   each backbone on each dataset for 2 rounds — with the launch counters
   set to 0 just before and read after each run, failing if a kernel of
   that run's path was not launched; check its output: finite params,
   every metric present, one ``+remat`` round equal to the plain round, and
   small twin runs on the card that agree with the plain path on the CPU;
   profile one paper, one transformer and one SSD round;
4. time each kernel (CUDA events, after warm-up) beside its plain version,
   its bound and, where one PyTorch call computes the same function, that
   call, at every shape of phase 2.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
#: outside the tensor cores and dense bfloat16 FLOP/s on them — a kernel's
#: bound is max(bytes, operations at the peak for its operands' type)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
DEVICE = "cuda"

#: where the TPU kernels this port replaces live in the JAX package
REPLACES = {
    "fusion_loss_fwd": "src/repro/kernels/fusion_loss/kernel.py:78",
    "fusion_loss_bwd": "src/repro/kernels/fusion_loss/kernel.py:215",
    "fusion_loss_reduce": "src/repro/kernels/fusion_loss/kernel.py:215",
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:25",
    "ssd_chunk_fwd": "src/repro/kernels/ssd_scan/kernel.py:22",
}
_CSRC = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
SOURCES = {"fusion_loss_fwd": _CSRC.format("fusion_loss"),
           "fusion_loss_bwd": _CSRC.format("fusion_loss"),
           "fusion_loss_reduce": _CSRC.format("fusion_loss"),
           "flash_attention_fwd": _CSRC.format("flash_attention"),
           "ssd_chunk_fwd": _CSRC.format("ssd_scan")}
#: the kernels the main path launches (the training step reads no gsq/gdot,
#: so it launches no partial reduce)
PATH_KERNELS = ("fusion_loss_fwd", "fusion_loss_bwd", "flash_attention_fwd",
                "ssd_chunk_fwd")
#: the kernels each architecture's runs must launch
ARCH_KERNELS = {"lstm-cnn": ("fusion_loss_fwd", "fusion_loss_bwd"),
                "transformer": ("fusion_loss_fwd", "fusion_loss_bwd",
                                "flash_attention_fwd"),
                "ssd": ("fusion_loss_fwd", "fusion_loss_bwd",
                        "ssd_chunk_fwd")}

#: the main path: (arch, dataset, rounds) at MFLExperiment's defaults; the
#: paper runs are cut from 5 + 2 rounds to 3 + 1 to fit the backbones in
MAIN_PATH = (("lstm-cnn", "crema_d", 3), ("lstm-cnn", "iemocap", 1),
             ("transformer", "crema_d", 2), ("transformer", "iemocap", 2),
             ("ssd", "crema_d", 2), ("ssd", "iemocap", 2))
MAIN_KW = dict(K=10, n_samples=1200, engine="batched:seq+pallas")

# tolerances, float32 kernel against the plain version (another summation
# order): fusion-loss per-row losses and residuals, per-element gradients,
# and the gsq/gdot sums over K·T·V terms; attention and SSD as the JAX
# package's kernel sweeps hold its kernels (tests/test_kernels.py), and
# bfloat16 attention likewise
TOL_FWD = dict(rtol=1e-5, atol=1e-5)
TOL_BWD = dict(rtol=1e-5, atol=2e-6)
TOL_SUM = dict(rtol=1e-4, atol=1e-6)
TOL_ATTN = dict(rtol=2e-5, atol=2e-5)
TOL_ATTN_BF16 = dict(rtol=3e-2, atol=3e-2)
TOL_SSD = dict(rtol=1e-4, atol=1e-4)
TOL_GRAD = dict(rtol=1e-5, atol=1e-5)

#: the JAX package's kernel sweeps (tests/test_kernels.py): attention
#: (B, H, KH, S, hd, window) and SSD chunks (B, nc, Q, nh, hp, N), with
#: the JAX configs' chunk (src/repro/models/config.py ssm_chunk = 256)
ATTN_SWEEP = ((1, 4, 2, 128, 64, None), (2, 4, 4, 256, 32, None),
              (1, 8, 2, 256, 64, 64), (1, 2, 1, 512, 128, 128))
SSD_SWEEP = ((1, 2, 64, 2, 32, 16), (2, 4, 32, 4, 16, 8),
             (1, 1, 128, 8, 64, 32),
             # the JAX configs' 256-token chunk: mamba2-370m and jamba
             (1, 1, 256, 2, 64, 128), (1, 1, 256, 2, 64, 16))


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


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_ms(torch, fn, iters: int = 50):
    """Mean device time of one call of ``fn`` from ``torch.profiler``: every
    kernel (and copy) the calls run on the device, summed, over the number
    of calls; None when the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(_device_us(e) for e in prof.key_averages()
                if getattr(e, "device_type", None) == cuda)
    return total / iters / 1e3 if total else None


def bound(bytes_ops, peak_flops=PEAK_F32_FLOPS):
    nbytes, ops = bytes_ops
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / peak_flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(torch, name, got, want, tol, errs):
    got = got.double()
    want = want.double()
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, **tol)
    print(f"  {name:44s} max|err| {err:.3e}  (rtol {tol['rtol']:g}, "
          f"atol {tol['atol']:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    errs.append(err)
    return err


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def build_phase():
    """One nvcc per source, all started together."""
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.fusion_loss import build as fl_build
    from repro_torch.kernels.ssd_scan import build as ssd_build
    libs = [fl_build.LIBRARY, fa_build.LIBRARY, ssd_build.LIBRARY]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(verbose=True), libs))
    for lib in libs:
        lib.load()
    print(f"[build] {len(libs)} kernel libraries built (one nvcc each, in "
          f"parallel) and loaded in {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 2a: the fusion-loss kernels against their plain versions
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
    """(bytes, operations) each fusion-loss kernel needs on this case: every
    input read once, every output written once.  The backward is counted
    as the main path runs it, without partials."""
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


def kernel_phase(torch, ops, ref, exps):
    """Fusion-loss kernels vs plain (float32 and float64) at each paper
    experiment's shape and the LM-like one; returns the cases and the max
    abs error per kernel against the float32 plain."""
    cases = {name: path_case(torch, exp, seed=1 + i)
             for i, (name, exp) in enumerate(exps.items())}
    cases["lm"] = lm_case(torch)
    errs = {k: [] for k in ("fusion_loss_fwd", "fusion_loss_bwd",
                            "fusion_loss_reduce")}
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
# phase 2b: flash attention and the SSD chunk kernel against their plain
# versions
# ---------------------------------------------------------------------------
class Capture:
    """Records, per distinct operand shape, the first operands the main
    path hands a front end (``module.name``) while the context is open."""

    def __init__(self, torch, module, name, label):
        self.torch, self.module, self.name = torch, module, name
        self.label = label
        self.seen = {}

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            key = tuple(tuple(a.shape) for a in args
                        if isinstance(a, self.torch.Tensor))
            if key not in self.seen:
                self.seen[key] = dict(
                    args=[a.detach().clone()
                          if isinstance(a, self.torch.Tensor) else a
                          for a in args], kw=dict(kw), label=self.label)
            return self.orig(*args, **kw)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def capture_backbone_operands(torch, exps):
    """The operands each backbone experiment's own forward passes hand the
    kernels: one cohort forward over the client stack and one eval forward
    over the test split."""
    from repro_torch.core.trees import tree_map
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    found = {"attn": {}, "ssd_chunk": {}, "ssd_forward": {}}
    for (arch, dataset), exp in exps.items():
        feats, _, _ = exp._get_stacked()
        K = exp.params.K
        stacked = {m: tree_map(lambda x: x.expand(K, *x.shape),
                               exp.global_params[m]) for m in feats}
        test = {m: torch.as_tensor(x, device=DEVICE)
                for m, x in exp.test_ds.features.items()}
        for where, run in (
                ("cohort", lambda: exp.adapter.modal_logits(stacked, feats)),
                ("eval", lambda: exp.adapter.eval_logits(exp.global_params,
                                                         test))):
            label = f"{arch}/{dataset}/{where}"
            caps = {"attn": Capture(torch, fa_ops, "flash_attention", label),
                    "ssd_chunk": Capture(torch, ssd_ops, "ssd_chunk", label),
                    "ssd_forward": Capture(torch, ssd_ops, "ssd_forward",
                                           label)}
            with torch.no_grad(), caps["attn"], caps["ssd_chunk"], \
                    caps["ssd_forward"]:
                run()
            for k, cap in caps.items():
                for key, rec in cap.seen.items():
                    found[k].setdefault(key, rec)
    return found


def attn_case(torch, q, k, v, window, label, dtype=None):
    """q [B,S,H,hd], k/v [B,S,KH,hd] on the card (the model's layout), with
    the regime the wrapper plans for them."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if dtype is not None:
        q, k, v = (t.to(dtype) for t in (q, k, v))
    B, S, H, hd = q.shape
    KH = k.shape[2]
    regime = fa_ops.plan(B, S, H, KH, hd, q.dtype,
                         fa_ops.aligned16((q, k, v), hd)).regime
    return dict(q=q, k=k, v=v, window=window, label=label, regime=regime,
                shape=f"B={B} S={S} H={H} KH={KH} hd={hd}"
                      + (f" window={window}" if window else "")
                      + ("" if q.dtype == torch.float32 else " bf16"))


def ssd_case(x, cum, Bm, Cm, label):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    B, nc, Q, nh, hp = x.shape
    N = Bm.shape[-1]
    return dict(x=x, cum=cum, Bm=Bm, Cm=Cm, label=label,
                regime=ssd_ops.plan(B, nc, Q, nh, hp, N).regime,
                shape=f"B={B} nc={nc} Q={Q} nh={nh} hp={hp} N={N}")


def backbone_cases(torch, found):
    """Attention and SSD cases: the main path's captured operands first,
    then the JAX sweep's shapes from a seeded generator on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    attn = [attn_case(torch, *rec["args"], rec["kw"].get("window"),
                      rec["label"]) for rec in found["attn"].values()]
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KH, S, hd, win in ATTN_SWEEP:
            q = torch.randn((B, H, S, hd), device=DEVICE, generator=g)
            k, v = (torch.randn((B, KH, S, hd), device=DEVICE, generator=g)
                    for _ in range(2))
            # the sweep's [B, H, S, hd] layout goes in as a strided view
            attn.append(attn_case(torch, q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), win, "jax-sweep", dtype))
    ssd = [ssd_case(*rec["args"], rec["label"])
           for rec in found["ssd_chunk"].values()]
    for B, nc, Q, nh, hp, N in SSD_SWEEP:
        x = torch.randn((B, nc, Q, nh, hp), device=DEVICE, generator=g)
        cum = torch.cumsum(-torch.rand((B, nc, Q, nh), device=DEVICE,
                                       generator=g) * 0.1, dim=2)
        Bm, Cm = (torch.randn((B, nc, Q, N), device=DEVICE, generator=g)
                  for _ in range(2))
        ssd.append(ssd_case(x, cum, Bm, Cm, "jax-sweep"))
    return attn, ssd


def backbone_kernel_phase(torch, found):
    """Flash attention and the SSD chunk kernel against their plain
    versions in float32 and float64 at every case; the autograd Functions
    against plain autograd at the main path's operands.  Returns the cases
    and the max abs error per kernel against the float32 plain version
    (float32 inputs)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.models import layers, mamba2
    attn, ssd = backbone_cases(torch, found)
    errs = {"flash_attention_fwd": [], "ssd_chunk_fwd": []}
    for c in attn:
        print(f"[kernels] flash_attention {c['label']}: {c['shape']} "
              f"({c['regime']} regime)")
        q, k, v, win = c["q"], c["k"], c["v"], c["window"]
        out = fa_ops.flash_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        f32 = q.dtype == torch.float32
        tol = TOL_ATTN if f32 else TOL_ATTN_BF16
        tq, tk, tv = (t.transpose(1, 2) for t in (q, k, v))
        for dtype in (None, torch.float64):
            want = fa_ref.attention_ref(tq, tk, tv, window=win,
                                        dtype=dtype).transpose(1, 2)
            tag = "f64" if dtype else "plain"
            check(torch, f"fwd vs {tag}", out.float(), want, tol,
                  errs["flash_attention_fwd"] if f32 and not dtype else [])
    for c in ssd:
        print(f"[kernels] ssd_chunk {c['label']}: {c['shape']} "
              f"({c['regime']} regime)")
        ins = (c["x"], c["cum"], c["Bm"], c["Cm"])
        y, st = ssd_ops.ssd_chunk(*ins)
        torch.cuda.synchronize()
        for dtype in (torch.float32, torch.float64):
            yw, sw = ssd_ref.ssd_chunk_ref(*ins, dtype=dtype)
            sink = errs["ssd_chunk_fwd"] if dtype == torch.float32 else []
            tag = "f32" if dtype == torch.float32 else "f64"
            check(torch, f"y_diag vs plain {tag}", y, yw, TOL_SSD, sink)
            check(torch, f"states vs plain {tag}", st, sw, TOL_SSD, sink)

    # the autograd Functions: kernel forward + recompute backward against
    # plain autograd, at every main-path operand set
    grads = [(rec, lambda *a, w=rec["kw"].get("window"):
              layers.pallas_attention(*a, w, a[0].shape[1]),
              lambda *a, w=rec["kw"].get("window"):
              layers.chunked_attention(*a, window=w, chunk=a[0].shape[1]),
              TOL_ATTN) for rec in found["attn"].values()]
    grads += [(rec, lambda *a, ch=rec["args"][5]: mamba2.ssd_pallas(
                   *a[:5], ch),
               lambda *a, ch=rec["args"][5]: mamba2.ssd_chunked(*a[:5], ch),
               TOL_SSD) for rec in found["ssd_forward"].values()]
    for rec, kern, plain, tol in grads:
        ins = [a for a in rec["args"] if isinstance(a, torch.Tensor)]
        outs = []
        for fn in (kern, plain):
            ts = [t.clone().requires_grad_() for t in ins]
            o = fn(*ts)
            cot = torch.randn(o.shape, device=DEVICE,
                              generator=torch.Generator(device=DEVICE)
                              .manual_seed(4))
            torch.autograd.backward(o, cot)
            outs.append((o.detach(), [t.grad for t in ts]))
        (o1, g1), (o2, g2) = outs
        name = "attention" if len(ins) == 3 else "ssd"
        shape = "x".join(map(str, ins[0].shape))
        check(torch, f"{name} autograd value {shape} ({rec['label']})", o1,
              o2, tol, [])
        for i, (a, b) in enumerate(zip(g1, g2)):
            check(torch, f"{name} autograd grad[{i}] vs plain autograd", a,
                  b, TOL_GRAD, [])
    return attn, ssd, {k: max(v) for k, v in errs.items()}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def run_experiment(torch, exp, metric_keys, label, rounds):
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec = exp.run_round()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[main] {label} round {rec.round}: {dt * 1e3:.3f} ms "
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


def profile_round(torch, exp, label):
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
        print(f"[profile] {label}: the trace shows no device events: device "
              f"busy share not measured")
        return
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"[profile] {label} round {rec.round}: wall {wall_ms:.3f} ms, "
          f"host scheduler {rec.sched_time_s * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.2%} of wall; idle "
          f"{1 - busy_ms / wall_ms:.2%}), {launches} device ops")
    for e in sorted(events, key=_device_us, reverse=True)[:8]:
        print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def twin_phase(torch, MFLExperiment, arch, dataset, rounds):
    """A small run on the card (kernels) against the same run on the CPU
    (plain versions): same participants, params within 1e-4."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.trees import tree_leaves
    kw = dict(K=4, n_samples=160, arch=arch)
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
    print(f"[main] {arch}/{dataset} twin run ({rounds} rounds) card/kernels "
          f"vs cpu/plain: participants equal, params max|err| {err:.3e} "
          f"(tol 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"{arch}/{dataset}: card and cpu twin runs "
                             f"disagree")


def remat_phase(torch, MFLExperiment, counters, arch):
    """One ``+remat`` round against the plain round on the same seed:
    same participants, params within 1e-6; prints both rounds' launches
    (under remat the cohort forward runs again in the backward)."""
    from repro_torch.core.trees import tree_leaves
    recs, params, counts = [], [], []
    for engine in (MAIN_KW["engine"], MAIN_KW["engine"] + "+remat"):
        exp = MFLExperiment("crema_d", arch=arch,
                            **dict(MAIN_KW, engine=engine))
        reset, read = counters
        reset()
        recs.append(exp.run_round())
        torch.cuda.synchronize()
        counts.append({k: v for k, v in read().items() if v})
        params.append(tree_leaves(exp.global_params))
    if recs[0].participants != recs[1].participants:
        raise AssertionError(f"{arch}: remat changed the participants")
    err = max(float((a - b).abs().max()) for a, b in zip(*params))
    print(f"[remat] {arch}/crema_d one round +remat vs plain: params "
          f"max|err| {err:.3e} (tol 1e-6); launches plain {counts[0]}, "
          f"remat {counts[1]}")
    if err > 1e-6:
        raise AssertionError(f"{arch}: the +remat round differs")


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
                None),
            "fusion_loss_bwd": (
                lambda: ops._launch_bwd(lgs, lab, av, df, dm, out[3],
                                        out[5], c["seg"], shape, False),
                lambda: ref.fusion_loss_ref_grads(stack, lab, av, df, dm),
                None),
            "fusion_loss_reduce": (
                lambda: ops._launch_reduce(partials),
                lambda: partials.sum(dim=1),
                lambda: partials.sum(dim=1)),
        }
        w = work(c, load().fusion_loss_bwd_blocks(shape[1]))
        K, T, V, M = c["shape"]
        shape_txt = (f"K={K} T={T} V={V} M={M}"
                     + (f" seg={c['seg']}" if any(c["seg"]) else ""))
        rows = {}
        for name, (kern, plain, lib) in calls.items():
            lib_txt = ("partials.sum(dim=1)" if lib else
                       "none: no single PyTorch call computes this function")
            rows[name] = time_row(torch, name, label, shape_txt, kern, plain,
                                  lib, lib_txt, w[name])
        per_shape[label] = rows
    return per_shape


def time_row(torch, name, label, shape_txt, kern, plain, lib, lib_txt,
             work_, regime=None, peak_flops=PEAK_F32_FLOPS):
    """``device_ms`` is every device kernel one call of the wrapper
    launches, summed (a call of a kernel in two launches is charged for
    both)."""
    b_ms, b_by = bound(work_, peak_flops)
    if regime:
        shape_txt = f"{shape_txt} ({regime})"
    row = {"ms": time_ms(torch, kern),
           "device_ms": device_ms(torch, kern),
           "plain_ms": time_ms(torch, plain, iters=20, warmup=3),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": (time_ms(torch, lib) if lib else None),
           "library_device_ms": (device_ms(torch, lib) if lib else None),
           "shape": shape_txt, "label": label}
    dev_txt = ("not measured" if row["device_ms"] is None
               else f"{row['device_ms']:.6f} ms")
    lib_ms = ("" if lib is None else
              f"{row['library_ms']:.6f} ms (device "
              + ("not measured" if row["library_device_ms"] is None
                 else f"{row['library_device_ms']:.6f} ms") + ") ")
    print(f"[time] {label} {name} ({shape_txt}): {row['ms']:.6f} ms/launch "
          f"(device {dev_txt}), plain {row['plain_ms']:.6f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}), library {lib_ms}({lib_txt})")
    return row


def attn_work(c):
    """(bytes, operations) of one attention call: q, k, v read once, o
    written once; per visible (query, key) pair the two hd-long products
    (4·hd) plus scale, exp and sum."""
    B, S, H, hd = c["q"].shape
    KH = c["k"].shape[2]
    esz = c["q"].element_size()
    win = c["window"]
    pairs = sum(min(i + 1, win) if win else i + 1 for i in range(S))
    return ((2 * B * S * H * hd + 2 * B * S * KH * hd) * esz,
            B * H * pairs * (4 * hd + 3))


def ssd_work(c):
    """(bytes, operations) of one SSD chunk call: x, cum, B, C read once,
    y_diag and the states written once.  Per (batch, chunk) the lower
    triangle of C·Bᵀ, 2N a pair (the scores do not depend on the head);
    per head the decay on it (exp and product, 2 a pair), W·x over the
    triangle (2·hp a pair), the decay to the chunk's end (Q exps), x
    scaled by it (Q·hp) and the state product Bᵀ·(decay ∘ x) (2·Q·N·hp)."""
    B, nc, Q, nh, hp = c["x"].shape
    N = c["Bm"].shape[-1]
    nbytes = 4 * (2 * c["x"].numel() + c["cum"].numel()
                  + 2 * c["Bm"].numel() + B * nc * nh * N * hp)
    tri = Q * (Q + 1) // 2
    head = tri * 2 + tri * 2 * hp + Q + Q * hp + 2 * Q * N * hp
    return nbytes, B * nc * (tri * 2 * N + nh * head)


def backbone_timing_phase(torch, attn, ssd):
    """Times of the two backbone kernels at every case; the library call
    for attention is ``F.scaled_dot_product_attention(..., is_causal=True)``
    at the shapes without a window (timing only; the port never calls
    it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    rows = {"flash_attention_fwd": [], "ssd_chunk_fwd": []}
    for c in attn:
        q, k, v, win = c["q"], c["k"], c["v"], c["window"]
        tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = None
        if win is None:
            R = q.shape[2] // k.shape[2]
            ek, ev = (t.repeat_interleave(R, dim=1) for t in (tk, tv))
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                tq, ek, ev, is_causal=True)
        rows["flash_attention_fwd"].append(time_row(
            torch, "flash_attention_fwd", c["label"], c["shape"],
            lambda: fa_ops._launch(q, k, v, win),
            lambda: fa_ref.attention_ref(tq, tk, tv, window=win), lib,
            "F.scaled_dot_product_attention(is_causal=True)" if lib else
            "none: SDPA takes no sliding window",
            attn_work(c), c["regime"],
            PEAK_F32_FLOPS if q.dtype == torch.float32 else PEAK_BF16_FLOPS))
    for c in ssd:
        ins = (c["x"], c["cum"], c["Bm"], c["Cm"])
        rows["ssd_chunk_fwd"].append(time_row(
            torch, "ssd_chunk_fwd", c["label"], c["shape"],
            lambda: ssd_ops._launch(*ins),
            lambda: ssd_ref.ssd_chunk_ref(*ins), None,
            "none: no single PyTorch call computes this function",
            ssd_work(c), c["regime"]))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 1
    from repro_torch.fl.eval import metric_keys
    from repro_torch.fl.runtime import MFLExperiment
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fusion_loss import ops, ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = gpu_line()
    print(f"[gpu] {card}")
    t_start = time.perf_counter()

    def reset_counts():
        for m in (ops, fa_ops, ssd_ops):
            m.reset_launch_counts()

    def read_counts():
        return {**ops.launch_counts(), **fa_ops.launch_counts(),
                **ssd_ops.launch_counts()}

    # phase 1: build
    build_phase()

    # phase 2: the main path's experiments, and the kernels against their
    # plain versions at the shapes those experiments give them
    exps = {}
    for arch, dataset, _ in MAIN_PATH:
        t0 = time.perf_counter()
        exps[arch, dataset] = MFLExperiment(dataset, arch=arch, **MAIN_KW)
        print(f"[main] {arch}/{dataset}: set-up "
              f"{time.perf_counter() - t0:.3f} s")
    cases, max_err = kernel_phase(
        torch, ops, ref, {d: e for (a, d), e in exps.items()
                          if a == "lstm-cnn"})
    found = capture_backbone_operands(
        torch, {key: e for key, e in exps.items() if key[0] != "lstm-cnn"})
    attn, ssd, bb_err = backbone_kernel_phase(torch, found)
    max_err.update(bb_err)

    # phase 3: the main path, counters set to 0 just before and read after
    # each run
    launches = {k: 0 for k in read_counts()}
    for arch, dataset, rounds in MAIN_PATH:
        label = f"{arch}/{dataset}"
        reset_counts()
        run_experiment(torch, exps[arch, dataset], metric_keys, label,
                       rounds)
        now = read_counts()
        print(f"[main] {label} launches ({rounds} rounds): {now}")
        for name in ARCH_KERNELS[arch]:
            if not now[name]:
                raise AssertionError(f"{name} was not launched by {label}")
        for k, v in now.items():
            launches[k] += v
    if launches["fusion_loss_reduce"]:
        raise AssertionError("the training step launched the partial reduce")
    for arch in ("transformer", "ssd"):
        remat_phase(torch, MFLExperiment, (reset_counts, read_counts), arch)
    for arch, dataset, rounds in MAIN_PATH:
        twin_phase(torch, MFLExperiment, arch, dataset, min(rounds, 2))
    for arch in ("lstm-cnn", "transformer", "ssd"):
        profile_round(torch, exps[arch, "crema_d"], f"{arch}/crema_d")

    # phase 4: times
    times = timing_phase(torch, ops, ref, cases)
    bb_times = backbone_timing_phase(torch, attn, ssd)

    def entry(name):
        rows = (bb_times[name] if name in bb_times else
                [times[label][name] for label in times])
        row = rows[0]
        return {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "shape": row["shape"],
            "other_shapes": rows[1:],
        }

    # the partial reduce runs only where gsq/gdot are asked for
    # (fusion_loss_grads), not on the main path
    print("[reduce] " + json.dumps(entry("fusion_loss_reduce")))
    kernels = [entry(name) for name in PATH_KERNELS]
    print(f"[done] {time.perf_counter() - t_start:.3f} s after the card "
          f"check")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
