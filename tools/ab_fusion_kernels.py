"""Time two builds of the fusion-loss kernels on one card, in turns, and
sweep the new kernels' regimes and widths.

    python3 tools/ab_fusion_kernels.py --old DIR [--sweep] [--exact-exp]
                                       [--out FILE]

``DIR`` holds an earlier revision's ``fusion_loss.cu`` with the C interface
of revision fc3e02b (float32 operands only, one warp per row, no regime
arguments), e.g. from ``git show fc3e02b:<path>``.  Both builds are compiled
with the same nvcc flags (``kernels/nvcc.py``), run on the same operands,
checked against each other, and timed by ``chip_smoke.device_ms`` (every
device kernel of a call, summed, from ``torch.profiler``) in the order old,
new, new, old: the forward, and the backward as the training step runs it
(no partials).  The old build reads float32 only, so a bfloat16 shape
charges it the float32 copy its wrapper made.  Shapes: the paper's client
stacks (CREMA-D, IEMOCAP), the LM-like shape with a broadcast head in
float32 and bfloat16, and the JAX package's fusion sweep
(tests/test_kernels.py) in both types.  Repeated calls on one operand set
find part of it in the card's L2 (50 MB); the LM-like shape is also timed
cold, its calls rotating over enough operand sets that ``COLD_BYTES`` of
other operands pass between two reads of one set (``cache`` in the rows).
A ``[floor]`` line gives the device time of a one-element ``add_``, the
launch floor the tiny shapes are held against, and the wrappers' host time
per call (CUDA events) at CREMA-D.

``--sweep`` adds the new kernels at every width each direction builds, at
each shape, and the rows regime against a warp per row at V = 12..64 over
960..8192 rows, to choose the plan's widths and edges from.
``--exact-exp`` adds a copy of the new source with every ``__expf`` made
the libm ``expf`` against the default build, in turns, at every shape.  One
JSON object per row goes to ``--out``; a table to stdout.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from ab_backbone_kernels import turns  # noqa: E402
from chip_smoke import device_ms, time_ms  # noqa: E402
from repro_torch.kernels.nvcc import CudaLibrary, check  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int

#: (label, K, T, V, M, seg, dtype name)
SHAPES = [
    ("crema_d", 10, 96, 6, 2, (0, 0), "float32"),
    ("iemocap", 10, 96, 10, 2, (0, 0), "float32"),
    ("lm", 1, 512, 32000, 3, (0, 0, 128), "float32"),
    ("lm", 1, 512, 32000, 3, (0, 0, 128), "bfloat16"),
] + [("sweep", 1, T, V, M, (0,) * M, dt)
     for dt in ("float32", "bfloat16")
     for M, T, V in ((1, 128, 1024), (2, 256, 2048), (3, 64, 4096),
                     (4, 128, 512))]
#: bytes of other operands that pass between two reads of one operand set
#: in a cold timing (four times an H100's 50 MB L2)
COLD_BYTES = 200e6
#: the rows-versus-warp edge: (K, T) at each V
EDGE_ROWS = ((10, 96), (16, 128), (32, 128), (64, 128))
EDGE_V = (12, 13, 14, 15, 16, 24, 32, 48, 64)


def old_library(old_dir: Path) -> CudaLibrary:
    return CudaLibrary(old_dir / "fusion_loss.cu", {
        "fusion_loss_fwd": [_P] * 4 + [_I] * 5 + [_P, _P] + [_I] * 3
                           + [_P] * 6 + [_P],
        "fusion_loss_bwd": [_P] * 4 + [_I] * 5 + [_P] * 6 + [_I] * 3
                           + [_P] * 5 + [_P]})


def make_inputs(torch, K, T, V, M, seg, dtype, seed):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x, device="cuda")     # noqa: E731
    lg = [t((rng.normal(size=(K, T // s if s else T, V)) * 3)
            .astype(np.float32)).to(dtype) for s in seg]
    labels = t(rng.integers(0, V, (K, T)).astype(np.int32))
    avail = np.ones((M, K, T), np.float32)
    avail[1:] = rng.integers(0, 2, (M - 1, K, 1))
    avail[:, 0, 0] = 0.0
    df = t(rng.normal(size=(K, T)).astype(np.float32))
    dm = t(rng.normal(size=(M, K, T)).astype(np.float32))
    return lg, labels, t(avail), df, dm


def shape_text(K, T, V, M, seg, dt):
    return (f"K={K} T={T} V={V} M={M}"
            + (f" seg={seg}" if any(seg) else "") + f" {dt}")


def rotate(fns):
    """One call that runs the next of ``fns`` each time it is called."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def prepare(torch, ops, lib, K, T, V, M, seg, dtype, seed):
    """One operand set and the calls on it: ``new_fwd`` / ``new_bwd`` and,
    given the old library ``lib``, ``old_fwd`` / ``old_bwd`` (backwards
    without partials) with the largest old-new differences."""
    lg, labels, avail, df, dm = make_inputs(torch, K, T, V, M, seg, dtype,
                                            seed)
    lgs, lab, av, shape = ops._kernel_operands(lg, labels, avail, seg)
    new_out = ops._launch_fwd(lgs, lab, av, seg, shape)
    f_lse, m_lse = new_out[3], new_out[5]
    c = dict(nbytes=sum(x.numel() * x.element_size() for x in lgs),
             new_fwd=lambda: ops._launch_fwd(lgs, lab, av, seg, shape),
             new_bwd=lambda: ops._launch_bwd(lgs, lab, av, df, dm, f_lse,
                                             m_lse, seg, shape,
                                             with_partials=False))
    if lib is None:
        return c
    segs = list(seg) + [0] * (4 - M)
    KT = K * T
    o_old = [torch.empty(n, device="cuda") for n in (KT, M * KT) * 3]
    d_old = [torch.empty((K, T, V), device="cuda") for _ in range(M)]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def f32(xs):
        # the old wrapper's float32 copy (a no-op view for float32)
        return [x.float().contiguous() for x in xs]

    def old_fwd():
        xs = f32(lgs)
        check(lib.fusion_loss_fwd(
            *ops._ptrs(xs), *segs, M, lab.data_ptr(), av.data_ptr(), K,
            T, V, *(o.data_ptr() for o in
                    (o_old[0], o_old[1], o_old[2], o_old[4], o_old[3],
                     o_old[5])), stream()), "old fwd")

    def old_bwd():
        xs = f32(lgs)
        check(lib.fusion_loss_bwd(
            *ops._ptrs(xs), *segs, M, lab.data_ptr(), av.data_ptr(),
            df.data_ptr(), dm.data_ptr(), f_lse.data_ptr(),
            m_lse.data_ptr(), K, T, V, *ops._ptrs(d_old), None,
            stream()), "old bwd")

    old_fwd()
    old_bwd()
    dl, _ = c["new_bwd"]()
    torch.cuda.synchronize()
    c.update(old_fwd=old_fwd, old_bwd=old_bwd,
             diff_fwd=float((new_out[0] - o_old[0].view(K, T)).abs().max()),
             diff_bwd=max(float((a - b).abs().max())
                          for a, b in zip(dl, d_old)))
    return c


def operand_sets(torch, ops, lib, shape, seed):
    """[(cache, sets)]: one set, timed warm, and at the LM-like shape also
    enough sets that COLD_BYTES of other operands pass between two reads
    of one, timed cold."""
    label, K, T, V, M, seg, dt = shape
    args = (torch, ops, lib, K, T, V, M, seg, getattr(torch, dt))
    first = prepare(*args, seed)
    out = [("warm", [first])]
    if label == "lm":
        n = 1 + math.ceil(COLD_BYTES / first["nbytes"])
        out.append(("cold", [first] + [prepare(*args, 1000 * (seed + 1) + j)
                                       for j in range(1, n)]))
    return out


def ab_rows(torch, ops, old_lib):
    """Old against new at every shape, both directions."""
    lib = old_lib.load()
    rows = []
    for i, shape in enumerate(SHAPES):
        label, K, T, V, M, seg, dt = shape
        p = ops.plan(K, T, V, M, seg, getattr(torch, dt))
        for cache, sets in operand_sets(torch, ops, lib, shape, i):
            for d, launch in (("fwd", p.fwd), ("bwd", p.bwd)):
                rows.append(dict(
                    kernel=f"fusion_loss_{d}", label=label, cache=cache,
                    shape=shape_text(*shape[1:]),
                    regime=f"{p.regime}/{launch.width}",
                    max_abs_diff_old_new=max(s[f"diff_{d}"] for s in sets),
                    **turns(torch, rotate([s[f"old_{d}"] for s in sets]),
                            rotate([s[f"new_{d}"] for s in sets]))))
    return rows


def sweep_rows(torch, ops):
    """The new kernels at every width each direction builds, at each shape
    (forward and backward device ms), and the rows regime against a warp
    per row at the edge cases."""
    cases = list(SHAPES)
    cases += [("edge", K, T, V, 2, (0, 0), "float32")
              for K, T in EDGE_ROWS for V in EDGE_V]
    rows = []
    for i, (label, K, T, V, M, seg, dt) in enumerate(cases):
        dtype = getattr(torch, dt)
        lg, labels, avail, df, dm = make_inputs(torch, K, T, V, M, seg,
                                                dtype, 100 + i)
        lgs, lab, av, shape = ops._kernel_operands(lg, labels, avail, seg)
        esize = dtype.itemsize
        # (regime, forward width, backward width or None: not timed)
        widths = ([("rows", ops.ROWS_R, ops.ROWS_R)]
                  if V <= ops.ROWS_MAX_V else [])
        widths += ([("group", 32, 32)] if label == "edge" else
                   [("group", G, G if G in ops.BWD_WIDTHS else None)
                    for G in ops.FWD_WIDTHS])
        chosen = ops.plan(K, T, V, M, seg, dtype)
        for regime, wf, wb in widths:
            p = ops.make_plan(regime, wf, K, T, V, M, esize, wb)
            out = ops._launch_fwd(lgs, lab, av, seg, shape, p=p)
            fwd = device_ms(torch, lambda: ops._launch_fwd(
                lgs, lab, av, seg, shape, p=p))
            bwd = device_ms(torch, lambda: ops._launch_bwd(
                lgs, lab, av, df, dm, out[3], out[5], seg, shape,
                with_partials=False, p=p)) if wb else None
            rows.append(dict(kernel="sweep", label=label,
                             shape=shape_text(K, T, V, M, seg, dt),
                             regime=f"{regime}/{wf}",
                             planned=(p.fwd == chosen.fwd,
                                      bool(wb) and p.bwd == chosen.bwd),
                             fwd_ms=fwd, bwd_ms=bwd))
    return rows


def exact_exp_rows(torch, ops, build):
    """The default build (``__expf``) against a copy of its source with the
    libm ``expf``, in turns, forward and backward, at every shape."""
    src = build.LIBRARY.source
    vdir = Path(build.LIBRARY.build_dir) / "exact_exp"
    vdir.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    if "__expf(" not in text:
        raise RuntimeError(f"{src} calls no __expf")
    (vdir / src.name).write_text(text.replace("__expf(", "expf("))
    exact = CudaLibrary(vdir / src.name, build.LIBRARY.signatures)
    exact.build()

    def on(lib, fn):
        def call():
            keep, build.load = build.load, lib.load
            try:
                return fn()
            finally:
                build.load = keep
        return call

    rows = []
    for i, shape in enumerate(SHAPES):
        label = shape[0]
        for cache, sets in operand_sets(torch, ops, None, shape, i):
            for d, pick in (("fwd", lambda r: r[0]),
                            ("bwd", lambda r: r[0][0])):
                fast = [s[f"new_{d}"] for s in sets]
                a, b = pick(fast[0]()), pick(on(exact, fast[0])())
                torch.cuda.synchronize()
                t = turns(torch, rotate([on(exact, f) for f in fast]),
                          rotate(fast))
                rows.append(dict(kernel=f"exp {d}", label=label, cache=cache,
                                 shape=shape_text(*shape[1:]),
                                 exact_ms=t["old_ms"], fast_ms=t["new_ms"],
                                 exact_runs=t["old_runs"],
                                 fast_runs=t["new_runs"],
                                 max_abs_diff=float((a - b).abs().max())))
    return rows


def floor_row(torch, ops):
    """The launch floor and the wrappers' host time at CREMA-D."""
    one = torch.zeros(1, device="cuda")
    floor = device_ms(torch, lambda: one.add_(1.0))
    lg, labels, avail, df, dm = make_inputs(torch, 10, 96, 6, 2, (0, 0),
                                            torch.float32, 0)
    out = ops.fusion_loss_fwd(lg, labels, avail, (0, 0))
    host_f = time_ms(torch, lambda: ops.fusion_loss_fwd(lg, labels, avail,
                                                        (0, 0)))
    host_b = time_ms(torch, lambda: ops.fusion_loss_bwd(
        lg, labels, avail, df, dm, out[3], out[5], (0, 0),
        with_partials=False))
    return dict(kernel="floor", label="add_ of one element", floor_ms=floor,
                fwd_ms_per_launch=host_f, bwd_ms_per_launch=host_b)


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the earlier fusion_loss.cu")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every regime and width")
    ap.add_argument("--exact-exp", action="store_true",
                    help="also time a build with libm expf")
    ap.add_argument("--out", default="build/compare_fusion.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[gpu] {card}")
    from repro_torch.kernels.fusion_loss import build, ops
    old = old_library(args.old.resolve())
    for lib in (old, build.LIBRARY):
        lib.build()
    rows = [floor_row(torch, ops)] + ab_rows(torch, ops, old)
    if args.sweep:
        rows += sweep_rows(torch, ops)
    if args.exact_exp:
        rows += exact_exp_rows(torch, ops, build)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(dict(r, card=card)) + "\n")
    fmt = lambda x: "-" if x is None else f"{x:.6f}"  # noqa: E731
    for r in rows:
        if r["kernel"] == "floor":
            print(f"[floor] {card}: one-element add_ {fmt(r['floor_ms'])} ms "
                  f"device; wrapper host time at CREMA-D: forward "
                  f"{fmt(r['fwd_ms_per_launch'])} ms/launch, backward "
                  f"{fmt(r['bwd_ms_per_launch'])} ms/launch")
        elif r["kernel"].startswith("exp "):
            print(f"[exp] {r['kernel']} {r['label']:8s} {r['cache']} "
                  f"{r['shape']:44s} "
                  f"expf {fmt(r['exact_ms'])} __expf {fmt(r['fast_ms'])} ms "
                  f"|diff| {r['max_abs_diff']:.2e}")
        elif r["kernel"] == "sweep":
            pf, pb = r["planned"]
            print(f"[sweep] {r['label']:8s} {r['shape']:44s} "
                  f"{r['regime']:10s} fwd {fmt(r['fwd_ms'])}"
                  f"{'*' if pf else ' '} bwd {fmt(r['bwd_ms'])}"
                  f"{'*' if pb else ' '} ms")
        else:
            print(f"[compare] {r['kernel']:16s} {r['label']:8s} "
                  f"{r['cache']} {r['shape']:44s} {r['regime']:10s} old "
                  f"{fmt(r['old_ms'])} new {fmt(r['new_ms'])} ms "
                  f"|old-new| {r['max_abs_diff_old_new']:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
