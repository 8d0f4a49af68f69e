"""Time two builds of the backbone kernels on one card, in turns.

    python3 tools/ab_backbone_kernels.py --old DIR

``DIR`` holds an earlier revision's ``flash_attention.cu`` and
``ssd_scan.cu`` with the C interface of revision 0458bfa (one launch per
call, no regime arguments), e.g. from ``git show 0458bfa:<path>``.  Both
builds are compiled with the same nvcc flags (``kernels/nvcc.py``), run on
the same operands, checked against each other, and timed by
``chip_smoke.device_ms`` (every device kernel of a call, summed, from
``torch.profiler``) in the order old, new, new, old; the attention
shapes without a window add ``F.scaled_dot_product_attention``'s device
time (a yardstick only).  Shapes: the training path's cohort and eval
stacks, the JAX package's kernel sweeps (tests/test_kernels.py) and the
JAX configs' 256-token SSD chunks, which the old build refuses.  One JSON
object per shape goes to ``--out``; a table goes to stdout.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import device_ms  # noqa: E402
from repro_torch.kernels.nvcc import CudaLibrary, check  # noqa: E402

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: (label, B, S, H, KH, hd, window, dtype name, layout): "bshd" is the
#: model's layout, "bhsd" the sweep's strided view
ATTN = [
    ("cohort S=32", 960, 32, 4, 4, 8, None, "float32", "bshd"),
    ("eval S=32", 240, 32, 4, 4, 8, None, "float32", "bshd"),
    ("cohort S=24", 960, 24, 4, 4, 8, None, "float32", "bshd"),
    ("eval S=24", 240, 24, 4, 4, 8, None, "float32", "bshd"),
] + [(f"sweep {dt}", B, S, H, KH, hd, w, dt, "bhsd")
     for dt in ("float32", "bfloat16")
     for B, H, KH, S, hd, w in ((1, 4, 2, 128, 64, None),
                                (2, 4, 4, 256, 32, None),
                                (1, 8, 2, 256, 64, 64),
                                (1, 2, 1, 512, 128, 128))]
#: (label, B, nc, Q, nh, hp, N)
SSD = [("cohort S=32", 960, 4, 8, 8, 8, 16), ("eval S=32", 240, 4, 8, 8, 8, 16),
       ("cohort S=24", 960, 3, 8, 8, 8, 16), ("eval S=24", 240, 3, 8, 8, 8, 16),
       ("sweep", 1, 2, 64, 2, 32, 16), ("sweep", 2, 4, 32, 4, 16, 8),
       ("sweep", 1, 1, 128, 8, 64, 32),
       ("mamba2-370m chunk", 1, 1, 256, 2, 64, 128),
       ("jamba chunk", 1, 1, 256, 2, 64, 16)]


def old_libraries(old_dir: Path):
    """The earlier revision's two libraries, built into DIR/../build."""
    fa = CudaLibrary(old_dir / "flash_attention.cu", {
        "flash_attention_fwd": [_P] * 4 + [_L] * 12 + [_I] * 7 + [_P]})
    ssd = CudaLibrary(old_dir / "ssd_scan.cu", {
        "ssd_chunk_fwd": [_P] * 6 + [_I] * 6 + [_P],
        "ssd_chunk_smem_bytes": [_I] * 3,
        "ssd_chunk_max_smem_bytes": []})
    return fa, ssd


def turns(torch, old, new):
    """Device ms of old and new, timed old, new, new, old."""
    a1, b1, b2, a2 = (device_ms(torch, f) for f in (old, new, new, old))
    mean = lambda x, y: None if x is None or y is None else (x + y) / 2  # noqa: E731
    return dict(old_ms=mean(a1, a2), new_ms=mean(b1, b2),
                old_runs=[a1, a2], new_runs=[b1, b2])


def attention_rows(torch, fa_old):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, B, S, H, KH, hd, win, dt, layout in ATTN:
        dtype = getattr(torch, dt)
        if layout == "bshd":
            shp = ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd))
            q, k, v = (torch.randn(s, device="cuda", generator=g).to(dtype)
                       for s in shp)
        else:
            shp = ((B, H, S, hd), (B, KH, S, hd), (B, KH, S, hd))
            q, k, v = (torch.randn(s, device="cuda", generator=g).to(dtype)
                       .transpose(1, 2) for s in shp)
        o_old = torch.empty((B, S, H, hd), dtype=dtype, device="cuda")
        strides = [s for t in (q, k, v, o_old) for s in t.stride()[:3]]
        lib = fa_old.load()

        def old():
            check(lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o_old.data_ptr(),
                *strides, ops._DTYPES[dtype], B, H, KH, S, hd, win or 0,
                torch.cuda.current_stream().cuda_stream), "old attention")

        def new():
            return ops._launch(q, k, v, win)

        old()
        err = float((new().float() - o_old.float()).abs().max())
        row = dict(kernel="flash_attention_fwd", label=label,
                   shape=f"B={B} S={S} H={H} KH={KH} hd={hd}"
                         + (f" window={win}" if win else "") + f" {dt}",
                   regime=ops.plan(B, S, H, KH, hd, dtype).regime,
                   max_abs_diff_old_new=err, **turns(torch, old, new))
        if win is None:
            tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            ek, ev = (t.repeat_interleave(H // KH, dim=1) for t in (tk, tv))
            row["sdpa_ms"] = device_ms(torch, lambda: (
                F.scaled_dot_product_attention(tq, ek, ev, is_causal=True)))
        rows.append(row)
    return rows


def ssd_rows(torch, ssd_old):
    from repro_torch.kernels.ssd_scan import ops
    g = torch.Generator(device="cuda").manual_seed(1)
    lib = ssd_old.load()
    rows = []
    for label, B, nc, Q, nh, hp, N in SSD:
        x = torch.randn((B, nc, Q, nh, hp), device="cuda", generator=g)
        cum = torch.cumsum(-torch.rand((B, nc, Q, nh), device="cuda",
                                       generator=g) * 0.1, dim=2)
        Bm, Cm = (torch.randn((B, nc, Q, N), device="cuda", generator=g)
                  for _ in range(2))
        y_old = torch.empty_like(x)
        s_old = torch.empty((B, nc, nh, N, hp), device="cuda")
        fits = lib.ssd_chunk_smem_bytes(Q, hp, N) \
            <= lib.ssd_chunk_max_smem_bytes()

        def old():
            check(lib.ssd_chunk_fwd(
                x.data_ptr(), cum.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y_old.data_ptr(), s_old.data_ptr(), B, nc, Q, nh, hp, N,
                torch.cuda.current_stream().cuda_stream), "old ssd")

        def new():
            return ops._launch(x, cum, Bm, Cm)

        row = dict(kernel="ssd_chunk_fwd", label=label,
                   shape=f"B={B} nc={nc} Q={Q} nh={nh} hp={hp} N={N}",
                   regime=ops.plan(B, nc, Q, nh, hp, N).regime)
        if fits:
            old()
            y, s = new()
            row["max_abs_diff_old_new"] = max(
                float((y - y_old).abs().max()), float((s - s_old).abs().max()))
            row.update(turns(torch, old, new))
        else:
            row.update(old_ms=None, new_ms=device_ms(torch, new),
                       note="the old build refuses this chunk")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the earlier flash_attention.cu and "
                         "ssd_scan.cu")
    ap.add_argument("--out", default="build/compare.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[gpu] {card}")
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.ssd_scan import build as ssd_build
    fa_old, ssd_old = old_libraries(args.old.resolve())
    for lib in (fa_old, ssd_old, fa_build.LIBRARY, ssd_build.LIBRARY):
        lib.build()
    rows = attention_rows(torch, fa_old) + ssd_rows(torch, ssd_old)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(dict(r, card=card)) + "\n")
    fmt = lambda x: "-" if x is None else f"{x:.6f}"  # noqa: E731
    for r in rows:
        print(f"[compare] {r['kernel']:20s} {r['label']:18s} {r['shape']:42s}"
              f" {r['regime']:8s} old {fmt(r['old_ms'])} new "
              f"{fmt(r['new_ms'])} ms"
              + (f" sdpa {fmt(r['sdpa_ms'])}" if "sdpa_ms" in r else "")
              + (f" |old-new| {r['max_abs_diff_old_new']:.2e}"
                 if "max_abs_diff_old_new" in r else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
