"""Run the port's LM-scale dry run over archs × meshes in parallel and
print its tables.

    PYTHONPATH=src python3 tools/dryrun_sweep.py --device cuda --jobs 8 \\
        --out build/dryrun_sweep [--blocks 1] [--archs qwen3-0.6b,...] \\
        [--shape train_4k] [--override attn_chunk=4096]

One ``python -m repro_torch.launch.dryrun`` process an arch and mesh (all
shapes in turn, or ``--shape``), ``--jobs`` at a time, each logging to
``<out>/<tag>.log`` (``dryrun.start_combo``) and writing its records to
``<out>``.  Then it prints the table of statuses and splits (a cell reads
16×16 / 2×16×16; the number after an ``ok`` is ``counted_flops_global /
counted_flops_per_rank``, 256 / 512 where the step splits evenly) and,
per arch with a train_4k record on both meshes, ``counted_flops_per_rank``
on each and the ratio 2×16×16 / 16×16, and the wall time.  ``--tables``
prints the tables of the records already in ``--out`` without running.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

MESHES = ("16x16", "2x16x16")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _run(arch, mesh, args):
    t0 = time.perf_counter()
    proc, _ = D.start_combo(arch, mesh, args.out, shape_name=args.shape,
                            blocks=args.blocks, device=args.device,
                            overrides=args.overrides)
    return arch, mesh, proc.wait(), time.perf_counter() - t0


def _record(out, arch, shape, mesh, blocks, overrides):
    return D.read_record(out, D.record_tag(arch, shape, mesh, overrides,
                                           blocks))


def _split(rec):
    return rec["counted_flops_global"] / rec["counted_flops_per_rank"]


def tables(out, archs, shapes, blocks, overrides=None):
    print("| arch | " + " | ".join(shapes) + " |")
    print("| --- |" + " --- |" * len(shapes))
    errors = []
    for a in archs:
        cells = []
        for s in shapes:
            parts = []
            for m in MESHES:
                rec = _record(out, a, s, m, blocks, overrides)
                if rec is None:
                    parts.append("-")
                elif rec["status"] == "ok":
                    parts.append(f"ok {_split(rec):.1f}")
                else:
                    parts.append(rec["status"])
                    if rec["status"] == "error":
                        errors.append(f"{a} {s} {m}: {rec.get('error')}")
            cells.append(" / ".join(parts))
        print(f"| {a} | " + " | ".join(cells) + " |")
    for e in errors:
        print("error:", e)
    if "train_4k" in shapes:
        print("\n| arch | train_4k flops a rank, 16x16 | 2x16x16 | "
              "2x16x16 / 16x16 | peak bytes a rank, 16x16 | 2x16x16 |")
        print("| --- | --- | --- | --- | --- | --- |")
        for a in archs:
            one, two = (_record(out, a, "train_4k", m, blocks, overrides)
                        for m in MESHES)
            if not (one and two and one["status"] == two["status"] == "ok"):
                continue
            f1, f2 = (r["counted_flops_per_rank"] for r in (one, two))
            print(f"| {a} | {f1:.4e} | {f2:.4e} | {f2 / f1:.3f} | "
                  f"{one['counted_peak_bytes_per_rank']} | "
                  f"{two['counted_peak_bytes_per_rank']} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "dryrun_sweep"))
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--archs", default=None)
    ap.add_argument("--shape", default=None, choices=SHAPES)
    ap.add_argument("--override", action="append", default=[],
                    help="k=v, a lever of the dry run (e.g. attn_chunk=4096)")
    ap.add_argument("--tables", action="store_true",
                    help="print the tables of the records in --out only")
    args = ap.parse_args(argv)
    args.overrides = D.parse_overrides(args.override)
    archs = args.archs.split(",") if args.archs else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)
    if not args.tables:
        t0 = time.perf_counter()
        # the 2x16x16 processes, the longer ones, first
        jobs = [(a, m) for m in reversed(MESHES) for a in archs]
        with ThreadPoolExecutor(args.jobs) as pool:
            for arch, mesh, rc, dt in pool.map(lambda j: _run(*j, args),
                                               jobs):
                print(f"[sweep] {arch} {mesh}: exit {rc}, {dt:.1f} s",
                      flush=True)
        print(f"[sweep] {len(jobs)} processes, {args.jobs} at a time: "
              f"{time.perf_counter() - t0:.1f} s")
    tables(args.out, archs, shapes, args.blocks, args.overrides)
    return 0


if __name__ == "__main__":
    sys.exit(main())
