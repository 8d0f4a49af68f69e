"""The JAX package's compile beside the port's dry run: per-device FLOPs
at one super-block on the 16×16 and 2×16×16 meshes.

    PYTHONPATH=src python3 tools/dryrun_vs_jax.py [--archs a,b] \\
        [--shapes train_4k,prefill_32k] [--attn-chunk N] [--port DIR]

Runs ``repro.launch.dryrun.lower_combo`` (the JAX package's own dry run,
on 512 forced host devices of the CPU) for each arch cut to one
super-block as its ``calibrate`` cuts it (``n_layers`` = the super-block's
layers, ``encoder_layers=1`` for an encoder-decoder) and prints, a device
and mesh: XLA's ``hlo_flops``, and the FLOPs of the partitioned program's
dot ops (2 × output elements × contracted size), split into the dots with
a batch dimension (attention's score and value products, the experts'
GEMMs) and the rest (the projections).  ``--attn-chunk N`` (as the
``attn_chunk`` lever) with N the sequence leaves attention no chunk loop,
whose body XLA's counts see once.

With ``--port DIR`` (the port's records at one super-block, e.g. of
``tools/dryrun_sweep.py --blocks 1 --shape S [--override attn_chunk=N]``
from a card's host) it prints the port's ``counted_flops_per_rank`` and
``counted_batched_flops_per_rank`` beside them and port / JAX of the
batched and of the other FLOPs, and the port's ratio to 16×16 over
XLA's.  CPU only; imports JAX, not the port.

``compile_record`` is also the JAX side of
``tests/test_torch_dryrun.py``'s per-rank FLOPs checks.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

ARCHS = ("qwen3-0.6b", "qwen3-4b", "gemma3-12b", "llava-next-34b",
         "llama4-scout-17b-a16e", "qwen2-72b", "whisper-base",
         "mamba2-370m")
MESHES = ("16x16", "2x16x16")

_DEF = re.compile(r"%([\w.\-]+) = \w+\[([\d,]*)\]")
_DOT = re.compile(r"%[\w.\-]+ = \w+\[([\d,]*)\]\S* dot\(%([\w.\-]+), "
                  r"%[\w.\-]+\)(.*)")


def _dims(text: str) -> list:
    return [int(d) for d in text.split(",") if d]


def dot_flops(hlo: str) -> tuple:
    """(batched, other) FLOPs of the dot ops of an HLO module's text:
    2 × output elements × the contracted size each, a dot with a batch
    dimension of more than one element in the first."""
    shapes = {m.group(1): _dims(m.group(2)) for m in _DEF.finditer(hlo)}
    batched = other = 0
    for m in _DOT.finditer(hlo):
        lhs, attrs = shapes[m.group(2)], m.group(3)
        flops = 2
        for d in _dims(m.group(1)):
            flops *= d
        for key, into in (("lhs_contracting_dims", None),
                          ("lhs_batch_dims", "batch")):
            got = re.search(key + r"=\{([\d,]*)\}", attrs)
            size = 1
            for d in _dims(got.group(1)) if got else ():
                size *= lhs[d]
            if into is None:
                flops *= size
            else:
                n_batch = size
        if n_batch > 1:
            batched += flops
        else:
            other += flops
    return batched, other


def compile_record(arch: str, shape, *, mesh="16x16", cfg_kw=None,
                   overrides=None) -> dict:
    """The JAX package's compile of ``arch`` cut to one super-block on
    ``mesh`` ("16x16", "2x16x16", or dims of a ("data", "model") mesh of
    the forced host devices): ``hlo_flops``, ``batched_dot_flops`` and
    ``other_dot_flops`` a device.  ``shape`` is an input shape's name or
    (name, seq_len, global_batch, kind); ``cfg_kw`` replaces config
    fields after the cut, ``overrides`` are ``lower_combo``'s levers."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    from repro.configs import get_config
    from repro.launch import dryrun as JD, specs
    if not isinstance(mesh, str):
        dims = tuple(mesh)
        JD.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
            dims, ("data", "model"))
    if not isinstance(shape, str):
        specs.INPUT_SHAPES[shape[0]] = specs.InputShape(*shape)
        shape = shape[0]
    cfg = get_config(arch)
    kw = dict(n_layers=len(cfg.block_pattern()))
    if cfg.encoder_layers:
        kw["encoder_layers"] = 1
    cfg = dataclasses.replace(cfg, **kw, **(cfg_kw or {}))
    lowered, compiled, info = JD.lower_combo(
        arch, shape, multi_pod=mesh == "2x16x16", cfg_override=cfg,
        overrides=overrides)
    rec = JD.analyse(lowered, compiled, info, cfg)
    batched, other = dot_flops(compiled.as_text())
    return {"hlo_flops": rec["hlo_flops"], "batched_dot_flops": batched,
            "other_dot_flops": other}


def port_record(port_dir: str, arch: str, shape: str, mesh: str,
                attn_chunk=None):
    name = f"{arch}__{shape}__{mesh}"
    if attn_chunk:
        name += f"__attn_chunk{attn_chunk}"
    path = os.path.join(port_dir, name + "__blocks1.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    return rec if rec.get("status") == "ok" else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default="train_4k")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--port", default=None,
                    help="directory of the port's one-block records")
    args = ap.parse_args(argv)
    over = {"attn_chunk": args.attn_chunk} if args.attn_chunk else None
    head = ("| arch | shape | mesh | JAX hlo_flops | JAX batched dots | "
            "JAX other dots | JAX hlo_flops / 16x16's |")
    if args.port:
        head += (" port flops | port batched | port other | batched port / "
                 "JAX | other port / JAX | port flops / 16x16's | port "
                 "ratio / JAX ratio |")
    print(head)
    print("| --- " * (head.count("|") - 1) + "|")
    for shape in args.shapes.split(","):
        for arch in args.archs.split(","):
            first = {}
            for mesh in MESHES:
                t0 = time.perf_counter()
                j = compile_record(arch, shape, mesh=mesh, overrides=over)
                print(f"[jax] {arch} {shape} {mesh}: "
                      f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
                      flush=True)
                jr = j["hlo_flops"] / first.setdefault("jax", j["hlo_flops"])
                row = (f"| {arch} | {shape} | {mesh} | {j['hlo_flops']:.4e} "
                       f"| {j['batched_dot_flops']:.4e} | "
                       f"{j['other_dot_flops']:.4e} | {jr:.3f} |")
                p = args.port and port_record(args.port, arch, shape, mesh,
                                              args.attn_chunk)
                if p:
                    f = p["counted_flops_per_rank"]
                    fb = p["counted_batched_flops_per_rank"]
                    pr = f / first.setdefault("port", f)
                    rb = (f"{fb / j['batched_dot_flops']:.3f}"
                          if j["batched_dot_flops"] else "-")
                    row += (f" {f:.4e} | {fb:.4e} | {f - fb:.4e} | {rb} | "
                            f"{(f - fb) / j['other_dot_flops']:.3f} | "
                            f"{pr:.3f} | {pr / jr:.3f} |")
                elif args.port:
                    first["port"] = float("nan")
                    row += " - | - | - | - | - | - | - |"
                print(row, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
