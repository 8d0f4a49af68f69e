"""The JAX package's compile beside the port's dry run: per-device FLOPs
at one super-block on the 16×16 and 2×16×16 meshes.

    PYTHONPATH=src python3 tools/dryrun_vs_jax.py [--archs a,b] \\
        [--shapes train_4k,prefill_32k] [--attn-chunk N|one] [--port DIR] \\
        [--ref tests/data/dryrun_jax_dots.json] [--dots]
    PYTHONPATH=src python3 tools/dryrun_vs_jax.py --write \\
        tests/data/dryrun_jax_dots.json \\
        --shapes train_4k,prefill_32k,decode_32k,long_500k
    PYTHONPATH=src python3 tools/dryrun_vs_jax.py --map

Runs ``repro.launch.dryrun.lower_combo`` (the JAX package's own dry run,
on 512 forced host devices of the CPU) for each arch cut to one
super-block as its ``calibrate`` cuts it (``n_layers`` = the super-block's
layers, ``encoder_layers=1`` for an encoder-decoder) and prints, a device
and mesh: XLA's ``hlo_flops``, and the FLOPs of the partitioned program's
dot ops (2 × output elements × contracted size), split into the dots with
a batch dimension (attention's score and value products, the experts'
GEMMs) and the rest (the projections).  ``--attn-chunk N`` (as the
``attn_chunk`` lever) with N the sequence leaves attention no chunk loop,
whose body XLA's counts see once; ``--attn-chunk one`` takes each shape's
sequence (``ONE_CHUNK``; a decode shape has no chunk).  ``--dots``
prints, below each row, every batched dot of the partitioned program and
the ``TOP_OTHER`` other dots with the most FLOPs (the LM head, the
router, the projections): their shapes a device and the collectives that
feed each operand (``dot_report``).

With ``--port DIR`` (the port's records at one super-block, e.g. of
``tools/dryrun_sweep.py --blocks 1 --shape S [--override attn_chunk=N]``
from a card's host) it prints the port's ``counted_flops_per_rank`` and
``counted_batched_flops_per_rank`` beside them and port / JAX of the
batched and of the other FLOPs, and the port's ratio to 16×16 over
XLA's dots' (both count dots only; ``hlo_flops`` also counts elementwise
ops), and the port's ``counted_peak_bytes_per_rank`` beside the compile's
``temp_size_in_bytes`` (two different counts: the port's eager peak of
live storages, XLA's buffer assignment).  ``--ref FILE`` takes the JAX
side from a ``--write`` file instead of compiling.  ``--write FILE``
compiles ``--archs`` × ``--shapes`` × both meshes at one attention chunk
and writes the counts with the JAX version (``write_reference``; the
committed ``tests/data/dryrun_jax_dots.json`` holds the reference's side
of the port's tests, every combo ``specs.supports`` allows).  ``--map``
compiles qwen3-0.6b's train step over a grid of meshes, sequence
lengths, sequences a data shard and KV heads, and prints the table of
XLA's attention split (``attention_map``).  CPU only; imports JAX, not the
port.

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
         "mamba2-370m", "jamba-v0.1-52b", "kimi-k2-1t-a32b")
MESHES = ("16x16", "2x16x16")

_DEF = re.compile(r"%([\w.\-]+) = \w+\[([\d,]*)\]")
_DOT = re.compile(r"%[\w.\-]+ = \w+\[([\d,]*)\]\S* dot\(%([\w.\-]+), "
                  r"%[\w.\-]+\)(.*)")
# one instruction: name, result type (a tuple in parentheses), opcode,
# operands, attributes
_INST = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = (\(.*?\)|\S+) ([\w\-]+)"
                   r"\((.*?)\)(?:, (.*))?$")
_COLLECTIVES = ("all-gather", "all-reduce", "all-to-all", "reduce-scatter",
                "collective-permute")


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


def _groups(attrs: str) -> str:
    """A collective's replica groups, in their short form where it has one
    (``[16,16]<=[256]``), else the first group."""
    got = re.search(r"replica_groups=(\[[^ ]*\]<=\[[^ ]*\](?:T\([\d,]*\))?"
                    r"|\{\{[\d,]*\})", attrs or "")
    if got:
        return got.group(1)
    got = re.search(r"source_target_pairs=\{(\{\d+,\d+\})", attrs or "")
    return "pairs " + got.group(1) if got else "-"


def dot_report(hlo: str, depth: int = 12, batched: bool = True,
               top: int = 0) -> list:
    """Each batched dot of an HLO module's text (a batch dimension of more
    than one element), or with ``batched=False`` each other dot (the
    projections, the LM head, the router): its result and operand shapes,
    its FLOPs, and the collectives that feed each operand — found by
    walking the operand's producers back, through every op but a dot or a
    parameter, ``depth`` steps at most.  ``top``: the ``top`` dots with
    the most FLOPs only (0: all, in the program's order)."""
    insts = {}
    for line in hlo.splitlines():
        m = _INST.match(line)
        if m:
            name, typ, op, operands, attrs = m.groups()
            insts[name] = (typ, op, re.findall(r"%([\w.\-]+)", operands),
                           attrs or "")

    def feeds(name):
        seen, out, todo = set(), [], [(name, 0)]
        while todo:
            n, d = todo.pop()
            if n in seen or n not in insts or d > depth:
                continue
            seen.add(n)
            typ, op, operands, attrs = insts[n]
            if op.replace("-start", "") in _COLLECTIVES:
                out.append(f"{op} {typ.split('{')[0].lstrip('(')} "
                           f"{_groups(attrs)}")
            if op in ("dot", "parameter") and d:
                continue
            todo += [(o, d + 1) for o in operands]
        return out

    rows = []
    for name, (typ, op, operands, attrs) in insts.items():
        if op != "dot":
            continue
        lhs, rhs = (insts[o][0].split("{")[0] for o in operands[:2])
        flops = dot_flops(f"%{name} = {typ} dot(%{operands[0]}, "
                          f"%{operands[1]}), {attrs}\n"
                          f"%{operands[0]} = {lhs}\n")[0 if batched else 1]
        if not flops:
            continue
        rows.append({"dot": name, "out": typ.split("{")[0], "lhs": lhs,
                     "rhs": rhs, "flops": flops,
                     "lhs_feeds": feeds(operands[0]),
                     "rhs_feeds": feeds(operands[1])})
    if top:
        rows = sorted(rows, key=lambda r: -r["flops"])[:top]
    return rows


def compile_record(arch: str, shape, *, mesh="16x16", cfg_kw=None,
                   overrides=None, dots: bool = False) -> dict:
    """The JAX package's compile of ``arch`` cut to one super-block on
    ``mesh`` ("16x16", "2x16x16", or dims of a ("data", "model") mesh of
    the forced host devices): ``hlo_flops``, ``batched_dot_flops``,
    ``other_dot_flops`` and the compile's ``temp_size_in_bytes``
    (``memory_analysis``) a device; None where ``specs.supports``
    refuses the combo.  ``shape`` is an input shape's name or (name,
    seq_len, global_batch, kind); ``cfg_kw`` replaces config fields after
    the cut, ``overrides`` are ``lower_combo``'s levers; ``dots`` adds
    ``dot_report``'s rows: every batched dot (``dots``) and the
    ``TOP_OTHER`` other dots with the most FLOPs (``other_dots``)."""
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
    if info.get("skipped"):
        return None
    rec = JD.analyse(lowered, compiled, info, cfg)
    hlo = compiled.as_text()
    batched, other = dot_flops(hlo)
    out = {"hlo_flops": rec["hlo_flops"], "batched_dot_flops": batched,
           "other_dot_flops": other,
           "temp_size_in_bytes": rec.get("temp_size_in_bytes")}
    if dots:
        out["dots"] = dot_report(hlo)
        out["other_dots"] = dot_report(hlo, batched=False, top=TOP_OTHER)
    return out


# one attention chunk a shape (None: a decode step, no chunk loop), so that
# no count sees a loop body once
ONE_CHUNK = {"train_4k": 4096, "prefill_32k": 32768, "decode_32k": None,
             "long_500k": None}
# the non-batched dots ``--dots`` prints a combo
TOP_OTHER = 6


def _levers(shape: str, attn_chunk=None):
    n = ONE_CHUNK.get(shape) if attn_chunk == "one" else attn_chunk
    return {"attn_chunk": n} if n else None


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


def write_reference(path: str, archs=ARCHS, shapes=tuple(ONE_CHUNK)) -> dict:
    """The JAX compile's dot FLOPs a device (``compile_record``) for
    ``archs`` × ``shapes`` × both meshes at one super-block and one
    attention chunk (``ONE_CHUNK``), written to ``path`` as JSON with the
    JAX version: ``combos[arch][shape][mesh]`` holds ``hlo_flops``,
    ``batched_dot_flops``, ``other_dot_flops`` and
    ``temp_size_in_bytes``.  A combo ``specs.supports`` refuses (long_500k
    for a full-attention arch) has no entry."""
    import jax
    out = {"jax_version": jax.__version__, "blocks": 1,
           "attn_chunk": {s: ONE_CHUNK[s] for s in shapes}, "combos": {}}
    for arch in archs:
        for shape in shapes:
            for mesh in MESHES:
                t0 = time.perf_counter()
                rec = compile_record(arch, shape, mesh=mesh,
                                     overrides=_levers(shape, "one"))
                if rec is not None:
                    out["combos"].setdefault(arch, {}).setdefault(
                        shape, {})[mesh] = rec
                print(f"[jax] {arch} {shape} {mesh}: "
                      f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
                      flush=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


# the mapping of XLA's attention split: qwen3-0.6b at one super-block, a
# train step of (sequences a data shard × data) sequences, attention in
# one chunk, on ("data", "model") meshes of the forced host devices
MAP_MESHES = ((4, 16), (8, 16), (16, 16), (16, 4))
MAP_SEQS = (512, 4096, 32768)
MAP_PER_SHARD = (1, 2, 16)
MAP_KV = (2, 8)


def attention_map():
    """Rows (mesh, B, S, KV heads, the score product's shape a device, the
    step's attention over a device's (its split), a device's attention
    products in units of one forward score product) of XLA's layout of
    qwen3-0.6b's attention (16 query heads of 128)."""
    rows = []
    for dims in MAP_MESHES:
        for S in MAP_SEQS:
            for per in MAP_PER_SHARD:
                for kv in MAP_KV:
                    B = dims[0] * per
                    rec = compile_record(
                        "qwen3-0.6b", ("map", S, B, "train"), mesh=dims,
                        cfg_kw={"n_kv_heads": kv},
                        overrides={"attn_chunk": S}, dots=True)
                    top = max(rec["dots"], key=lambda d: d["flops"])
                    whole = 2 * B * 16 * S * S * 128
                    rows.append((dims, B, S, kv, top["out"],
                                 whole / top["flops"],
                                 rec["batched_dot_flops"] / top["flops"]))
                    print(f"[map] {dims} B={B} S={S} kv={kv}: split "
                          f"{rows[-1][5]:.1f}, {rows[-1][6]:.2f} products",
                          file=sys.stderr, flush=True)
    return rows


def _ratio(num, den):
    return f"{num / den:.3f}" if den else "-"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default="train_4k")
    ap.add_argument("--attn-chunk", default=None,
                    help="an int, or 'one': the shape's sequence")
    ap.add_argument("--port", default=None,
                    help="directory of the port's one-block records")
    ap.add_argument("--ref", default=None,
                    help="take the JAX side from this --write file")
    ap.add_argument("--dots", action="store_true",
                    help="print each batched dot's shapes and feeds, and "
                         "the largest other dots'")
    ap.add_argument("--write", default=None,
                    help="write the reference's counts (one chunk) here")
    ap.add_argument("--map", action="store_true",
                    help="print the table of XLA's attention split")
    args = ap.parse_args(argv)
    archs, shapes = args.archs.split(","), args.shapes.split(",")
    if args.write:
        write_reference(args.write, archs, shapes)
        return 0
    if args.map:
        print("| mesh (data×model) | B | S | KV heads | score product a "
              "device | attention / a device's | products a device |")
        print("| --- " * 7 + "|")
        for dims, B, S, kv, out, split, prods in attention_map():
            print(f"| {dims[0]}×{dims[1]} | {B} | {S} | {kv} | `{out}` | "
                  f"{split:.0f} | {prods:.2f} |")
        return 0
    chunk = args.attn_chunk if args.attn_chunk in (None, "one") \
        else int(args.attn_chunk)
    ref = None
    if args.ref:
        with open(args.ref) as f:
            ref = json.load(f)["combos"]
    head = ("| arch | shape | mesh | JAX hlo_flops | JAX batched dots | "
            "JAX other dots | JAX dots / 16x16's | JAX temp bytes |")
    if args.port:
        head += (" port flops | port batched | port other | batched port / "
                 "JAX | other port / JAX | port flops / 16x16's | port "
                 "ratio / JAX ratio | port peak bytes |")
    print(head)
    print("| --- " * (head.count("|") - 1) + "|")
    for shape in shapes:
        levers = _levers(shape, chunk)
        for arch in archs:
            first = {}
            for mesh in MESHES:
                t0 = time.perf_counter()
                j = (ref.get(arch, {}).get(shape, {}).get(mesh) if ref else
                     compile_record(arch, shape, mesh=mesh, overrides=levers,
                                    dots=args.dots))
                print(f"[jax] {arch} {shape} {mesh}: "
                      f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
                      flush=True)
                if j is None:       # refused by specs.supports
                    continue
                dots = j["batched_dot_flops"] + j["other_dot_flops"]
                jr = dots / first.setdefault("jax", dots)
                row = (f"| {arch} | {shape} | {mesh} | {j['hlo_flops']:.4e} "
                       f"| {j['batched_dot_flops']:.4e} | "
                       f"{j['other_dot_flops']:.4e} | {jr:.3f} | "
                       f"{j.get('temp_size_in_bytes')} |")
                p = args.port and port_record(
                    args.port, arch, shape, mesh,
                    levers and levers["attn_chunk"])
                if p:
                    f = p["counted_flops_per_rank"]
                    fb = p["counted_batched_flops_per_rank"]
                    pr = f / first.setdefault("port", f)
                    row += (f" {f:.4e} | {fb:.4e} | {f - fb:.4e} | "
                            f"{_ratio(fb, j['batched_dot_flops'])} | "
                            f"{_ratio(f - fb, j['other_dot_flops'])} | "
                            f"{pr:.3f} | {pr / jr:.3f} | "
                            f"{p.get('counted_peak_bytes_per_rank')} |")
                elif args.port:
                    first["port"] = float("nan")
                    row += " - | - | - | - | - | - | - | - |"
                print(row, flush=True)
                for what in ("dots", "other_dots"):
                    for d in j.get(what, ()):
                        print(f"    {d['out']} = {d['lhs']} · {d['rhs']}: "
                              f"{d['flops']:.4e}; lhs from "
                              f"{d['lhs_feeds']}, rhs from "
                              f"{d['rhs_feeds']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
