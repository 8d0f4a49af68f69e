"""Which DTensor ops of a dry-run step split their FLOPs unevenly.

    PYTHONPATH=src python3 tools/dryrun_ops.py --device cpu \\
        llama4-scout-17b-a16e:train_4k [ARCH:SHAPE ...] [--blocks 1] \\
        [--multi-pod] [--top 14]

Each combo's step runs once on the fake production mesh, as
``repro_torch.launch.dryrun`` runs it, under a ``StepCounter`` that also
charges every local op's FLOPs to the DTensor op that issued it.  Printed
per combo: rank 0's and the global counted FLOPs and their ratio, then the
DTensor ops with the most FLOPs on rank 0 — each op's global shapes and
input placements, the ratio global / rank 0 (the mesh's size where the op
splits evenly) and the model lines that called it (none in a backward).
``--peak N`` also prints ``counted_peak_bytes_per_rank`` and the N
largest groups of the storages held at that peak, by the DTensor op and
model lines that made them.
"""
from __future__ import annotations

import argparse
import collections
import sys
import traceback
import warnings
import weakref

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.core.trees import tree_leaves
from repro_torch.launch import dryrun as D


def _lines():
    """The last three model lines of the stack (none in a backward)."""
    return [f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
            for f in traceback.extract_stack()
            if "repro_torch/models" in f.filename][-3:]


class OpCounter(D.StepCounter):
    """A ``StepCounter`` whose ``rows`` map each DTensor op (name, global
    shapes and placements of its inputs) to [global FLOPs, rank 0's FLOPs,
    calls, the model lines of its first call]."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.rows = collections.defaultdict(lambda: [0, 0, 0, None])
        self._current = None
        self._made_by = {}          # id(storage) -> (bytes, op, lines, ref)
        self.at_peak = []

    def _hold(self, st, n):
        super()._hold(st, n)
        op = self._current[0] if self._current else "-"
        self._made_by[id(st)] = (n, op, tuple(_lines()), weakref.ref(st))

    def _made(self, out):
        before = self.peak_bytes
        super()._made(out)
        if self.peak_bytes > before:
            # the bytes a storage holds now (a collective's hands its on)
            held = ((self._storages.get(ref(), (0,))[0], op, where)
                    for _, op, where, ref in self._made_by.values()
                    if ref() is not None)
            self.at_peak = [h for h in held if h[0]]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self._current = (str(func), tuple(
                (tuple(a.shape), str(a.placements)) for a in args
                if isinstance(a, DTensor)))
            row = self.rows[self._current]
            before = self.flops_global
            out = super().__torch_dispatch__(func, types, args, kwargs)
            row[0] += self.flops_global - before
            row[2] += 1
            if row[3] is None:
                row[3] = _lines()
            return out
        # DTensor runs an op's local ops after the mode has seen the op
        before = self.flops_local
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self._current is not None:
            self.rows[self._current][1] += self.flops_local - before
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("combos", nargs="+", help="ARCH:SHAPE")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--peak", type=int, default=0,
                    help="groups of the storages held at the peak to print")
    args = ap.parse_args(argv)
    warnings.filterwarnings("ignore")
    D.fake_world(512 if args.multi_pod else 256)
    for combo in args.combos:
        arch, shape = combo.split(":")
        cfg = D.cut_depth(get_config(arch), args.blocks)
        fn, step_args, _ = D.lower_combo(arch, shape, cfg_override=cfg,
                                         multi_pod=args.multi_pod,
                                         device=args.device)
        counter = OpCounter(tree_leaves(step_args[0])[0].device_mesh)
        counter.exclude(step_args)
        with implicit_replication(), counter:
            fn(*step_args)
        print(f"== {arch} {shape} blocks {args.blocks}: rank 0 "
              f"{counter.flops_local:.4e} global {counter.flops_global:.4e}"
              f" ratio {counter.flops_global / counter.flops_local:.2f}")
        rows = sorted(counter.rows.items(), key=lambda kv: -kv[1][1])
        for key, (glob, local, calls, where) in rows[:args.top]:
            if local:
                print(f"  rank 0 {local:.3e} global {glob:.3e} ratio "
                      f"{glob / local:7.1f} x{calls} {key} {where}")
        if args.peak:
            print(f"  peak {counter.peak_bytes} bytes a rank, held by:")
            groups = collections.defaultdict(lambda: [0, 0])
            for n, op, where in counter.at_peak:
                groups[op, where][0] += n
                groups[op, where][1] += 1
            for (op, where), (n, k) in sorted(
                    groups.items(), key=lambda kv: -kv[1][0])[:args.peak]:
                print(f"    {n} bytes in {k} storage(s): {op} {list(where)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
