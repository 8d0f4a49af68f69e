"""Post-SPMD HLO analysis: collective inventory + byte accounting.

``compiled.as_text()`` is the per-device program after the SPMD partitioner
inserted collectives.  We sum operand bytes of every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute.

Loop-body accounting: the layer stack is a ``lax.scan`` → a ``while`` op whose
body is a separate HLO computation; a collective inside it executes
``n_blocks`` times but appears once in the text.  ``loop_multiplier`` is
applied to collectives found in computations whose name marks them as while
bodies.  (The only loops containing collectives in our models are the block
scans — the flash-attention q-chunk scan is shard-local by construction.)

Operand-byte convention per op kind (result bytes R, group size g):
  all-reduce          operand = R
  all-gather          operand = R / g          (each rank contributes a slice)
  reduce-scatter      operand = R * g
  all-to-all          operand = R
  collective-permute  operand = R
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")

_OP_RE = re.compile(
    r"=\s*(?:\(|)([a-z0-9]+)\[([\d,]*)\][^=]*?\s("
    + "|".join(_KINDS) + r")(?:-start)?\(")
_TUPLE_OP_RE = re.compile(
    r"=\s*\(\s*([a-z0-9]+)\[([\d,]*)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_COMP_RE = re.compile(r"^(%?[\w.\-]+)\s*(?:\([^)]*\))?\s*->.*\{|^ENTRY")


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    computation: str
    result_bytes: int
    group_size: int
    operand_bytes: int
    multiplier: int


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def parse_collectives(hlo_text: str,
                      loop_multiplier: int = 1) -> List[CollectiveOp]:
    ops: List[CollectiveOp] = []
    comp = "ENTRY"
    for line in hlo_text.splitlines():
        ls = line.strip()
        if ls.endswith("{") and ("->" in ls or ls.startswith("ENTRY")):
            m = re.match(r"%?([\w.\-]+)", ls.replace("ENTRY ", ""))
            comp = m.group(1) if m else ls[:40]
            continue
        m = _OP_RE.search(line)
        if not m:
            continue
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        rb = _shape_bytes(dtype, dims)
        # async tuple results: take the payload element shape
        if "(" in line.split("=", 1)[1][:4]:
            tm = _TUPLE_OP_RE.search(line)
            if tm:
                rb = _shape_bytes(tm.group(1), tm.group(2))
        g = 1
        gm = _GROUPS_LIST_RE.search(line)
        if gm:
            g = len([x for x in gm.group(1).split(",") if x.strip() != ""])
        else:
            gm = _GROUPS_IOTA_RE.search(line)
            if gm:
                g = int(gm.group(2))
        if kind == "all-gather":
            ob = rb // max(g, 1)
        elif kind == "reduce-scatter":
            ob = rb * g
        else:
            ob = rb
        is_loop_body = ("while" in comp) or ("body" in comp) or ("cond" in comp)
        mult = loop_multiplier if (is_loop_body and "cond" not in comp) else 1
        ops.append(CollectiveOp(kind, comp, rb, g, ob, mult))
    return ops


def summarize(ops: List[CollectiveOp]) -> Dict:
    total = 0
    by_kind: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    for op in ops:
        b = op.operand_bytes * op.multiplier
        total += b
        by_kind[op.kind] = by_kind.get(op.kind, 0) + b
        counts[op.kind] = counts.get(op.kind, 0) + op.multiplier
    return {"total_operand_bytes": int(total),
            "bytes_by_kind": {k: int(v) for k, v in by_kind.items()},
            "op_counts": counts,
            "n_sites": len(ops)}
