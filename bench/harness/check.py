"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``bench/reference``).

Every number is a gap that reads 0 for a perfect match; each has a limit
in the cell's file (``bench/workloads/<cell>.json``), set from readings
of sound runs and of the control (``bench/calibrate.py``).

* ``inputs`` — data, partition, costs and initial weights that the program
  derived from the seed and the reference derived again, items that differ
  (exact: limit 0);
* ``status`` — clients whose participation (scheduled and on time) differs
  from the reference's under the same schedule and bandwidth rule (exact);
* ``schedule`` — how much worse each judged schedule's objective J₂ is
  than the reference's own JCSBA search on the same state and random bits,
  over |J₂| of the empty schedule;
* ``update`` — the parameters' change, by the worst leaf: the gap between
  the program's and the reference's change norms over the reference's
  norm of that leaf or of the median leaf, whichever is larger;
* ``update_median`` — the same gap of the median leaf: steady where one
  ReLU whose input lies within rounding of 0 in one sample turns the
  other way in float32 than in the reference, which moves every leaf
  below it by a few percent (the CNN's first layers; ``PERF.md``);
* ``trackers`` — ζ_m (the aggregated gradient's norm) and δ_{k,m} (each
  client's divergence), worst relative gap (δ against the larger of its
  own and the median owner's);
* ``energy`` — the virtual queues and the energy spent, worst client, over
  the larger of its spent energy and the clients' mean;
* ``eval_loss`` — the held-out fused cross-entropy, worst eval round,
  relative.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Mapping

import numpy as np
import torch

NUMBERS = ("inputs", "status", "schedule", "update", "update_median",
           "trackers", "energy", "eval_loss")


def _norms(named: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in named.items()}


def update_gaps(prog_delta: Mapping, ref_delta: Mapping):
    """(worst leaf, median leaf) of |‖Δ_p‖ − ‖Δ_r‖| over max(‖Δ_r‖,
    median moving leaf's ‖Δ_r‖).  Under batch gradient descent a leaf
    whose gradient is nought moves by nothing on either side, so every
    leaf counts (one the reference leaves still and the program moves
    reads its own norm over the median)."""
    pn, rn = _norms(prog_delta), _norms(ref_delta)
    moving = [v for v in rn.values() if v > 0]
    if not moving:
        gap = 0.0 if not any(pn.values()) else float("inf")
        return gap, gap
    med = statistics.median(moving)
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med) for k in rn]
    return max(gaps), statistics.median(gaps)


def tracker_gap(zeta_p, zeta_r, delta_p, delta_r, has) -> float:
    zeta_p, zeta_r = np.asarray(zeta_p, float), np.asarray(zeta_r, float)
    gz = np.max(np.abs(zeta_p - zeta_r) / zeta_r)
    own = np.asarray(has, bool)
    dp, dr = np.asarray(delta_p, float)[own], np.asarray(delta_r, float)[own]
    gd = _scaled(np.abs(dp - dr), np.maximum(dr, np.median(dr)))
    return float(max(gz, gd))


def _scaled(diff, scale) -> float:
    """max(diff / scale), where a zero scale reads 0 for a zero diff (a
    lone uploader's divergence is 0 on both sides) and +inf otherwise."""
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0),
                     np.where(diff == 0, 0.0, np.inf))
    return float(q.max()) if q.size else 0.0


def energy_gap(Q_p, Q_r, spent_p, spent_r) -> float:
    spent_r = np.asarray(spent_r, float)
    mean = spent_r.mean()
    diff = np.maximum(np.abs(np.asarray(Q_p, float) - np.asarray(Q_r, float)),
                      np.abs(np.asarray(spent_p, float) - spent_r))
    if mean <= 0:
        return 0.0 if not diff.any() else float("inf")
    return float(np.max(diff / np.maximum(spent_r, mean)))


def rel_gap(p, r) -> float:
    return abs(float(p) - float(r)) / abs(float(r))


def total_gap(p, r) -> float:
    """``rel_gap`` of a total that may be 0 on both sides."""
    if float(r) == 0.0:
        return 0.0 if float(p) == 0.0 else float("inf")
    return rel_gap(p, r)


def input_mismatches(exp, ref) -> int:
    """Items the program and the reference derived differently from the
    seed: held-out and client data, modalities, costs, initial weights."""
    bad = 0
    for m in ref.mods:
        bad += not np.array_equal(exp.test_ds.features[m],
                                  ref.test.features[m])
        bad += not np.array_equal(exp.train_ds.features[m],
                                  ref.train.features[m])
    bad += not np.array_equal(exp.test_ds.labels, ref.test.labels)
    for c_p, c_r in zip(exp.clients, ref.clients):
        bad += tuple(c_p.modalities) != tuple(c_r.modalities)
        bad += not np.array_equal(c_p.dataset.labels, c_r.dataset.labels)
        for m in c_r.modalities:
            bad += not np.array_equal(c_p.dataset.features[m],
                                      c_r.dataset.features[m])
    bad += len(exp.clients) != len(ref.clients)
    for f in ("gamma_bits", "tau_cmp", "e_cmp"):
        bad += not np.array_equal(getattr(exp.cost, f), getattr(ref.cost, f))
    from ..reference.fl import named_leaves
    p0 = named_leaves(exp.init_params)
    r0 = named_leaves(ref.init_params)
    bad += sorted(p0) != sorted(r0)
    for k in r0:
        if k in p0:
            bad += not torch.equal(p0[k].detach().cpu(), r0[k])
    return int(bad)


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]):
    """(correct, [(name, value, limit)]) — a number passes when it is at
    most its limit; a number without a limit, or NaN, fails."""
    rows, ok = [], True
    for name in NUMBERS:
        if name not in numbers:
            continue
        v = float(numbers[name])
        lim = limits.get(name)
        passed = lim is not None and v == v and v <= float(lim)
        ok &= passed
        rows.append((name, v, None if lim is None else float(lim)))
    return ok, rows


def delta_tree(after, before) -> Dict[str, torch.Tensor]:
    from ..reference.fl import named_leaves
    a, b = named_leaves(after), named_leaves(before)
    return {k: a[k].detach().double().cpu() - b[k].detach().double().cpu()
            for k in a}


def summarize_rows(per_round: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for row in per_round:
        for k, v in row.items():
            out[k] = max(out.get(k, 0.0), float(v))
    return out
