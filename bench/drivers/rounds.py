"""``MFLExperiment.run_round()`` back to back: a researcher running one
experiment round by round.

Set-up runs the cell's first rounds through the same call (capturing the
round's graphs on a card); the check follows those rounds from the seed,
round 0 from the reference's start and each later one from the program's
state after the round before."""
from __future__ import annotations

from typing import Dict

import numpy as np

from bench.harness import check as ck
from bench.harness import counts
from bench.harness import drivers
from bench.reference import fl as ref_fl


class Driver(drivers.Driver):

    def setup(self):
        exp = self.build()
        self.trace_period = int(self.cell.traffic["eval_every"])
        self.first = []
        for _ in range(int(self.cell.check["check"]["rounds"])):
            self.first.append(self._snapshot(exp.run_round()))

    def _snapshot(self, rec) -> dict:
        exp, K = self.exp, self.exp.params.K
        a = np.zeros(K, bool)
        a[list(rec.participants) + list(rec.failures)] = True
        ok = np.zeros(K, bool)
        ok[list(rec.participants)] = True
        return {"params": exp.global_params, "Q": exp.queues.Q.copy(),
                "spent": exp.queues.spent.copy(),
                "zeta": np.array([exp.bound.zeta[m] for m in self.mods]),
                "delta": np.stack([exp.bound.delta[m] for m in self.mods]),
                "a": a, "ok": ok, "metrics": dict(rec.metrics)}

    def call(self) -> int:
        rec = self.exp.run_round()
        self.calls.append({"ok": rec.participants,
                           "evaluated": bool(rec.metrics)})
        return 1

    def call_flops(self, c) -> float:
        ok = np.zeros(self.exp.params.K, bool)
        ok[list(c["ok"])] = True
        return counts.round_flops(self.cell.config, self.exp.data_sizes,
                                  self.upload(ok), len(self.exp.test_ds),
                                  c["evaluated"])

    def check(self) -> Dict[str, float]:
        exp, cfg, t = self.exp, self.cell.config, self.cell.traffic
        ref = ref_fl.Experiment(cfg, t, self.seed, self.device)
        nums = {"inputs": ck.input_mismatches(exp, ref)}
        xs = ref.draw_rounds(len(self.first))
        ee = int(t["eval_every"])
        rows = []
        st = ref.state()
        for i, snap in enumerate(self.first):
            if i:
                # step by step from the program's state after the round
                # before (the start, round 0, is the reference's own)
                st = state_of(self.first[i - 1], i)
            row = {"schedule": ref.judge_schedule(st, xs[i], t["V"],
                                                  snap["a"])}
            nst = ref.round(st, xs[i], snap["a"], t["V"], i % ee == 0)
            row["status"] = int((nst["ok"] != snap["ok"]).sum())
            row["update"], row["update_median"] = ck.update_gaps(
                ck.delta_tree(snap["params"], st["params"]),
                ck.delta_tree(nst["params"], st["params"]))
            row["trackers"] = ck.tracker_gap(snap["zeta"], nst["zeta"],
                                             snap["delta"], nst["delta"],
                                             ref.has)
            row["energy"] = ck.energy_gap(snap["Q"], nst["Q"],
                                          snap["spent"], nst["spent"])
            if nst["metrics"]:
                row["eval_loss"] = (ck.rel_gap(snap["metrics"]["loss"],
                                               nst["metrics"]["loss"])
                                    if snap["metrics"] else float("inf"))
            rows.append(row)
        nums.update(ck.summarize_rows(rows))
        return nums

    def use_control(self):
        """The reference at TF32 in the program's place: the cell's first
        rounds under the program's schedules, as the program's
        snapshots."""
        t = self.cell.traffic
        ref = ref_fl.Experiment(self.cell.config, t, self.seed, self.device)
        xs = ref.draw_rounds(len(self.first))
        st, out = ref.state(), []
        for i, snap in enumerate(self.first):
            st = ref.round(st, xs[i], snap["a"], t["V"],
                           i % int(t["eval_every"]) == 0, tf32=True)
            out.append({k: st[k] for k in ("params", "Q", "spent", "zeta",
                                           "delta", "a", "ok", "metrics")})
        self.first = out


def state_of(snap: dict, round_: int) -> dict:
    """A program snapshot as the reference's round state."""
    return {"params": snap["params"], "Q": snap["Q"].copy(),
            "spent": snap["spent"].copy(), "zeta": snap["zeta"].copy(),
            "delta": snap["delta"].copy(), "warm_a": snap["a"].copy(),
            "round": round_}
