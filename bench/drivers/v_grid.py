"""``FusedRoundEngine.scan_v_grid`` over the mix's V values, R rounds each,
every call from the same fresh carry and the same drawn rounds: the
paper's Fig. 4 study as one call.

Set-up captures the round's graphs with a one-row, two-round grid (an eval
round and a plain one); the check follows rows of the window's last sweep,
drawn from the seed, each from the reference's start."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench.harness import check as ck
from bench.harness import counts
from bench.harness import drivers
from bench.reference import fl as ref_fl


def _head(xs, n: int):
    """The first ``n`` rounds of a stacked ``RoundXs``."""
    return type(xs)(*[{k: v[:n] for k, v in f.items()}
                      if isinstance(f, dict) else f[:n] for f in xs])


def _take(x, s: int):
    if isinstance(x, dict):
        return {k: _take(v, s) for k, v in x.items()}
    return x[s]


class Driver(drivers.Driver):

    def setup(self):
        from repro_torch.fl.fused_round import FusedRoundEngine, draw_round_xs
        t = self.cell.traffic
        exp = self.build()
        self.V = np.asarray(t["V_grid"], np.float32)
        self.R = int(t["rounds"])
        self.eng = FusedRoundEngine(exp)
        self.carry0 = self.eng.init_carry()
        self.xs = draw_round_xs(exp, self.R,
                                include_final=bool(t["include_final"]))
        self.eng.scan_v_grid(self.V[:1], self.carry0, _head(self.xs, 2))
        if self.device != "cpu":
            torch.cuda.synchronize()

    def call(self) -> int:
        carries, auxs = self.eng.scan_v_grid(self.V, self.carry0, self.xs)
        host = {"a": auxs.a.cpu().numpy(), "ok": auxs.ok.cpu().numpy(),
                "energy_total": auxs.energy_total.cpu().numpy(),
                "eval_mask": auxs.eval_mask.cpu().numpy(),
                "loss": auxs.metrics["loss"].cpu().numpy()}
        self.last = (carries, host)
        self.calls.append({"ok": host["ok"], "eval": host["eval_mask"]})
        return int(self.V.size * self.R)

    def checked_call(self):
        self.call()

    def program_row(self, s: int) -> dict:
        """Row ``s`` of the window's last sweep: its rounds' schedules,
        participants, energy and eval loss, and its final state."""
        carries, host = self.last
        return {"a": host["a"][s], "ok": host["ok"][s],
                "energy_total": host["energy_total"][s],
                "loss": host["loss"][s],
                "params": _take(carries.params, s),
                "zeta": carries.zeta[s].cpu().numpy(),
                "delta": carries.delta[s].cpu().numpy(),
                "Q": carries.Q[s].cpu().numpy(),
                "spent": carries.spent[s].cpu().numpy()}

    def call_flops(self, c) -> float:
        total = 0.0
        S, R = c["ok"].shape[:2]
        for s in range(S):
            for r in range(R):
                total += counts.round_flops(
                    self.cell.config, self.exp.data_sizes,
                    self.upload(c["ok"][s, r]), len(self.exp.test_ds),
                    bool(c["eval"][s, r]))
        return total

    def check(self) -> Dict[str, float]:
        exp, cfg, t = self.exp, self.cell.config, self.cell.traffic
        chk = self.cell.check["check"]
        rng = np.random.default_rng(self.seed)
        S = self.V.size
        rows = sorted(rng.choice(S, int(chk["rows"]), replace=False))
        judged = sorted(rng.choice(self.R, int(chk["judged_rounds"]),
                                   replace=False))
        ref = ref_fl.Experiment(cfg, t, self.seed, self.device)
        nums = {"inputs": ck.input_mismatches(exp, ref)}
        xs = ref.draw_rounds(self.R)
        flags = self.xs.eval_flag.cpu().numpy()
        found = []
        for s in rows:
            V = float(self.V[s])
            prog = self.program_row(s)
            st = ref.state()
            p0 = st["params"]
            for r in range(self.R):
                row = {}
                a = prog["a"][r]
                if r in judged:
                    row["schedule"] = ref.judge_schedule(st, xs[r], V, a)
                st = ref.round(st, xs[r], a, V, bool(flags[r]))
                row["status"] = int((st["ok"] != prog["ok"][r]).sum())
                row["energy"] = ck.total_gap(prog["energy_total"][r],
                                             st["spent"].sum())
                if st["metrics"]:
                    row["eval_loss"] = ck.rel_gap(prog["loss"][r],
                                                  st["metrics"]["loss"])
                found.append(row)
            worst, median = ck.update_gaps(
                ck.delta_tree(prog["params"], self.carry0.params),
                ck.delta_tree(st["params"], p0))
            found.append({
                "update": worst, "update_median": median,
                "trackers": ck.tracker_gap(prog["zeta"], st["zeta"],
                                           prog["delta"], st["delta"],
                                           ref.has),
                "energy": ck.energy_gap(prog["Q"], st["Q"], prog["spent"],
                                        st["spent"])})
        nums.update(ck.summarize_rows(found))
        return nums

    def use_control(self):
        """The reference at TF32 in the program's place: each checked row
        of the sweep computed by the reference under the program's
        schedules, in ``program_row``'s form."""
        program_row = self.program_row

        def control_row(s: int) -> dict:
            prog = program_row(s)
            ref = ref_fl.Experiment(self.cell.config, self.cell.traffic,
                                    self.seed, self.device)
            xs = ref.draw_rounds(self.R)
            flags = self.xs.eval_flag.cpu().numpy()
            st, ok, energy, loss = ref.state(), [], [], []
            for r in range(self.R):
                st = ref.round(st, xs[r], prog["a"][r], float(self.V[s]),
                               bool(flags[r]), tf32=True)
                ok.append(st["ok"])
                energy.append(st["spent"].sum())
                loss.append(st["metrics"].get("loss", np.nan))
            return {"a": prog["a"], "ok": np.array(ok),
                    "energy_total": np.array(energy),
                    "loss": np.array(loss), "params": st["params"],
                    "zeta": st["zeta"], "delta": st["delta"], "Q": st["Q"],
                    "spent": st["spent"]}
        self.program_row = control_row
