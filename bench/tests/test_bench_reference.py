"""The reference's judge of a JCSBA schedule: the schedules its two
searches find read 0, a worse feasible schedule reads its gap, an
infeasible one reads inf, and at a state where the program's float32
search walked to another optimum than float64 does, the float32-rounded
search ends where the program did."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench.harness import spec
from bench.reference import fl as ref_fl
from bench.reference import judge, solver_ref

DATA = Path(__file__).parent / "data"


def _state(name: str):
    doc = json.loads((DATA / name).read_text())
    data = {k: v if isinstance(v, float) else
            np.asarray(v["values"], np.float64).reshape(v["shape"])
            for k, v in doc["data"].items()}
    bits = {k: np.array([c == "1" for c in v["ones"]]).reshape(v["shape"])
            for k, v in doc["bits"].items()}
    data["has"] = bits["has"]
    draws = (bits["init"], bits["mut"], bits["fresh"])
    return data, bits["seeds"], draws, np.asarray(doc["prog_a"], bool)


@pytest.mark.parametrize("queues", [0.0, 5e-3])
def test_the_searches_own_schedules_read_zero(queues):
    cell = spec.load_cell("iemocap.v_grid")
    traffic = json.loads(json.dumps(cell.traffic))
    traffic.update(K=6, n_samples=120)
    ref = ref_fl.Experiment(cell.config, traffic, 2 ** 31 + 99)
    st = ref.state()
    st["Q"] = np.full(ref.K, queues)          # > 0: the κ/φ⁻¹ branch
    xs = ref.draw_rounds(1)[0]
    data = ref.solver_data(st, xs["h"], 1.0)
    seeds = np.stack([np.zeros(ref.K, bool), np.zeros(ref.K, bool)])
    found = judge.searches(data, seeds, xs["draws"], ref.hp)
    a, J_best, _ = solver_ref.solve_round_np(data, seeds, xs["draws"],
                                             ref.hp)
    assert np.array_equal(found[0], a)
    for row in found:
        assert judge.schedule_gap(data, seeds, xs["draws"], ref.hp,
                                  row) == 0.0
    J = judge.objectives(data, ref.hp, np.zeros((1, ref.K), bool))[0]
    worst = np.zeros(ref.K, bool)             # nobody: feasible, J₂(∅)
    assert judge.schedule_gap(data, seeds, xs["draws"], ref.hp, worst) == \
        pytest.approx((J - J_best) / abs(J))


def test_a_schedule_past_the_budget_reads_inf():
    data, seeds, draws, _ = _state("crema_d.7447483701.round2.json")
    hp = solver_ref.SolverHyper()
    everyone = np.ones(len(data["Q"]), bool)
    assert not np.isfinite(judge.objectives(data, hp, everyone)[0])
    assert judge.schedule_gap(data, seeds, draws, hp, everyone) == \
        float("inf")


def test_float32_rounding_walks_to_the_programs_schedule():
    """The card's schedule at this state is 0.0366·|J₂(∅)| worse than the
    float64 search's, and exactly the float32-rounded search's."""
    data, seeds, draws, prog_a = _state("crema_d.7447483701.round2.json")
    hp = solver_ref.SolverHyper()
    f64, f32 = judge.searches(data, seeds, draws, hp)
    assert np.array_equal(f32, prog_a) and not np.array_equal(f64, prog_a)
    J = judge.objectives(data, hp, np.stack([np.zeros_like(f64), f64,
                                             prog_a]))
    assert (J[2] - J[1]) / abs(J[0]) == pytest.approx(0.036626, abs=1e-6)
    assert judge.schedule_gap(data, seeds, draws, hp, prog_a) == 0.0
