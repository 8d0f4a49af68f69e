"""The check against the reference, on the CPU at a small size: a sound
run of the program is correct, and a run with the timed path broken
underneath is not, for each fault a cell can have (its look for a card
skipped; everything else as ``bench/run.py`` runs it)."""
import io
import json
import sys

import pytest
from conftest import tiny

from bench import calibrate
from bench.harness import runner, spec

CELLS = ("crema_d.k10.rounds", "iemocap.k10.rounds", "iemocap.v_grid")
SEED = 2 ** 31 + 12345          # beyond 32 signed bits, as a seed may be


def _run(name, fault=None, seed=SEED):
    cell = tiny(spec.load_cell(name))
    out, err = io.StringIO(), io.StringIO()
    with calibrate.planted(fault or "sound"):
        res = runner.run_cell(cell, seed, 0.05, False, device="cpu",
                              out=out, err=err)
    line = out.getvalue().strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(res))
    return res, err.getvalue()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res, err = _run(name)
    assert res["correct"], res["checks"]
    assert res["checks"]["inputs"]["value"] == 0
    assert res["checks"]["status"]["value"] == 0
    assert list(res)[-1] == "checks"
    # every compared number is printed beside its limit, last on stderr
    tail = err.strip().splitlines()[-len(res["checks"]) - 1:]
    assert [t.split(":")[0] for t in tail[:-1]] == \
        [f"check {k}" for k in res["checks"]]
    assert tail[-1] == "correct: True"
    assert "setup_s" in res["metrics"] and \
        "scenario_rounds_per_s" in res["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, fault):
    res, _ = _run(name, fault)
    assert not res["correct"], (fault, res["checks"])


def test_unchanged_state_reads_one_on_update():
    res, _ = _run("iemocap.k10.rounds", "unchanged")
    assert res["checks"]["update"]["value"] == pytest.approx(1.0)


def test_forbidden_module_refuses_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    with pytest.raises(SystemExit, match="jax"):
        _run("iemocap.k10.rounds")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["crema_d.k10.rounds", "iemocap.k10.rounds",
                                  "iemocap.v_grid"])
def test_control_is_not_correct(cuda, name):
    """The reference computed with TF32 on, put in the program's place at
    the cell's own size, fails the cell's limits."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(name)
    r = calibrate.one(cell, SEED, "control", cuda)
    ok, _ = runner.ck.verdict(r["numbers"], cell.check["limits"])
    assert not ok, r["numbers"]
