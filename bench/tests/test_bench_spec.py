"""The harness finds a cell, a traffic mix, its driver, a configuration
and a per-layer metric by their names in BENCHMARK.json, as files of their
own: a later change adds them without editing a file that is there."""
import json
import shutil
from pathlib import Path

from bench.harness import drivers, spec

BENCH = Path(spec.BENCH_DIR)


def _copy_layout(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "bench"
    for sub in ("configs", "traffic", "workloads", "metrics", "drivers"):
        shutil.copytree(BENCH / sub, bench / sub)
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, bench


def test_every_named_cell_loads():
    doc = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in doc["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert issubclass(spec.driver_class(cell.traffic["driver"]),
                          drivers.Driver)
        assert set(cell.check["limits"]) >= {"inputs", "status", "update"}
        assert any(m.name == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m.name))


def test_new_cell_mix_and_metric_are_files_of_their_own(tmp_path):
    root, bench = _copy_layout(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json"}
    # a new driver, a new mix on it, a new cell on that and a new
    # per-layer metric, as new files
    (bench / "drivers" / "replays.py").write_text(
        "from bench.harness import drivers\n\n\n"
        "class Driver(drivers.Driver):\n"
        "    def call(self):\n"
        "        return 7\n")
    mix = json.loads((bench / "traffic" / "k10.rounds.json").read_text())
    mix.update(K=20, driver="replays", why="twenty clients")
    (bench / "traffic" / "k20.rounds.json").write_text(json.dumps(mix))
    (bench / "workloads" / "iemocap.k20.rounds.json").write_text(
        (bench / "workloads" / "iemocap.k10.rounds.json").read_text())
    (bench / "metrics" / "replays_per_s.py").write_text(
        "def read(run):\n    return 42.0\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "iemocap.k20.rounds",
                             "config": "iemocap", "traffic": "k20.rounds",
                             "chips": 1, "why": "twenty clients"})
    doc["per_layer"].append({"name": "replays_per_s", "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "round graph (fl/fused_round.py)",
                             "moves": "scenario_rounds_per_s",
                             "workloads": ["iemocap.k20.rounds"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = spec.load_cell("iemocap.k20.rounds", root=root, bench_dir=bench)
    assert cell.traffic["K"] == 20 and cell.config["dataset"] == "iemocap"
    drv = spec.driver_class(cell.traffic["driver"], bench)(cell, 1, "cpu")
    assert isinstance(drv, drivers.Driver) and drv.call() == 7
    names = [m.name for m in cell.per_layer]
    assert "replays_per_s" in names
    assert spec.readers(cell.per_layer, bench)["replays_per_s"](None) == 42
    # the new metric is not reported in the cells it does not list
    old = spec.load_cell("iemocap.k10.rounds", root=root, bench_dir=bench)
    assert "replays_per_s" not in [m.name for m in old.per_layer]
    # and no file that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


def test_end_to_end_metric_restricted_to_its_cells():
    sweep = spec.load_cell("iemocap.v_grid")
    rounds = spec.load_cell("crema_d.k10.rounds")
    assert "round_ms_p95" not in [m.name for m in sweep.end_to_end]
    assert "round_ms_p95" in [m.name for m in rounds.end_to_end]
