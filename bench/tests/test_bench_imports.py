"""The import rule: nothing a run loads is JAX or the JAX package
(compared by whole top-level names: ``repro_torch`` is the program, not
``repro``), and the reference loads nothing of the program either."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _modules_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        env=env, cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _modules_after(
        "import bench.run\n"
        "from bench.harness import drivers, runner, spec, trace\n"
        "from bench.harness import check, counts, peaks\n"
        "from repro_torch.fl import runtime, fused_round\n"
        "from repro_torch.kernels.fusion_loss import ops\n"
        "import bench.calibrate\n"
        "for n in ('device_idle_share', 'device_ops_per_round', "
        "'mfu.round', 'fusion_loss_roofline'):\n"
        "    spec.metric_reader(n)\n"
        "for n in ('rounds', 'v_grid'):\n"
        "    spec.driver_class(n)\n")
    assert "repro_torch" in mods and "bench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "from bench.reference import fl, judge, models, partition\n"
        "from bench.reference import solver_ref, synthetic\n")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_harness_guard_names_what_it_finds():
    from bench.harness import runner
    assert "repro" in runner.FORBIDDEN and "repro_torch" not in \
        runner.FORBIDDEN
    sys.modules.setdefault("repro_fake_probe", None)
    assert "repro_fake_probe" not in runner.forbidden_modules()
