"""The PyTorch port's examples (``examples/torch/*.py``): each twin of an
``examples/*.py`` script runs with ``--device cpu`` at tiny arguments in a
subprocess and exits 0; ``wireless_mfl.py`` writes a JSON with the JAX
example's keys at the same arguments, and, with both packages' experiments
made as the parity tests make them, the JAX example's numbers;
``federated_pods.py``'s aggregation equals the same arithmetic in numpy
and its bound state the JAX package's ``BoundState`` fed the same
deltas."""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_jax_parity import jax_draw_source
from repro.core.aggregation import unified_weights as j_unified_weights
from repro.core.convergence import BoundState as JBound
from repro.fl.client import make_adapter as j_make_adapter
from repro.fl.runtime import MFLExperiment as JExperiment
from repro.fl.runtime import parse_engine as j_parse_engine
from repro_torch.convert import params_from_numpy
from repro_torch.core.aggregation import unified_weights
from repro_torch.core.convergence import BoundState
from repro_torch.core.trees import tree_leaves
from repro_torch.fl.client import make_adapter as t_make_adapter
from repro_torch.fl.runtime import MFLExperiment as TExperiment

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


def _run(script, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                     script), *args],
                       env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


TWINS = {
    "quickstart.py": ["--rounds", "1", "--n-samples", "120"],
    "federated_pods.py": ["--rounds", "1", "--pods", "2", "--batch", "1",
                          "--seq", "32"],
    "serve_batched.py": ["--prompt-len", "8", "--gen-len", "4",
                         "--batch", "2"],
    "serve_continuous.py": ["--rounds", "1", "--steps-per-round", "2",
                            "--K", "4", "--prompt-len", "8"],
}


@pytest.mark.parametrize("script", sorted(TWINS))
def test_twin_runs_on_the_cpu(script):
    out = _run(os.path.join("torch", script), "--device", "cpu",
               *TWINS[script])
    assert out.strip()


def test_twin_raises_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "examples", "torch", "serve_batched.py")], env=env,
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_twins_import_no_jax():
    for name in sorted(os.listdir(os.path.join(ROOT, "examples", "torch"))):
        if name.endswith(".py"):
            with open(os.path.join(ROOT, "examples", "torch", name)) as f:
                text = f.read()
            assert "import jax" not in text and "from repro." not in text \
                and "from repro " not in text, name


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [len(tree)] + ([_keys(tree[0])] if tree else [])
    return type(tree).__name__ if tree is None else "value"


def test_wireless_mfl_json_has_the_jax_example_keys(tmp_path):
    args = ["--rounds", "1", "--n-samples", "120"]
    _run(os.path.join("torch", "wireless_mfl.py"), "--device", "cpu",
         "--out", str(tmp_path / "torch.json"), *args)
    _run("wireless_mfl.py", "--out", str(tmp_path / "jax.json"), *args)
    got = json.loads((tmp_path / "torch.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert _keys(got) == _keys(want)
    assert sorted(got) == ["jcsba", "random"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_wireless_mfl_numbers_match_the_jax_example(tmp_path, monkeypatch):
    """Both examples in this process at the same arguments, each package's
    ``MFLExperiment`` made as ``_torch_jax_parity.pair`` makes it: adapters
    without dropout (whose random bits differ between the packages), the
    port on the JAX experiment's initial params and ``jax.random`` bits.
    Then the twin's JSON holds the JAX example's numbers: each final metric
    but the scheduler's wall time and each curve point, the accuracies and
    the loss at the parity tests' 1e-4, the energy at their 1e-9."""
    args = ["--rounds", "5", "--n-samples", "120"]
    made = []

    def j_factory(dataset, scheduler, engine, **kw):
        j = JExperiment(dataset, scheduler=scheduler, engine=engine, **kw)
        _, _, loss, remat, kernels, _ = j_parse_engine(engine)
        j.adapter = j_make_adapter(dataset, "lstm-cnn", dropout=0.0,
                                   loss_backend=loss, remat=remat,
                                   use_kernels=kernels)
        made.append((scheduler, jax.tree.map(np.asarray, j.global_params),
                     jax.tree.map(np.asarray, j.init_params)))
        return j

    def t_factory(dataset, scheduler, engine, device, **kw):
        name, glob, init = made.pop(0)
        assert name == scheduler
        t = TExperiment(dataset, scheduler=scheduler, engine=engine,
                        device=device,
                        scheduler_kwargs={"draw_source": jax_draw_source},
                        **kw)
        _, _, loss, remat, kernels, _ = j_parse_engine(engine)
        t.adapter = t_make_adapter(dataset, "lstm-cnn", dropout=0.0,
                                   loss_backend=loss, remat=remat,
                                   use_kernels=kernels)
        t.global_params = params_from_numpy(glob, device)
        t.init_params = params_from_numpy(init, device)
        return t

    jmod = _load(os.path.join(ROOT, "examples", "wireless_mfl.py"),
                 "jax_wireless_mfl")
    tmod = _load(os.path.join(ROOT, "examples", "torch", "wireless_mfl.py"),
                 "torch_wireless_mfl")
    monkeypatch.setattr(jmod, "MFLExperiment", j_factory)
    monkeypatch.setattr(tmod, "MFLExperiment", t_factory)
    monkeypatch.setattr(sys, "argv", ["wireless_mfl.py", *args, "--out",
                                      str(tmp_path / "jax.json")])
    jmod.main()
    tmod.main(["--device", "cpu", *args, "--out",
               str(tmp_path / "torch.json")])
    got = json.loads((tmp_path / "torch.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert sorted(got) == sorted(want) == ["jcsba", "random"]
    for algo in want:
        g, w = got[algo], want[algo]
        assert sorted(g["final"]) == sorted(w["final"])
        for key, v in w["final"].items():
            if key == "mean_sched_time_s":
                continue
            tol = 1e-9 if key == "energy_total" else 1e-4
            assert g["final"][key] == pytest.approx(v, abs=tol), (algo, key)
        assert [c[0] for c in g["curve"]] == [c[0] for c in w["curve"]]
        assert len(w["curve"]) == 2
        for (_, mg, eg), (_, mw, ew) in zip(g["curve"], w["curve"]):
            assert mg == pytest.approx(mw, abs=1e-4), algo
            assert eg == pytest.approx(ew, abs=1e-9), algo


def test_federated_pods_aggregation_matches_numpy_and_the_jax_bound():
    """One round's aggregation of three scheduled pods out of five: the
    global params against the data-size-weighted mean in float64 numpy
    (float32 accumulation: 1e-6), the bound's ζ and δ against the JAX
    package's ``BoundState`` fed the same deltas (the i-th scheduled pod's in slot i, the
    two stale slots decayed toward the mean) at 1e-5."""
    tmod = _load(os.path.join(ROOT, "examples", "torch",
                              "federated_pods.py"), "torch_federated_pods")
    rng = np.random.default_rng(0)
    K, sizes_all = 5, [512, 256, 128, 512, 64]
    part = [3, 0, 2]
    shapes = {"embed": (16, 8), "blocks": {"w": (2, 8, 8), "n": (8,)}}
    params = {"embed": rng.normal(size=shapes["embed"]),
              "blocks": {k: rng.normal(size=v)
                         for k, v in shapes["blocks"].items()}}
    params = jax.tree.map(lambda x: x.astype(np.float32), params)
    replicas = [jax.tree.map(lambda x: x + np.float32(0.1) * rng.normal(
        size=x.shape).astype(np.float32), params) for _ in part]
    mods = [("lm",)] * K
    tbound = BoundState(K, ["lm"], mods,
                        unified_weights(sizes_all, mods, ["lm"]), sizes_all)
    jbound = JBound(K, ["lm"], mods,
                    j_unified_weights(sizes_all, mods, ["lm"]), sizes_all)
    tbound.delta["lm"][:] = jbound.delta["lm"][:] = np.arange(1.0, K + 1)

    new = tmod.aggregate(params_from_numpy(params, "cpu"),
                         [params_from_numpy(r, "cpu") for r in replicas],
                         [sizes_all[k] for k in part], tbound, K)

    w = np.array([sizes_all[k] for k in part], np.float64)
    want = jax.tree.map(lambda *r: sum(wi * x.astype(np.float64)
                                       for wi, x in zip(w, r)) / w.sum(),
                        *replicas)
    for a, b in zip(tree_leaves(new), jax.tree.leaves(want)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)

    deltas = [jax.tree.map(lambda a, b: a - b, r, params) for r in replicas]
    agg = jax.tree.map(lambda *d: sum(d) / len(d), *deltas)
    jbound.update([{"lm": d} for d in deltas] + [None] * (K - len(deltas)),
                  {"lm": agg})
    assert tbound.zeta["lm"] == pytest.approx(jbound.zeta["lm"], rel=1e-5)
    np.testing.assert_allclose(tbound.delta["lm"], jbound.delta["lm"],
                               rtol=1e-5)
    # the two stale slots moved toward the fresh mean
    assert not np.allclose(tbound.delta["lm"][3:], np.arange(4.0, 6.0))
