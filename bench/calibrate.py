"""Readings that the check's limits are set from (``bench/workloads/
<cell>.json``), on the card at the cell's own size.

    python3 bench/calibrate.py --workload <cell> --runs sound:1,2,3 control:4,5,6

Each run builds the cell as ``bench/run.py`` does, drives what its check
compares (the first rounds through ``run_round()``; one whole sweep), and
prints one JSON line of the compared numbers:

* ``sound`` — the program as it is: the lower readings;
* ``control`` — the reference itself in the program's place, computed with
  TF32 on (the precision just below the configuration's float32): the
  upper readings;
* ``half_batch`` — the program with half of every client's samples left out
  of its loss, the mean taken over the rest;
* ``altered`` — the program with each round's schedule altered where it is
  produced (client 0's bit flipped);
* ``unchanged`` — the program's local update returning the weights it was
  given (a state left unchanged, which reads 1 on ``update`` by that
  number's definition).
"""
import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted, for the duration."""
    import torch
    from repro_torch.fl.client import ModelAdapter
    from repro_torch.wireless import policies
    if fault == "half_batch":
        orig = ModelAdapter.cohort_step

        def cohort_step(self, params, init_params, feats, labels, smask,
                        avail, seeds):
            N = smask.shape[-1]
            half = (torch.arange(N, device=smask.device) < N // 2)
            return orig(self, params, init_params, feats, labels,
                        smask * half.to(smask.dtype), avail, seeds)
        ModelAdapter.cohort_step = cohort_step
        try:
            yield
        finally:
            ModelAdapter.cohort_step = orig
    elif fault == "unchanged":
        orig = ModelAdapter.cohort_step

        def same(tree, K):
            if isinstance(tree, dict):
                return {k: same(v, K) for k, v in tree.items()}
            return tree.detach().expand(K, *tree.shape).clone()

        def cohort_step(self, params, *args):
            _, grads, totals, dist_sq = orig(self, params, *args)
            return same(params, args[2].shape[0]), grads, totals, dist_sq
        ModelAdapter.cohort_step = cohort_step
        try:
            yield
        finally:
            ModelAdapter.cohort_step = orig
    elif fault == "altered":
        orig = policies.JCSBAPolicy.step_full

        def step_full(self, state, data, model_dist, draws):
            _, a, B, J, drop, _ = orig(self, state, data, model_dist, draws)
            a = a.clone()
            a[0] = ~a[0]
            return ({"warm_a": a}, a, B, J, drop,
                    policies.cohort_indices(a, self.cohort_size))
        policies.JCSBAPolicy.step_full = step_full
        try:
            yield
        finally:
            policies.JCSBAPolicy.step_full = orig
    else:
        yield


def one(cell, seed: int, mode: str, device: str) -> dict:
    import torch
    from bench.harness import drivers
    t0 = time.perf_counter()
    with planted(mode):
        drv = drivers.make(cell, seed, device)
        drv.setup()
        drv.checked_call()
    if mode == "control":
        drv.use_control()
    nums = drv.check()
    del drv
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return {"cell": cell.name, "mode": mode, "seed": seed,
            "numbers": nums, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", nargs="+", required=True,
                    help="mode:seed,seed,... (modes: sound, control, "
                         "half_batch, altered, unchanged)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench.harness import spec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    for item in args.runs:
        mode, seeds = item.split(":")
        for s in seeds.split(","):
            print(json.dumps(one(cell, int(s), mode, args.device)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
