"""Run one cell of the benchmark once, on the card this process sees.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the cell's experiment from the
seed (the port's kernels build into ``src/repro_torch/kernels/*/build`` on
a checkout's first run), warms it up, measures for ``--seconds`` (with
``--trace 1`` a few more calls then run under ``torch.profiler``, and the
per-layer metrics are reported instead of the end-to-end ones),
checks what the timed path produced against the plain reference
(``bench/reference``), and prints one JSON line last on standard output.

It exits non-zero, printing no result, without a CUDA card, when the
program (``src/repro_torch``) is missing, or when JAX or the JAX package
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with few threads: the host's share of a round is Python
    # and small numpy work, which thread pools only make jitter
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # every cache the run writes stays inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    torch.set_num_threads(1)
    from bench.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: cell {cell.name!r} needs {cell.chips} CUDA card(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 3
    runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    device="cuda", t_start=T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
