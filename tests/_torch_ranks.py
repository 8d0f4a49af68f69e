"""Launch SPMD ranks for the port's multi-device tests.

``Ranks(body, world, tmp)`` starts ``world`` processes of one script on
a gloo group through the port's launcher (``repro_torch.launch.ranks``),
as the JAX package's mesh tests run their subprocesses
(``tests/test_sharded_sweep.py``): the group initializes through a file
under ``tmp`` (so pytest-xdist workers never share a port), each rank uses
one torch thread, and each prints its result as one JSON line, its last.
The script's preamble gives ``RANK``, ``WORLD``, ``TMP`` (a
``pathlib.Path``) and ``emit(obj)``; ``results()`` collects their lines.
A rank that fails ends the others and fails the call with its error
output."""
import os
import sys

from repro_torch.launch import ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")

PREAMBLE = r"""
import json
import pathlib
import sys

import torch
import torch.distributed as dist

TMP, RANK, WORLD = pathlib.Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{TMP}/pg", rank=RANK,
                        world_size=WORLD)


def emit(obj):
    print(json.dumps(obj), flush=True)
"""


class Ranks(ranks.Ranks):
    """``world`` rank processes of ``body``, started at construction, so
    the caller can work while they run; ``results()`` waits for them (up
    to ``timeout`` seconds from the start) and stops every one."""

    def __init__(self, body: str, world: int, tmp, timeout: float = 300.0):
        script = os.path.join(tmp, "ranks.py")
        with open(script, "w") as f:
            f.write(PREAMBLE + body + "\ndist.destroy_process_group()\n")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, TESTS]),
                   OMP_NUM_THREADS="1")
        super().__init__([sys.executable, script, tmp], world, tmp, timeout,
                         env)
