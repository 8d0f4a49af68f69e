"""Start the ranks of an SPMD program on one host and collect their
results.

``Ranks(argv, world, logdir)`` starts ``world`` processes of ``argv``,
rank ``r`` with ``r`` and ``world`` appended to its arguments; each
initializes its own process group from them (``torchrun`` does the same
through its environment).  Rank ``r`` writes its standard output to
``logdir/rank<r>.out`` and its errors to ``rank<r>.err``, and prints its
result as one JSON line, its last.  ``results()`` waits for every rank,
stops them all on the first failure or at the time limit, and returns the
JSON results in rank order; a rank that failed fails the call with the end
of its error output."""
import json
import os
import subprocess
import time


class Ranks:
    """``world`` processes of ``argv``, started at construction, so the
    caller can work while they run; ``results()`` waits for them (up to
    ``timeout`` seconds from the start) and stops every one.  ``env``: the
    ranks' environment (default: this process's)."""

    def __init__(self, argv, world: int, logdir, timeout: float = 300.0,
                 env=None):
        self.world, self.end = world, time.monotonic() + timeout
        self.logs = [(os.path.join(logdir, f"rank{r}.out"),
                      os.path.join(logdir, f"rank{r}.err"))
                     for r in range(world)]
        self.procs = []
        try:
            for r, (out, err) in enumerate(self.logs):
                with open(out, "w") as fo, open(err, "w") as fe:
                    self.procs.append(subprocess.Popen(
                        [*map(str, argv), str(r), str(world)], stdout=fo,
                        stderr=fe, env=env))
        except BaseException:
            self.close()
            raise

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def outputs(self) -> list:
        """Each rank's standard output, in rank order, once every rank
        has exited 0 (else ``AssertionError`` with the failed ranks'
        errors)."""
        try:
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() not in (None, 0) for p in self.procs) or \
                        time.monotonic() > self.end:
                    break
                time.sleep(0.05)
        finally:
            self.close()
        failed = []
        for r, (p, (_, err)) in enumerate(zip(self.procs, self.logs)):
            if p.returncode != 0:
                with open(err) as f:
                    failed.append(f"rank {r} of {self.world} exited "
                                  f"{p.returncode}:\n{f.read()[-6000:]}")
        if failed:
            raise AssertionError("\n".join(failed))
        texts = []
        for out, _ in self.logs:
            with open(out) as f:
                texts.append(f.read())
        return texts

    def results(self) -> list:
        """Each rank's last JSON line, in rank order."""
        return [json.loads(t.strip().splitlines()[-1])
                for t in self.outputs()]
