"""Device kernels in the traced calls ÷ the scenario-rounds they completed:
the launches of one captured round (fl/fused_round.py), a count that
repeats exactly while the round's program does not change.  Source: the
profiler's trace."""


def read(run):
    t = run.trace
    if t is None or run.rounds_traced <= 0 or t.n_kernels <= 0:
        return None
    return t.n_kernels / run.rounds_traced
