"""The benchmark's general code: cells from ``BENCHMARK.json``, what the
traffic drivers share, the trace reduction, the counts of operations and
bytes, the peaks, and the check against the reference."""
