"""Client cohort step, evaluation and the Algorithm-1 round loop."""
