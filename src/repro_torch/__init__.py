"""PyTorch/CUDA port of the wireless multimodal FL system (``repro``).

The JAX package ``repro`` stays the reference; this package imports nothing
of it (nor ``jax``).  It runs the paper's Algorithm 1 as
``fl.runtime.MFLExperiment(engine="batched:pallas")`` runs it: JCSBA on the
population-batched solver (or a baseline scheduler), the whole-cohort BGD
step on the paper's LSTM/CNN submodels or on transformer / SSD encoders,
Eq. 12 aggregation, the Lyapunov queues and the ζ/δ trackers.  Its kernels
are hand-written CUDA for Hopper (``kernels/``): the fusion loss, flash
attention, the SSD chunk scan, and the JCSBA solver's population objective
and B_min.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises unless the caller asks for ``device="cpu"`` (``device.py``).
"""
