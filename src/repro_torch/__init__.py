"""PyTorch/CUDA port of the wireless multimodal FL system (``repro``).

The JAX package ``repro`` stays the reference; this package imports nothing
of it (nor ``jax``).  Its first slice is the paper's Algorithm 1 as
``fl.runtime.MFLExperiment(engine="batched:seq+pallas")`` runs it: the host
JCSBA search, the whole-cohort BGD step on the paper's LSTM/CNN submodels,
Eq. 12 aggregation, the Lyapunov queues and the ζ/δ trackers.  Its one
kernel, the fusion loss, is hand-written CUDA for Hopper
(``kernels/fusion_loss``).

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises unless the caller asks for ``device="cpu"`` (``device.py``).
"""
