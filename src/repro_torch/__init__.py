"""PyTorch/CUDA port of the wireless multimodal FL system (``repro``).

The JAX package ``repro`` stays the reference; this package imports nothing
of it (nor ``jax``).  It runs the paper's Algorithm 1 in the JAX
package's three loops — ``fl.runtime.MFLExperiment(engine=...)`` with
``"seq"`` (a local update a client), ``"batched:pallas"`` (the default) or
``"fused"`` (the whole round on the device, a CUDA graph on a card) —
with checkpoints in the JAX package's layout: JCSBA on the
population-batched solver (or a baseline scheduler), the whole-cohort BGD
step on the paper's LSTM/CNN submodels or on transformer / SSD encoders,
Eq. 12 aggregation, the Lyapunov queues and the ζ/δ trackers.  Its kernels
are hand-written CUDA for Hopper (``kernels/``): the fusion loss, flash
attention, the SSD chunk scan, and the JCSBA solver's population objective
and B_min.

It also serves what it trains (``launch/``): the JAX package's model
configs (``configs/``), the LM and Whisper decode stacks with bulk prefill
through the attention and SSD kernels and a decode step captured as one
CUDA graph, flat parameter buffers with an in-place hot swap, and
continuous serving beside fused MFL rounds.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises unless the caller asks for ``device="cpu"`` (``device.py``).
"""
