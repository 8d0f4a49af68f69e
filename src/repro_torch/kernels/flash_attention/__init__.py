"""Causal (optionally sliding-window) GQA attention, forward, as a hand-written CUDA
kernel for Hopper (``csrc/flash_attention.cu``), with its plain PyTorch
version (``ref.py``) and the ``[B, S, H, hd]`` front end (``ops.py``)."""
