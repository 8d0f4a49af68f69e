"""The fusion loss (decision-level fusion + softmax CE), forward and
backward, as hand-written CUDA kernels for Hopper (``csrc/fusion_loss.cu``),
with their plain PyTorch versions (``ref.py``) and autograd wrappers
(``ops.py``)."""
