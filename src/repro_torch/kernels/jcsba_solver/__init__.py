"""The JCSBA solver's population objective and per-client B_min as
hand-written CUDA kernels for Hopper (``csrc/jcsba_solver.cu``), with their
plain PyTorch versions (``ref.py``) and the wrappers that pick between them
(``ops.py``)."""
