"""The Mamba2 SSD intra-chunk contraction, forward, as a hand-written CUDA
kernel for Hopper (``csrc/ssd_scan.cu``), with its plain PyTorch version
(``ref.py``) and the chunked-SSD forward built on it (``ops.py``)."""
