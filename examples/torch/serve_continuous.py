"""Continuous serving under live MFL training on the PyTorch port: a
decode stream whose fusion params hot-swap at every round boundary (the
twin of ``examples/serve_continuous.py``).

One process, one device: fused JCSBA rounds (``engine="fused:pallas"``,
each round one captured CUDA graph on a card) advance the global fusion
params; between rounds a ``ContinuousServer`` decodes a reduced-LM token
stream whose sampling layer carries the fused multimodal bias.  Each
boundary swap is one in-place copy into the serving buffers
(``launch/parambuf``), and the decode graph is captured once.

  PYTHONPATH=src python examples/torch/serve_continuous.py --rounds 3
  PYTHONPATH=src python examples/torch/serve_continuous.py --device cpu
  PYTHONPATH=src python -m repro_torch.launch.continuous --help  # full CLI
"""
from repro_torch.launch.continuous import main

if __name__ == "__main__":
    main()
