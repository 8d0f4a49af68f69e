"""Batched serving on the PyTorch port: bulk prefill and greedy decode of
a reduced arch through the serve step the dry run runs for decode_32k
(the twin of ``examples/serve_batched.py``).

  PYTHONPATH=src python examples/torch/serve_batched.py --arch qwen3-0.6b
  PYTHONPATH=src python examples/torch/serve_batched.py --arch mamba2-370m
  PYTHONPATH=src python examples/torch/serve_batched.py --device cpu

On a card the prefill runs the flash-attention kernel (the SSD chunk
kernel for mamba2-370m) and the decode steps replay one CUDA graph.
"""
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reduced" not in argv:
        argv.append("--reduced")
    return serve_main(argv)


if __name__ == "__main__":
    main()
