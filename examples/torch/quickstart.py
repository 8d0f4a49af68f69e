"""Quickstart on the PyTorch port: 10 rounds of wireless multimodal FL
with JCSBA, and one LM-architecture loss, through the public API of
``repro_torch`` (the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch/quickstart.py               # card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu

On a card the rounds run the fusion-loss kernels and JCSBA's solver
kernels, and the LM loss the flash-attention kernel.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.fl.runtime import MFLExperiment
from repro_torch.launch import steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--n-samples", type=int, default=400)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # --- the paper's system: decision-fusion MFL over a simulated cell ---
    exp = MFLExperiment(dataset="crema_d", scheduler="jcsba",
                        n_samples=args.n_samples, seed=0, device=args.device)
    exp.run(args.rounds, verbose=True)
    print("final:", exp.final_metrics())

    # --- the model zoo: any assigned arch, reduced for a quick run ---
    cfg = get_config("qwen3-4b").reduced()
    dev = exp.device
    params = steps.init_fn(cfg)(torch.Generator(dev).manual_seed(0))
    loss_fn = steps.make_loss_fn(cfg, attn_chunk=64)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 128)),
                                device=dev)
             for k in ("tokens", "labels")}
    with torch.no_grad():
        loss = float(loss_fn(params, batch))
    print(f"{cfg.name} (reduced) loss:", loss)
    return loss


if __name__ == "__main__":
    main()
