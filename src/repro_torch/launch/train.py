"""Training entry point: the port of the JAX package's
``launch/train.py``, with its flags, defaults and ``[train]`` lines, plus
``--device`` (default ``cuda``; the CPU only when asked —
``resolve_device`` raises without a card).

Modes:
* ``standard`` — LM training of any registered arch (``--reduced``: the
  2-block, tiny-width variant of the same family).  On a card the attention,
  SSD and fusion-loss contractions go through their kernels
  (``steps.make_train_step``, ``impl="pallas"``).
* ``federated`` — the paper's wireless-MFL loop (Algorithm 1) through the
  port's ``MFLExperiment``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode federated \\
      --rounds 4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..data.tokens import TokenStream, vlm_batch
from ..device import resolve_device
from ..optim import adamw, warmup_cosine
from . import steps as S


def to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``: token ids as int64, the stub
    frontends' float features (``src_embeds``, ``patches``) in their own
    type (float32), as the JAX package feeds them: the encoder and the
    vision head promote the params they meet."""
    return {k: torch.as_tensor(v, device=device,
                               dtype=torch.long if v.dtype.kind in "iu"
                               else None)
            for k, v in batch.items()}


def make_batch(cfg, stream: TokenStream, rng: np.random.Generator,
               batch: int, seq: int) -> dict:
    """One numpy batch as ``train_standard`` draws it (the JAX package's
    draws in its order): VLM archs ``vlm_batch`` with 16 patches, the
    rest the token stream, audio archs 64 source frames on top."""
    if cfg.arch_type == "vlm":
        return vlm_batch(rng, batch, seq, 16, cfg.frontend_dims[0],
                         cfg.vocab_size)
    b = stream.batch(batch, seq)
    if cfg.arch_type == "audio":
        b["src_embeds"] = rng.normal(
            size=(batch, 64, cfg.d_model)).astype(np.float32)
    return b


def train_standard(args):
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[train] arch={cfg.name} reduced={args.reduced} "
          f"layers={cfg.n_layers} d_model={cfg.d_model}")
    params = S.init_fn(cfg)(torch.Generator(dev).manual_seed(args.seed))
    n_params = S.param_count(params)
    print(f"[train] params: {n_params/1e6:.2f}M")
    opt = adamw(warmup_cosine(args.lr, 10, args.steps))
    opt_state = opt.init(params)
    step_fn = S.make_train_step(cfg, opt, n_groups=1,
                                attn_chunk=min(256, args.seq))
    stream = TokenStream(cfg.vocab_size, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    losses = []
    for i in range(args.steps):
        batch = to_device(make_batch(cfg, stream, rng, args.batch, args.seq),
                          dev)
        t0 = time.time()
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"[train] step {i:4d} loss={losses[-1]:.4f} "
                  f"({time.time() - t0:.2f}s)")
    assert np.isfinite(losses).all(), "NaN loss"
    print(f"[train] first->last loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


def train_federated(args):
    from ..fl.runtime import MFLExperiment
    exp = MFLExperiment(dataset=args.dataset, scheduler=args.scheduler,
                        n_samples=args.n_samples, seed=args.seed, V=args.V,
                        device=args.device)
    exp.run(args.rounds, verbose=True)
    print("[federated] final:", exp.final_metrics())
    return exp


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="standard",
                    choices=["standard", "federated"])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    # federated
    ap.add_argument("--dataset", default="crema_d")
    ap.add_argument("--scheduler", default="jcsba")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--n-samples", type=int, default=800)
    ap.add_argument("--V", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "federated":
        return train_federated(args)
    return train_standard(args)


if __name__ == "__main__":
    main()
