"""Pods-as-clients on the PyTorch port: the paper's JCSBA scheduler
driving LM-scale federated training (the twin of
``examples/federated_pods.py``: one process, no mesh).

8 simulated "pods" (FL clients) each hold a shard of the token stream and
a reduced qwen3-0.6b replica.  Each round: the wireless layer simulates
the inter-site links (gains redrawn per round), JCSBA picks the pods and
their bandwidth under the latency/energy budget, the chosen pods take a
local AdamW step, and per-parameter federated averaging aggregates.  This
is M=1 in the paper's notation — the unimodal degenerate case the bound
still covers (A2 only).  On a card JCSBA runs its solver kernels and the
local steps the flash-attention kernel.

  PYTHONPATH=src python examples/torch/federated_pods.py --rounds 12
  PYTHONPATH=src python examples/torch/federated_pods.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.aggregation import unified_weights
from repro_torch.core.convergence import BoundState
from repro_torch.core.trees import tree_map
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.train import to_device
from repro_torch.optim import adamw
from repro_torch.wireless import cost as wcost
from repro_torch.wireless.channel import Channel
from repro_torch.wireless.lyapunov import EnergyQueues
from repro_torch.wireless.params import WirelessParams
from repro_torch.wireless.schedulers import JCSBAScheduler, ScheduleContext


def aggregate(params, replicas, sizes, bound, K):
    """Federated averaging of the scheduled pods' updated replicas
    (``replicas``, one a pod in schedule order, ``sizes`` their data
    sizes): the data-size-weighted mean, in float32 and cast back to each
    leaf's type.  The bound tracker is refreshed from the pods' deltas to
    the global params and their mean, the i-th scheduled pod's delta in
    slot i, as the JAX example feeds it.  Returns the new global params."""
    acc, deltas, wsum = None, [], 0.0
    for newp, wk in zip(replicas, sizes):
        wsum += wk
        contrib = tree_map(lambda x: wk * x.float(), newp)
        acc = contrib if acc is None else tree_map(torch.add, acc, contrib)
        deltas.append(tree_map(torch.sub, newp, params))
    agg = {"lm": tree_map(lambda *g: sum(g) / len(g), *deltas)}
    bound.update([{"lm": d} for d in deltas] + [None] * (K - len(deltas)),
                 agg)
    return tree_map(lambda a, old: (a / wsum).to(old.dtype), acc, params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--pods", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("qwen3-0.6b").reduced()
    K = args.pods
    rng = np.random.default_rng(0)

    # model upload size: a pod pushes its delta every round
    params = steps.init_fn(cfg)(torch.Generator(dev).manual_seed(0))
    n_params = steps.param_count(params)
    model_bits = n_params * 16                       # bf16 on the wire

    # wireless layer: inter-site links; τ budget scaled to the model size
    P = WirelessParams(K=K, tau_max=2.0, B_max=200e6, E_add=5.0,
                       extra_gain_db=60.0)
    mods = [("lm",)] * K
    profile = {"lm": (float(model_bits), 5e5)}
    sizes = [args.batch * args.seq] * K
    cc = wcost.client_costs(sizes, mods, profile, P)
    ch = Channel(P, rng)
    queues = EnergyQueues(K)
    w = unified_weights(sizes, mods, ["lm"])
    bound = BoundState(K, ["lm"], mods, w, sizes)
    sched = JCSBAScheduler(rng, V=1.0, device=dev)

    opt = adamw(3e-4)
    opt_state = opt.init(params)
    step_fn = steps.make_train_step(cfg, opt, attn_chunk=64)
    streams = [TokenStream(cfg.vocab_size, seed=k) for k in range(K)]

    losses = []
    for t in range(args.rounds):
        h = ch.draw()
        ctx = ScheduleContext(h=h, Q=queues.Q, cost=cc, params=P,
                              bound=bound, round_idx=t,
                              model_dist=np.zeros(K),
                              client_modalities=mods)
        dec = sched.schedule(ctx)
        part = np.flatnonzero(dec.a)
        tcom = wcost.com_latency(dec.B, h, cc.gamma_bits, P)
        ecom = wcost.com_energy(tcom, P)

        # each scheduled pod takes a local step from the global params;
        # aggregation = data-size-weighted average of the updated replicas
        replicas, loss_round = [], []
        for k in part:
            batch = to_device(streams[k].batch(args.batch, args.seq), dev)
            newp, _, loss = step_fn(params, opt_state, batch)
            loss_round.append(float(loss))
            replicas.append(newp)
        if replicas:
            params = aggregate(params, replicas, [sizes[k] for k in part],
                               bound, K)
        queues.step(dec.a.astype(float), ecom, cc.e_cmp, P.E_add)
        losses.append(np.mean(loss_round) if loss_round else float("nan"))
        print(f"round {t:3d} pods={part.tolist()} "
              f"loss={losses[-1]:.4f} "
              f"E={queues.spent.sum():.2f}J")
    print("done — JCSBA scheduled pods under link/energy budgets (M=1 case)")
    return losses


if __name__ == "__main__":
    main()
