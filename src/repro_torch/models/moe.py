"""Mixture-of-Experts layer with sort-based capacity dispatch: the port of
the JAX package's ``models/moe.py``.

* Tokens are processed in ``n_groups`` groups (one a data shard in the JAX
  package's mesh); each group routes on its own.
* Dispatch: top-k routing on an f32 router, the (token, slot) pairs sorted
  by expert id with a stable ``argsort``, capacity ``C = ceil(k · T_group /
  E · capacity_factor)``; a pair past its expert's capacity goes to the
  scratch row ``E·C`` and is dropped (contributes 0), as in Switch/GShard
  capacity routing.
* The auxiliary load-balance loss is Switch's ``E · Σ_e f_e · P_e``.
* A shared expert (``n_shared_experts``) is a SwiGLU MLP every token
  takes (``layers.mlp``).

Nothing here reads a value back to the host — counts by ``scatter_add_``,
dropped pairs by ``torch.where`` onto the scratch row, shapes from Python
ints — so a decode step with an MoE layer is captured as one CUDA graph
(``launch/serve.py``, ``launch/continuous.py``).  The expert contractions
``ecd,edf->ecf`` are batched matmuls, as in the JAX package, where XLA
computes them outside any Pallas kernel.

Params carry no cohort axis: ``router`` [D, E] f32, ``wg``/``wu``
[E, D, F], ``wd`` [E, F, D], ``shared`` a ``layers.init_mlp`` tree.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import dtensor_layouts as DL
from .config import ModelConfig
from .layers import init_dense, mlp, randn


def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig):
    E = cfg.n_experts
    Fd = cfg.expert_d_ff or cfg.d_ff
    D = cfg.d_model
    dt = cfg.param_dtype
    scale = 1.0 / math.sqrt(D)
    p = {
        "router": randn(gen, (D, E)) * scale,
        "wg": (randn(gen, (E, D, Fd)) * scale).to(dt),
        "wu": (randn(gen, (E, D, Fd)) * scale).to(dt),
        "wd": (randn(gen, (E, Fd, D)) / math.sqrt(Fd)).to(dt),
    }
    if cfg.n_shared_experts:
        Fs = Fd * cfg.n_shared_experts
        p["shared"] = {"wg": init_dense(gen, D, Fs, dt),
                       "wu": init_dense(gen, D, Fs, dt),
                       "wd": init_dense(gen, Fs, D, dt)}
    return p


def _dispatch_group(x, logits, k: int, capacity: int):
    """x [T, D]; logits [T, E] f32.  Returns the expert slots xe
    [E, C, D] and the sorted pairs' token, gate, keep and destination,
    the per-expert counts and the router probabilities."""
    T, D = x.shape
    E = logits.shape[-1]
    dev = x.device
    probs = torch.softmax(logits, dim=-1)                       # f32
    gates, idx = torch.topk(probs, k, dim=-1)                   # [T, k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    flat_e = idx.reshape(-1)                                    # [T·k]
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(T * k, device=dev) // k
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]

    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                   # exclusive
    pos = torch.arange(T * k, device=dev) - starts[se]          # rank in e
    keep = pos < capacity
    dest = torch.where(keep, se * capacity + pos,
                       torch.full_like(pos, E * capacity))      # scratch row
    xe = x.new_zeros((E * capacity + 1, D)).index_add(0, dest, x[st])
    xe = xe[:E * capacity].reshape(E, capacity, D)
    return xe, st, sg, keep, dest, counts, probs


def _combine(y, st, sg, keep, dest, Tg: int):
    """The experts' outputs y [E, C, D] back to the group's tokens
    [Tg, D], gate-weighted (dropped pairs add zeros)."""
    E, C, D = y.shape
    yf = y.reshape(E * C, D)
    contrib = yf[torch.clamp_max(dest, E * C - 1)] * \
        (sg * keep.float())[:, None].to(y.dtype)
    return y.new_zeros((Tg, D)).index_add(0, st, contrib)


def _experts(p, xe):
    """The experts' SwiGLU on their slots xe [E, C', D] -> [E, C', D]."""
    h = torch.bmm(xe, p["wg"])
    u = torch.bmm(xe, p["wu"])
    return torch.bmm(F.silu(h) * u, p["wd"])


def _aux(counts, probs, Tg: int, k: int):
    """Switch-style load balance: E · Σ_e f_e · P_e."""
    frac = counts.float() / (Tg * k)
    return counts.shape[-1] * torch.sum(frac * probs.mean(dim=-2), dim=-1)


def _split_dispatch(p, x, xf, k: int, capacity: int):
    """The DTensor form of the group loop: x [B, S, D] and its groups xf
    [G, Tg, D], split over the data axes.  The router's logits are a
    token's own, so each rank takes them on the tokens of its data shard
    (x's split, gathered over the experts' mesh dims), as XLA's do, and
    lays them out as the groups: the decode step's one group is whole on
    every rank, its router product is not.  Each rank routes its own
    groups (``DL.by_group``), as the JAX package's ``vmap`` over groups
    does under XLA; the slots of all groups meet the experts as one
    [E, G·C, D] batch, experts split over ``model`` as their weights are,
    so a rank runs its own experts on its own groups' slots; the outputs
    come back to the groups' ranks for the combine.  Returns (y [G, Tg,
    D], the per-group aux losses [G])."""
    G, Tg, D = xf.shape
    E = p["router"].shape[-1]
    xr = DL.replicate(x, DL.feature_dims(p["wg"], 0))
    logits = DL.batch_split(xr.float() @ p["router"], G).reshape(G, Tg, E)

    def route(xl, ll):
        outs = [_dispatch_group(xl[g], ll[g], k, capacity)
                for g in range(xl.shape[0])]
        xe, st, sg, keep, dest, counts, probs = map(torch.stack, zip(*outs))
        return xe, st, sg, keep, dest, _aux(counts, probs, Tg, k)

    xe, st, sg, keep, dest, aux = DL.by_group(route, xf, logits)
    slots = xe.transpose(0, 1).reshape(E, G * capacity, D)
    w = {n: DL.fsdp_gather(p[n], xf) for n in ("wg", "wu", "wd")}
    y = _experts(w, slots).reshape(E, G, capacity, D).transpose(0, 1)

    def combine(yl, stl, sgl, keepl, destl):
        return (torch.stack([_combine(yl[g], stl[g], sgl[g], keepl[g],
                                      destl[g], Tg)
                             for g in range(yl.shape[0])]),)

    return DL.by_group(combine, y, st, sg, keep, dest)[0], aux


def moe_apply(p, x, cfg: ModelConfig, *, n_groups: int = 1):
    """x: [B, S, D] -> (y [B, S, D], aux_loss 0-d f32)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    if T % n_groups:
        raise ValueError(f"{T} tokens do not split into {n_groups} groups")
    Tg = T // n_groups
    capacity = max(int(math.ceil(k * Tg / E * cfg.capacity_factor)), 1)

    # a DTensor stream still a partial sum over ``model`` (the attention's
    # output projection) is scattered over the batch, where the shared
    # expert takes it; a group takes whole batch rows
    x = DL.reduce_partial(x, 0)
    xg = DL.batch_split(x, n_groups)
    xf = xg.reshape(n_groups, Tg, D)
    if DL.is_dtensor(xf):
        y, aux = _split_dispatch(p, x, xf, k, capacity)
        y, aux = DL.pin(y.reshape(B, S, D)), aux.mean()
    else:
        logits = xf.float() @ p["router"]
        ys, auxs = [], []
        for g in range(n_groups):
            xe, st, sg, keep, dest, counts, probs = _dispatch_group(
                xf[g], logits[g], k, capacity)
            ys.append(_combine(_experts(p, xe), st, sg, keep, dest, Tg))
            auxs.append(_aux(counts, probs, Tg, k))
        y, aux = torch.stack(ys).reshape(B, S, D), torch.stack(auxs).mean()
    if "shared" in p:
        shared = {n: {"w": DL.fsdp_gather(w["w"], x)[None]}
                  for n, w in p["shared"].items()}
        y = y + mlp(shared, x[None])[0]
    return y, aux
