"""Tree optimizers on tensors: the port's copy of the JAX package's
``optim/optimizers.py``.

API: each factory returns an object with

    init(params)                 -> state
    update(grads, state, params) -> (updates, state)

and ``apply_updates(params, updates)`` adds the updates in each param's
dtype.  The state trees keep the JAX package's layout — ``{"step", "m",
"v"}``, Adafactor's ``{"step", "f": {... {"r", "c"} | {"v"}}}`` — so
``convert.params_to_numpy`` compares them leaf by leaf.  ``step`` is a
0-d int32 tensor on the params' device and the schedules are functions of
it, so no update reads a value back to the host.  Moments and updates are
float32 whatever the param dtype, as there.

Adafactor keeps factored second moments (Shazeer & Stern 2018): O(n+m)
state for an n x m matrix, the choice for the largest architectures
(``launch.steps.make_optimizer``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .. import dtensor_layouts as DL
from ..core.trees import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((x.float() * x.float()).sum()
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(g, 1e-12), max=1.0)
    return tree_map(lambda x: x * scale, grads), g


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


@dataclasses.dataclass
class Optimizer:
    init: Callable
    update: Callable


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
def sgd(lr):
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"]
        upd = tree_map(lambda g: -lr_fn(step) * g.float(), grads)
        return upd, {"step": step + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9):
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"step": _step0(params), "m": tree_map(_zeros32, params)}

    def update(grads, state, params=None):
        m = tree_map(lambda m_, g: beta * m_ + g.float(), state["m"], grads)
        upd = tree_map(lambda m_: -lr_fn(state["step"]) * m_, m)
        return upd, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0):
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"step": _step0(params), "m": tree_map(_zeros32, params),
                "v": tree_map(_zeros32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)
        t = step.float()
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        lr_t = lr_fn(step)

        def upd(m_, v_, p):
            u = -(lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            return u

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw):
    return adam(lr, weight_decay=weight_decay, **kw)


def adafactor(lr, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8):
    """Factored second-moment optimizer: O(n+m) state for an n x m
    matrix (row means ``r``, column means ``c`` over the last two axes),
    a full ``v`` for vectors."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def zf(p):
            if p.dim() >= 2:
                return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                         device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=torch.float32,
                                         device=p.device)}
            return {"v": _zeros32(p)}
        return {"step": _step0(params), "f": tree_map(zf, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        beta = 1.0 - torch.pow(step.float(), -decay)
        lr_t = lr_fn(step)

        def upd(g, f):
            g32 = g.float()
            g2 = g32.square().add_(eps)
            if g.dim() >= 2:
                r = beta * f["r"] + (1 - beta) * g2.mean(dim=-1)
                c = beta * f["c"] + (1 - beta) * g2.mean(dim=-2)
                del g2
                vhat = (r[..., None] * c[..., None, :]).div_(torch.clamp_min(
                    r.mean(-1, keepdim=True)[..., None], eps))
                newf = {"r": r, "c": c}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                vhat = v.clone()
                newf = {"v": v}
            # u = g · rsqrt(vhat + eps), in vhat's buffer
            u = DL.scaled_rsqrt(vhat, eps, g32)
            del g32
            rms = torch.sqrt(u.square().mean() + eps)
            u.div_(torch.clamp_min(rms / clip_threshold, 1.0))
            return u.mul_(-lr_t), newf

        # the walk follows the grads' tree: each leaf meets its own
        # {"r", "c"} | {"v"} dict (the JAX package's flatten_up_to)
        outs = tree_map(upd, grads, state["f"])
        return (tree_map(lambda o: o[0], outs),
                {"step": step, "f": tree_map(lambda o: o[1], outs)})

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        frac = torch.clamp(step / total_steps, 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + torch.cos(math.pi * frac)))
    return lr


def warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                  min_frac: float = 0.05):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        w = torch.clamp(step / max(warmup, 1), max=1.0)
        return torch.where(step < warmup, base_lr * w, cos(step - warmup))
    return lr


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam,
              "adamw": adamw, "adafactor": adafactor}
