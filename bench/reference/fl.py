"""The paper's Algorithm 1 in plain PyTorch and numpy: one experiment's
data, clients, channel and rounds, worked out from the seed alone.

Each round, in the paper's order:

1. the channel gains and the round's random numbers are drawn;
2. JCSBA schedules clients and allocates bandwidth (Algorithm 2, P4.2',
   Theorem 1; the float64 solver of ``solver_ref``);
3. scheduled clients whose upload misses the latency budget fail; every
   other scheduled client runs one epoch of batch gradient descent on its
   own samples under H_k = F_k + Σ_m v_m·G_{k,m} (Eqs. 1-4, 7), one client
   at a time;
4. each modality's submodel is the D_k-weighted mean over the clients that
   uploaded it (Eq. 12);
5. the virtual energy queues (§V-A) and the ζ/δ trackers of Theorem 1 are
   updated;
6. on the rounds the cadence flags, the fresh global model is evaluated on
   the held-out split.

``round`` takes the schedule the program chose (``a``) and follows it, so
a near tie that the program breaks another way than float64 does cannot
make the two runs diverge; the schedule itself is judged by its objective
under this reference's state (``judge_schedule``, ``judge.py``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from . import judge, models
from .channel import Channel
from .cost import client_costs
from .params import MODALITY_PROFILES, WirelessParams
from .partition import partition, train_test_split
from .solver_common import B_LO, SolverHyper
from .solver_ref import _rate, allocate_np, bmin_np, objective_np
from .synthetic import DATASETS


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 math with TF32 off (the configuration's precision), or on
    (the control's)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def policy_draws(seed: int, K: int, hp: SolverHyper, device):
    """The JCSBA search's random bits of one round from its seed: uniforms
    from a generator on ``device``, thresholded (init [S, K] at 1/2, mut
    [G, n_clones, K] at z, fresh [G, n_fresh, K] at 1/2)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def bern(p, shape):
        return (torch.rand(shape, generator=gen, device=device) < p
                ).cpu().numpy()
    return (bern(0.5, (hp.S, K)), bern(hp.z, (hp.G, hp.n_clones, K)),
            bern(0.5, (hp.G, hp.n_fresh, K)))


class Experiment:
    """Data, clients, costs, channel and initial state of one experiment
    (a configuration under a traffic mix at one seed), all from the seed.

    ``state()`` is the round-0 server state; ``draw_rounds(R)`` consumes
    the experiment's numpy stream in the order the paper's loop does
    (channel, the policy's seed, the clients' dropout seeds)."""

    def __init__(self, config: Mapping, traffic: Mapping, seed: int,
                 device="cpu"):
        self.config, self.traffic, self.device = config, traffic, device
        self.seed = int(seed)
        K = int(traffic["K"])
        self.K = K
        self.params = WirelessParams(**{"K": K, **traffic.get("wireless",
                                                              {})})
        full = DATASETS[config["dataset"]](seed=self.seed,
                                           n=int(traffic["n_samples"]))
        self.train, self.test = train_test_split(full, 0.2, self.seed)
        self.clients = partition(self.train, K, traffic["omega"], self.seed)
        self.mods = sorted(full.features)
        self.has = np.array([[m in c.modalities for c in self.clients]
                             for m in self.mods])             # [M, K]
        self.D = np.array([c.size for c in self.clients], np.float64)
        self.cost = client_costs(self.D.astype(int),
                                 [c.modalities for c in self.clients],
                                 MODALITY_PROFILES[config["dataset"]],
                                 self.params)
        wb = np.where(self.has, self.D, 0.0)
        self.wbar = wb / wb.sum(-1, keepdims=True)
        self.rng = np.random.default_rng(self.seed)
        self.channel = Channel(self.params, self.rng)
        self.hp = SolverHyper()
        self.init_params = models.init_model(config, self.seed)
        tr = config["trackers"]
        self.eta = float(config["train"]["eta"])
        self.rho = float(tr["rho"])
        self.staleness = float(tr["staleness"])
        self._init_tr = (float(tr["init_zeta"]), float(tr["init_delta"]))
        self.dropout = float(config["train"]["dropout"])
        self.v_weights = dict(config["train"]["v_weights"])
        dev = device
        # each client's shard and the held-out split on the device
        self.shards = [({m: torch.as_tensor(c.dataset.features[m],
                                            device=dev)
                         for m in c.modalities},
                        torch.as_tensor(c.dataset.labels,
                                        device=dev).long())
                       for c in self.clients]
        self.test_set = ({m: torch.as_tensor(x, device=dev)
                          for m, x in self.test.features.items()},
                         torch.as_tensor(self.test.labels, device=dev).long())

    def state(self) -> dict:
        M, K = len(self.mods), self.K
        z0, d0 = self._init_tr
        return {"params": {m: {k: _leafmap(v, lambda x: x.to(self.device))
                               for k, v in p.items()}
                           for m, p in self.init_params.items()},
                "Q": np.zeros(K), "spent": np.zeros(K),
                "zeta": np.full(M, z0), "delta": np.full((M, K), d0),
                "warm_a": np.zeros(K, bool), "round": 0}

    def draw_rounds(self, rounds: int) -> List[dict]:
        out = []
        for _ in range(rounds):
            h = self.channel.draw()
            pseed = int(self.rng.integers(2 ** 31))
            cseeds = np.array([self.rng.integers(2 ** 31)
                               for _ in range(self.K)], np.int64)
            out.append({"h": h, "policy_seed": pseed,
                        "client_seeds": cseeds,
                        "draws": policy_draws(pseed, self.K, self.hp,
                                              self.device)})
        return out

    # ------------------------------------------------------------------
    def solver_data(self, st: dict, h, V: float) -> dict:
        p = self.params
        return {"Q": st["Q"], "gamma": self.cost.gamma_bits,
                "h": np.asarray(h, np.float64),
                "tau_rem": p.tau_max - self.cost.tau_cmp,
                "e_cmp": self.cost.e_cmp, "B_max": float(p.B_max),
                "p_tx": float(p.p_tx), "N0": float(p.N0), "V": float(V),
                "eta": self.eta, "rho": self.rho,
                "zeta2": np.square(st["zeta"]),
                "delta2": np.square(st["delta"]), "wbar": self.wbar,
                "has": self.has, "D": self.D}

    def objective(self, data: dict, A) -> np.ndarray:
        """J₂ (P3) of each schedule row of ``A`` with its KKT bandwidth;
        +inf where infeasible.  Also returns the bandwidths."""
        A = np.asarray(A, bool)
        bmin, ok = bmin_np(data["gamma"], data["h"], data["tau_rem"],
                           data["B_max"], data["p_tx"], data["N0"], self.hp)
        B, feas = allocate_np(A, bmin, ok, data["Q"], data["gamma"],
                              data["h"], data["B_max"], data["p_tx"],
                              data["N0"], self.hp)
        return objective_np(A, B, feas, data), B

    def judge_schedule(self, st: dict, xs: dict, V: float, a) -> float:
        """How much worse the schedule ``a`` is than this reference's own
        JCSBA searches on the same state and random bits
        (``judge.schedule_gap``)."""
        data = self.solver_data(st, xs["h"], V)
        seeds = np.stack([st["warm_a"], np.zeros(self.K, bool)])
        return judge.schedule_gap(data, seeds, xs["draws"], self.hp, a)

    # ------------------------------------------------------------------
    def round(self, st: dict, xs: dict, a, V: float, evaluate: bool,
              tf32: bool = False) -> dict:
        """One round from state ``st`` following schedule ``a``: the new
        state, with the round's outputs (``ok``, ``weights``, ``metrics``)
        beside it."""
        p, K = self.params, self.K
        a = np.asarray(a, bool)
        data = self.solver_data(st, xs["h"], V)
        _, B = self.objective(data, a[None])
        B = B[0]
        # latency (C4): scheduled but late is a failure; energy (Eqs. 15-18)
        r = _rate(np.maximum(B, B_LO), data["h"], data["p_tx"], data["N0"])
        tcom = np.where(a, data["gamma"] / np.maximum(r, 1e-30), 0.0)
        ok = a & (tcom + self.cost.tau_cmp <= p.tau_max + 1e-12)
        used = a * (data["p_tx"] * tcom + self.cost.e_cmp)
        Qn = st["Q"] - (p.E_add - used)
        Qn = Qn * (Qn > 0)
        upload = self.has & ok[None]                           # [M, K]
        with precision(tf32):
            new_params, zeta, delta, w = self._train(st, upload,
                                                     xs["client_seeds"])
            metrics = self.evaluate(new_params) if evaluate else {}
        return {"params": new_params, "Q": Qn, "spent": st["spent"] + used,
                "zeta": zeta, "delta": delta, "warm_a": a.copy(),
                "round": st["round"] + 1, "ok": ok, "a": a,
                "weights": w, "metrics": metrics}

    def _train(self, st, upload, seeds):
        """Local updates of every uploading client, Eq. 12 and the
        trackers: (new params, ζ [M], δ [M, K], weights [M, K])."""
        params, K = st["params"], self.K
        grads: Dict[int, dict] = {}
        for k in range(K):
            mods = [m for i, m in enumerate(self.mods) if upload[i, k]]
            if mods:
                grads[k] = self._client_grads(params, k, mods,
                                              int(seeds[k]))
        wnum = np.where(upload, self.D, 0.0)
        tot = wnum.sum(-1, keepdims=True)
        w = np.where(tot > 0, wnum / np.where(tot > 0, tot, 1.0), 0.0)
        new, zeta, delta = {}, st["zeta"].copy(), st["delta"].copy()
        for i, m in enumerate(self.mods):
            ks = [k for k in range(K) if upload[i, k]]
            if not ks:
                new[m] = params[m]
                continue
            # Eq. 9 aggregate gradient; Eq. 12 over θ_k = θ − η g_k
            gbar = _leafsum([_leafmap(grads[k][m], lambda x, s=w[i, k]: s * x)
                             for k in ks])
            new[m] = _leafzip(params[m], gbar, lambda p_, g: p_ - self.eta * g)
            zeta[i] = _norm(gbar)
            norms = np.array([_norm(_leafzip(grads[k][m], gbar, torch.sub))
                              for k in ks])
            stale = self.has[i] & ~upload[i]
            delta[i, stale] = (self.staleness * delta[i, stale]
                               + (1 - self.staleness) * norms.mean())
            delta[i, ks] = norms
        return new, zeta, delta, w

    def _client_grads(self, params, k, mods, seed):
        feats, labels = self.shards[k]
        leaves = {m: _leafmap(params[m], lambda x: x.detach().clone()
                              .requires_grad_()) for m in mods}
        lg = models.logits(leaves, {m: feats[m] for m in mods}, self.config,
                           seed=seed, dropout=self.dropout)
        loss = models.multimodal_loss(lg, labels, self.v_weights)
        flat = [x for m in mods for x in _leaves(leaves[m])]
        gs = iter(torch.autograd.grad(loss, flat))
        return {m: _leafmap(leaves[m], lambda _: next(gs)) for m in mods}

    @torch.no_grad()
    def evaluate(self, params) -> Dict[str, float]:
        feats, labels = self.test_set
        lg = models.logits(params, feats, self.config)
        fused = sum(lg[m] for m in self.mods) / len(self.mods)
        out = {"multimodal": float((fused.argmax(-1) == labels).float()
                                   .mean()),
               "loss": float(F.cross_entropy(fused, labels))}
        for m in self.mods:
            out[m] = float((lg[m].argmax(-1) == labels).float().mean())
        return out


# ---------------------------------------------------------------------------
# parameter trees: {name: tensor or {name: tensor}}
# ---------------------------------------------------------------------------
def _leafmap(tree, fn):
    if isinstance(tree, dict):
        return {k: _leafmap(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leafzip(a, b, fn):
    if isinstance(a, dict):
        return {k: _leafzip(a[k], b[k], fn) for k in a}
    return fn(a, b)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


def _leafsum(trees):
    out = trees[0]
    for t in trees[1:]:
        out = _leafzip(out, t, torch.add)
    return out


def _norm(tree) -> float:
    return float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                for x in _leaves(tree))))


def named_leaves(params) -> Dict[str, torch.Tensor]:
    """{"audio.lstm0.wi": tensor, ...} of a {modality: params} tree."""
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            out[prefix] = t
    walk("", params)
    return out
