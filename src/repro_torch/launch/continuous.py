"""Continuous serving under live MFL training: round-boundary params
hot-swap into a decode loop that is captured once.

    PYTHONPATH=src python -m repro_torch.launch.continuous --device cpu \\
        --rounds 2 --steps-per-round 8

A ``ContinuousServer`` holds the whole serving tree —

* ``lm``:       the decode backbone (e.g. qwen3-0.6b),
* ``fusion``:   the MFL global fusion params the training rounds refresh,
* ``coupling``: a fixed [C, V] matrix projecting fused class logits into
                vocab space —

behind one flat buffer per dtype (``launch/parambuf``).  The decode step
reads its params through views of those buffers, and the request's
multimodal context enters as a constant logit bias added at the sampling
layer: fused class logits from the request's modality features
(``paper_models`` on K=1 views, ``core.fusion.fuse_logits``), projected
through ``coupling``.

The JAX package's zero-recompile contract is a capture contract here.  On
a card the decode step is one CUDA graph (``steps.CapturedStep``),
captured after one eager warm-up step and replayed for every later step.
It reads the buffers' views, a static token, a static 0-d device position
it advances itself, the static cache and a static bias.  ``start``,
``swap``, ``load_state`` and the bias recompute only ``copy_`` into those
tensors and rebind none, so a swap needs no new capture:
``compile_counts()`` reports the captures and ``run_continuous``'s
``recompiles`` counts those after warm-up — 0, by construction and by
assertion.  Prefill and the bias run eagerly.

On a mesh (``mesh=``, a ``DeviceMesh`` over the default group's ranks,
one process a rank) the flat buffers stay replicated
(``launch.sharding.serving_buffer_shardings``): every rank holds a full
copy and runs the same decode graph, a hot swap is an in-place copy on
every rank, and the decode path has no collective — as in the JAX
package.  Every rank serves the same batch with the same arguments.

The JAX package draws ``coupling`` with ``jax.random.normal``, which the
port cannot replay: pass it as ``coupling`` (a [C, V] array, already
scaled) to serve the JAX package's; otherwise it is drawn from
``torch.Generator(coupling_seed)`` on the serving device, times
``bias_scale``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from ..convert import as_tensor
from ..core import fusion
from ..core.trees import tree_leaves, tree_map
from ..device import resolve_device
from ..fl.eval import paper_logits
from ..models import transformer as T
from ..models.config import ModelConfig
from . import parambuf
from . import steps as S
from .serve import sync
from .sharding import serving_buffer_shardings


def _on(tree, dev):
    return tree_map(lambda x: as_tensor(x).to(dev), tree)


class ContinuousServer:
    """Decode-serving engine whose params live behind flat buffers.

    ``request_feats`` is the batch's multimodal context (modality ->
    [B, ...] features, e.g. a slice of the experiment's held-out split): it
    sets the per-request fusion bias and the serving batch size."""

    def __init__(self, cfg: ModelConfig, lm_params, fusion_params,
                 request_feats: Dict[str, object], *, max_len: int,
                 bias_scale: float = 0.1, coupling_seed: int = 0,
                 coupling=None, n_groups: int = 1, attn_chunk: int = 64,
                 mesh=None, device="cuda"):
        if cfg.arch_type == "audio":
            raise NotImplementedError(
                "audio archs serve through launch.serve (encoder-side cross "
                "K/V); the continuous harness drives T.decode_step backbones")
        dev = resolve_device(device)
        if mesh is not None and (mesh.device_type != dev.type
                                 or mesh.get_coordinate() is None):
            raise ValueError(
                f"mesh of {mesh.device_type!r} ranks "
                f"{mesh.mesh.flatten().tolist()}: a server on {dev} serves "
                f"on a mesh of its device type that holds its rank")
        self.cfg, self.device, self.max_len = cfg, dev, max_len
        self.feats = _on(dict(request_feats), dev)
        self.batch = next(iter(self.feats.values())).shape[0]
        fusion_params = _on(fusion_params, dev)
        if coupling is None:
            with torch.no_grad():
                n_classes = fusion.fuse_logits(
                    paper_logits(fusion_params, self.feats)).shape[-1]
            coupling = torch.randn(
                (n_classes, cfg.vocab_size), device=dev,
                generator=torch.Generator(dev).manual_seed(coupling_seed)
            ) * bias_scale
        tree = {"lm": _on(lm_params, dev), "fusion": fusion_params,
                "coupling": _on(coupling, dev).float()}
        self.spec = parambuf.spec_of(tree)
        self.bufs = parambuf.pack(tree, self.spec)
        # replicated: this rank's buffers are its whole copy
        self.placements = (None if mesh is None else
                           serving_buffer_shardings(self.bufs, mesh))
        del tree
        # every param is a view of the buffers from here on: the frozen LM
        # and the coupling are their slots' views, so a swap skips them
        self.params = parambuf.unpack(self.bufs, self.spec)
        self._lm = self.params["lm"]
        self._coupling = self.params["coupling"]
        self._swap_fn = parambuf.make_swap(self.spec)
        self.swap_bytes = 0

        # the static tensors the captured step reads and writes
        self.cache = T.init_cache(cfg, self.batch, max_len, cfg.param_dtype,
                                  dev)
        self.token = torch.zeros((self.batch, 1), dtype=torch.long,
                                 device=dev)
        self._index = torch.zeros((), dtype=torch.long, device=dev)
        self.bias = torch.zeros((self.batch, cfg.vocab_size),
                                dtype=torch.float32, device=dev)
        self.index = 0
        self._bulk = S.make_bulk_prefill(cfg, n_groups=n_groups,
                                         attn_chunk=attn_chunk)
        self._step = S.CapturedStep(self._decode_body, dev)
        self._compute_bias()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _compute_bias(self) -> None:
        modal = paper_logits(self.params["fusion"], self.feats)
        self.bias.copy_(fusion.fuse_logits(modal) @ self.params["coupling"])

    def _decode_body(self) -> None:
        logits, _ = T.decode_step(self.params["lm"], self.cache, self.token,
                                  self._index, self.cfg)
        logits = logits.float() + self.bias[:, None, :]
        self.token.copy_(torch.argmax(logits, dim=-1))
        self._index.add_(1)

    def start(self, prompts) -> None:
        """Bulk-prefill the prompt batch [B, S] and arm the decode loop."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        B, S_ = prompts.shape
        if B != self.batch:
            raise ValueError(f"{B} prompts for a batch of {self.batch}")
        for t in tree_leaves(self.cache):
            t.zero_()
        nxt, _ = self._bulk(self.params["lm"], prompts, self.cache)
        self.token.copy_(nxt)
        self._index.fill_(S_)
        self.index = S_
        sync(self.device)

    def decode_step(self) -> float:
        """One greedy decode step for the whole batch; returns seconds
        (host clock ending in a synchronize)."""
        t0 = time.perf_counter()
        self._step()
        sync(self.device)
        self.index += 1
        return time.perf_counter() - t0

    def decode_batch(self, n: int) -> list:
        return [self.decode_step() for _ in range(n)]

    def swap(self, new_fusion_params) -> float:
        """Hot-swap fresh global fusion params: an in-place copy into the
        old buffers (the LM and the coupling, already their slots' views,
        are skipped) and a bias recompute.  Returns seconds;
        ``swap_bytes`` holds the bytes written."""
        t0 = time.perf_counter()
        self._swap_fn(self.bufs, {"lm": self._lm,
                                  "fusion": new_fusion_params,
                                  "coupling": self._coupling})
        self.swap_bytes = self._swap_fn.bytes_written
        self._compute_bias()
        sync(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def state(self):
        """Snapshot (cache, token, index), copied."""
        return (tree_map(torch.clone, self.cache), self.token.clone(),
                self.index)

    def load_state(self, st) -> None:
        cache, token, index = st
        for d, s in zip(tree_leaves(self.cache), tree_leaves(cache)):
            d.copy_(s)
        self.token.copy_(token)
        self._index.fill_(index)
        self.index = index

    def compile_counts(self) -> Dict[str, int]:
        """Captures of the decode step: the quantity the zero-recapture
        assertion compares.  Prefill, the bias and the swap run eagerly and
        capture nothing."""
        return {"decode_captures": self._step.captures}


# ---------------------------------------------------------------------------
# the interleaved driver
# ---------------------------------------------------------------------------
def run_continuous(exp, server: ContinuousServer, prompts, *, rounds: int,
                   steps_per_round: int, warmup_steps: int = 4) -> dict:
    """Interleave fused MFL training rounds with decode-step batches,
    hot-swapping the round's fresh global params at every boundary.

    Warm-up runs the eager step, the capture, a same-params swap and one
    replay; after it the captures must be stable — ``recompiles`` counts
    any later capture, and the tests and the card run assert it all-zero.
    Per-step wall times are split into ``post_swap`` (the first step after
    a swap) and ``steady``."""
    if not getattr(exp, "fused", False):
        raise ValueError("run_continuous requires an MFLExperiment with "
                         "engine='fused' (the scanned round path)")
    eng = exp._get_fused_engine()
    server.start(prompts)
    for _ in range(max(warmup_steps, 1)):
        server.decode_step()
    server.swap(exp.global_params)
    server.decode_step()
    baseline = server.compile_counts()

    steady, post_swap, swap_walls, round_walls = [], [], [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        exp.run_scanned(1)
        round_walls.append(time.perf_counter() - t0)
        swap_walls.append(server.swap(eng.round_params(exp._carry)))
        for s in range(steps_per_round):
            (post_swap if s == 0 else steady).append(server.decode_step())
    post = server.compile_counts()
    recompiles = {k: post[k] - baseline.get(k, 0) for k in post}
    tokens = server.batch * (rounds * steps_per_round)
    decode_wall = sum(steady) + sum(post_swap)
    return {
        "rounds": rounds, "steps_per_round": steps_per_round,
        "batch": server.batch, "tokens_decoded": tokens,
        "tokens_per_s": tokens / decode_wall if decode_wall else 0.0,
        "steady_latencies_s": steady,
        "post_swap_latencies_s": post_swap,
        "swap_walls_s": swap_walls,
        "swap_bytes": server.swap_bytes,
        "round_walls_s": round_walls,
        "compile_counts": post,
        "recompiles": recompiles,
    }


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(
        description="continuous serving demo: decode stream + fused MFL "
                    "rounds with round-boundary hot-swap")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--dataset", default="iemocap")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps-per-round", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--K", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..fl.runtime import MFLExperiment
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    exp = MFLExperiment(dataset=args.dataset, scheduler="jcsba", K=args.K,
                        n_samples=120, seed=args.seed, eval_every=10 ** 9,
                        engine="fused:pallas", device=dev)
    feats = {m: x[:args.batch]
             for m, x in sorted(exp.test_ds.features.items())}
    lm = S.init_fn(cfg)(torch.Generator(dev).manual_seed(args.seed))
    server = ContinuousServer(
        cfg, lm, exp.global_params, feats,
        max_len=args.prompt_len + args.rounds * args.steps_per_round + 8,
        device=dev)
    del lm
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, min(cfg.vocab_size, 1000),
                           (args.batch, args.prompt_len))
    rep = run_continuous(exp, server, prompts, rounds=args.rounds,
                         steps_per_round=args.steps_per_round)
    lat = np.array(rep["steady_latencies_s"]) * 1e3
    print(f"[continuous] arch={cfg.name} {rep['tokens_decoded']} tokens "
          f"@ {rep['tokens_per_s']:.1f} tok/s | decode "
          f"p50={np.percentile(lat, 50):.2f}ms "
          f"p99={np.percentile(lat, 99):.2f}ms | swap "
          f"{np.mean(rep['swap_walls_s']) * 1e3:.2f}ms "
          f"({rep['swap_bytes']} B) | "
          f"recompiles={sum(rep['recompiles'].values())}")
    assert sum(rep["recompiles"].values()) == 0, rep["recompiles"]
    return rep


if __name__ == "__main__":
    main()
