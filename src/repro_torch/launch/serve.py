"""Batched serving driver: prefill a prompt batch, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --reduced --device cpu

The port of the JAX package's ``launch/serve.py``, with its flags and its
``[serve]`` line, plus ``--device`` (default ``cuda``; the CPU only when
asked) and ``--n-layers`` (cut the depth, the widths kept).  Params come
from a random init at the config's width (no weights are loaded); the
prompts are the same ``np.random.default_rng(seed)`` draw
as the JAX package's, so both packages serve identical prompts.

Prefill runs as one bulk pass that fills the KV cache
(``steps.make_bulk_prefill``: on a card the attention and SSD contractions
go through the flash-attention and SSD kernels); ``--teacher-forced``
keeps the token-by-token path for A/B.  Audio archs precompute all layers'
cross-K/V in one stacked einsum (``encdec.cross_kv``).  Decode runs over
static buffers (``Decoder``): on a card the decode step is one CUDA graph,
captured after one eager step and replayed for every later one.  For
params hot-swapped under live MFL training, see ``launch/continuous.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import encdec, transformer as T
from ..models.config import ModelConfig
from . import steps as S

#: the encoder's source frames for audio archs (the JAX package's)
SRC_FRAMES = 64


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Decoder:
    """Greedy decode over static buffers — the token [B, 1], the position
    (a 0-d device tensor the step advances itself) and the cache — so that
    on a card the step runs as one captured CUDA graph (``CapturedStep``).
    ``set`` copies a token and a position in; ``step`` decodes one token
    into ``token``; ``eager_step`` runs the same step without the graph
    (the reference for replays)."""

    def __init__(self, cfg: ModelConfig, params, cache, batch: int,
                 device):
        dev = torch.device(device)
        self.params, self.cache = params, cache
        self.token = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.index = torch.zeros((), dtype=torch.long, device=dev)
        self._serve_step = S.make_serve_step(cfg)
        self.graph = S.CapturedStep(self._body, dev)

    def _body(self) -> None:
        nxt, _ = self._serve_step(self.params, self.cache, self.token,
                                  self.index)
        self.token.copy_(nxt)
        self.index.add_(1)

    def set(self, token, index: int) -> None:
        self.token.copy_(token)
        self.index.fill_(index)

    def step(self) -> torch.Tensor:
        self.graph()
        return self.token

    def eager_step(self) -> torch.Tensor:
        self._body()
        return self.token

    def serve_step(self, params, cache, token, index):
        """``steps.make_serve_step``'s contract on the static buffers
        (``params`` and ``cache`` are the ones the decoder holds): copy
        the token and position in, decode one token, return the static
        token."""
        if params is not self.params or cache is not self.cache:
            raise ValueError("a Decoder steps only its own params and cache")
        self.set(token, index)
        return self.step(), cache


def teacher_forced_prefill(serve_step, params, cache, prompts):
    """Prefill by teacher-forcing the prompt one token at a time through
    decode steps: the bulk path's A/B baseline — it fills the cache
    identically at S times the dispatches."""
    for i in range(prompts.shape[1]):
        nxt, cache = serve_step(params, cache, prompts[:, i:i + 1], i)
    return nxt, cache


def _percentile(ms, q):
    return float(np.percentile(ms, q)) if len(ms) else float("nan")


def serve(args, stats: Optional[dict] = None):
    """Serve one batch; returns the generated tokens [B, gen_len].  A dict
    passed as ``stats`` receives the timings: ``prefill_ms`` (host clock
    ending in a synchronize), ``decode_ms`` (each graph replay's step on a
    card, each eager step on the CPU), ``captures``, ``tok_s`` (as the
    ``[serve]`` line counts), ``decode_tok_s`` and ``peak_bytes``."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if getattr(args, "n_layers", None):
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(args.seed)
    params = S.init_fn(cfg)(torch.Generator(dev).manual_seed(args.seed))
    B = args.batch
    prompt_len = args.prompt_len
    max_len = prompt_len + args.gen_len
    prompts = torch.as_tensor(rng.integers(
        0, min(cfg.vocab_size, 1000), (B, prompt_len)), device=dev)

    enc = None
    if cfg.arch_type == "audio":
        src = torch.as_tensor(rng.normal(size=(B, SRC_FRAMES, cfg.d_model)),
                              dtype=cfg.param_dtype, device=dev)
        with torch.no_grad():
            enc = encdec.encode(params, src, cfg, attn_chunk=64)
        cache = encdec.init_dec_cache(cfg, B, max_len, SRC_FRAMES,
                                      cfg.param_dtype, dev)
        # cross K/V from the encoder output: one stacked einsum, all layers
        ck, cv = encdec.cross_kv(params, enc, cfg)
        cache["cross_k"].copy_(ck)
        cache["cross_v"].copy_(cv)
    else:
        cache = T.init_cache(cfg, B, max_len, cfg.param_dtype, dev)
    dec = Decoder(cfg, params, cache, B, dev)

    sync(dev)
    t0 = time.perf_counter()
    if args.teacher_forced:
        nxt, cache = teacher_forced_prefill(dec.serve_step, params, cache,
                                            prompts)
        nxt = nxt.clone()
    else:
        bulk = S.make_bulk_prefill(cfg, attn_chunk=args.attn_chunk)
        if enc is not None:
            nxt, cache = bulk(params, prompts, enc, cache)
        else:
            nxt, cache = bulk(params, prompts, cache)
        dec.set(nxt, prompt_len)
    sync(dev)
    prefill_s = time.perf_counter() - t0
    generated = [nxt]
    decode_ms = []
    for _ in range(args.gen_len - 1):
        t1 = time.perf_counter()
        replay = dec.graph.graph is not None
        tok = dec.step()
        sync(dev)
        if replay or dev.type != "cuda":
            decode_ms.append((time.perf_counter() - t1) * 1e3)
        generated.append(tok.clone())
    sync(dev)
    dt = time.perf_counter() - t0
    out = torch.cat(generated, dim=1)
    toks = B * (prompt_len + args.gen_len - 1)
    mode = "teacher-forced" if args.teacher_forced else "bulk"
    print(f"[serve] arch={cfg.name} batch={B} prefill={mode} steps={toks} "
          f"{toks / dt:.1f} tok/s wall={dt:.2f}s")
    print("[serve] sample:", out[0, :16].tolist())
    assert out.shape == (B, args.gen_len)
    if stats is not None:
        stats.update(
            cfg=cfg, prefill_ms=prefill_s * 1e3, decode_ms=decode_ms,
            decode_p50_ms=_percentile(decode_ms, 50),
            decode_p99_ms=_percentile(decode_ms, 99),
            captures=dec.graph.captures, tok_s=toks / dt,
            decode_tok_s=(B * len(decode_ms) / (sum(decode_ms) / 1e3)
                          if decode_ms else float("nan")),
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--attn-chunk", type=int, default=64)
    ap.add_argument("--teacher-forced", action="store_true",
                    help="per-token prefill (the bulk path's A/B baseline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="layers to keep (default: the config's)")
    return ap


def main(argv=None):
    return serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
