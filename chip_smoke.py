#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. build the four kernel libraries from ``src/repro_torch/kernels`` (one
   nvcc per source, all started together, ``sm_90a``) and print the build
   seconds and each ``-Xptxas -v``;
2. set up the main path — the paper's ``MFLExperiment(dataset, K=10,
   n_samples=1200, engine="batched:pallas")`` for CREMA-D and IEMOCAP,
   and the same with ``arch="transformer"`` and ``arch="ssd"`` — and hold
   every kernel against its plain PyTorch version on the card, in float32
   and float64:
   * the fusion loss at the shape each paper experiment's own client stack
     gives it (labels, sample mask and modality ownership taken from it),
     at the ``seq`` loop's one-client shard (K=1, T = the shard),
     at an LM-like shape with one broadcast head (K=1, T=512, V=32000,
     M=3) and at the JAX package's fusion sweep (tests/test_kernels.py),
     each of the last two in float32 and bfloat16; the Python plan's
     shared memory held equal to the C side's;
   * flash attention and the SSD chunk kernel on the operands the backbone
     experiments' own forward passes hand them (captured from the client
     stacks and the test split), and at the JAX package's kernel-sweep
     shapes (tests/test_kernels.py; attention in bfloat16 too), with the
     autograd Functions' gradients against plain autograd;
3. drive the main path — paper CREMA-D for 3 rounds and IEMOCAP for 1, then
   each backbone on each dataset for 2 rounds, every one with JCSBA on the
   card's solver kernels — with the launch counters set to 0 just before
   and read after each run, failing if a kernel of that run's path was not
   launched; check its output: finite params, every metric present, one
   ``+remat`` round equal to the plain round, and small twin runs on the
   card that agree with the plain path on the CPU (one of them JCSBA on
   the card's solver against the plain solver, on the same CPU-drawn
   bits); one ``batched:seq+pallas`` CREMA-D round (the host search) and
   one round of each baseline scheduler; profile one paper, one
   transformer and one SSD round;
3a. ``[seq]``: paper CREMA-D on the ``seq:pallas`` loop (one local update
   a scheduled client) for 2 rounds against a ``batched:pallas`` twin on
   the same seed: same participants, params within 1e-4, one fusion-loss
   forward and one backward launch a participant; both loops' round times.
   ``[fused]``: paper CREMA-D on ``fused:pallas`` (the round captured as a
   CUDA graph, one graph with eval and one without) for 8 rounds stepwise
   and 2 + 6 through ``run_scanned``, both held against the round's body run
   eagerly on the card on the same inputs (same participants, params
   within 1e-4), the eager body against the CPU on CPU-drawn bits, and 2
   rounds each with the transformer and SSD backbones; launches counted
   as each graph's captured launches times its replays; round times after
   capture, capture seconds, and one profiled round a model whose trace
   must show every kernel of its path;
3c. ``[scenario]``: the scenario axis over the fused round, one captured
   round replayed scenario by scenario — the JAX zoo benchmark's 12 rows
   (iemocap at the paper's widths, K=10, 120 samples a client, 128 test
   samples, 30 rounds, eval every 5, JCSBA) through one
   ``scan_scenario_grid`` with per-scenario stores and test splits (2
   captures for the whole zoo), 2 rows x 3 rounds of it against the body
   run eagerly on the card and against the CPU on CPU-drawn bits, the
   swap's time; the dense 12-point V grid (E_add = 2e-4, so the queues
   grow and the population kernel takes its Q>0 branch; 40 rounds)
   through ``scan_v_grid``, with the population kernel's device ms a
   round from a profiled run; 2-row grids on the transformer and SSD
   backbones (2 rounds); the population kernel reading V from the device,
   one captured launch replayed at two V against the plain version;
3d. ``[serve]``: ``launch.serve.serve`` at full width from a random init
   — qwen3-0.6b (B=8, prompt 512, 64 generated tokens, bf16),
   mamba2-370m (B=4, 512 in two 256-token chunks, 32), whisper-base
   (B=4, 64 source frames, prompt 16, 16) and gemma3-12b (48 layers, 40
   local with a 1024-token window and 8 global, B=2, prompt 2048, 32; the
   attention kernel's wide regime at hd 256) — each with the counters set
   to 0 just before it (its bulk prefill must launch the attention or SSD
   kernel once a layer): prefill ms, decode ms a step over the graph
   replays (median, p99), tokens/s, peak memory, captures; reduced f32
   qwen3 and mamba2 on the card against the CPU (tokens identical, logits
   and caches within 1e-4); at full width the kernel prefill against the
   plain one and both against float32 (gemma3: kernel vs plain at full
   depth, the float32 comparison at one 6-layer super-block), the decode
   graph against the eager step, a profiled decode step and prefill (with
   its kernel's share of the device time), and the teacher-forced A/B at
   a 128-token prompt; the kernels against their plain versions at the
   operands the prefills recorded and on random operands at gemma3-12b's
   local and global shapes and kimi-k2's (B=1, S=4096, H=64/8, hd 112)
   (timed in phase 4); ``[continuous]``: full-width qwen3-0.6b beside
   IEMOCAP fused rounds (3 rounds of 16 decode steps), no capture after
   warm-up, and a hot swap against a fresh server (tokens identical);
3b. ``[solver]``: the two JCSBA solver kernels against their plain versions
   on the round data the paper CREMA-D run gave the solver (K=10, captured)
   and at K = 100 and 1000, rows of 1-5 clients, P = 1, 20, 24; one whole
   solve with the kernels against one with the plain versions on the same
   draws (same a*, J and B within tolerance);
6. ``[train]``: the LM train step (``launch.steps.make_train_step``,
   kernel route) at full width from a random init, bf16 — qwen3-0.6b
   (28 layers, B=8, S=256, 8 steps), whisper-base (6+6, B=8, S=256, 64
   source frames, 4 steps), mamba2-370m (48 layers, B=4, S=512, 3 steps),
   llava-next-34b and llama4-scout-17b-a16e cut to one layer (B=4, S=256,
   3 steps, Adafactor as for the full configs; llava one more step with
   ``loss_chunk=128``), gemma3-12b cut to one super-block (5 local layers
   and 1 global, B=2, S=2048, 3 steps, Adafactor: AdamW's state for its
   3.36 B params does not fit the card) — each with the peak-memory and
   launch counters reset just before it and the launches held to one a
   mixer layer a step and one fusion-loss launch each way a loss: step ms
   p50, tok/s, peak GiB, mfu (``models/analysis.py``'s 6·N_active·B·S over
   the bf16 dense peak), losses; one step's value and grads, kernel route
   against plain route; a profiled qwen3 and gemma3 step; reduced f32
   twins of six archs (jamba: MoE plus SSD), 3 steps card vs CPU;
   llama4-scout's ``serve()`` at one
   layer (the MoE in the captured decode graph, 0 recaptures); every
   kernel against its plain version at the train steps' operands (timed
   in phase 4, their launches the JSON line's ``"train"`` path);
7. ``[mesh]``: the multi-device layer — ``from_store`` at
   ``benchmarks/population_scale.py``'s largest configuration (iemocap,
   K=100000, Random J=10, 2 samples a client) and JCSBA capped at a
   cohort of 10 at K=5000, each a 2-point V sweep of 3 rounds on one
   device (graph replays; ms a scenario-round, store and peak GiB); a
   1-rank NCCL group capturing the client-sharded round with its
   collectives (replays against the eager body); then 2 ranks of this
   script on the one card over gloo (``--mesh-rank``): the same sweeps on
   a 1x2 ("scenario", "clients") mesh (each rank holding half the store;
   eager body) held against the one-device sweeps, B_min on K/2 rows and
   each solve's reassembled B_min and ok against the K-row kernel's; the
   12-row zoo on a 2x1 ("scenario",) mesh, each rank capturing its own
   round pair, held against the one-device zoo; full-width qwen3-0.6b
   ``ContinuousServer(mesh=)`` against the unsharded server across a hot
   swap (the references run after the counts are read); a failed rank
   fails the phase; the kernels against their plain versions at the
   operands these runs recorded — fusion at the population cohort, B_min
   on K and K/2 rows, the population kernel at K=5000 (timed in phase 4);
8. ``[dryrun]`` and ``[examples]``: ``python -m repro_torch.launch.dryrun
   --device cuda`` on the fake 16x16 mesh for qwen3-0.6b train_4k,
   prefill_32k and decode_32k, llama4-scout-17b-a16e train_4k,
   gemma3-12b long_500k and jamba-v0.1-52b train_4k, and on the fake
   2x16x16 mesh for qwen3-0.6b train_4k (one subprocess each, all started
   together; qwen3-0.6b's train and prefill steps at one super-block with
   attention in one chunk, the others at 2 super-blocks; no kernel — the
   step runs ``impl="xla"`` on fake tensors), each combo's status,
   counted FLOPs and bytes a rank, global / per-rank FLOPs, temporary
   peak a rank and collective bytes printed, its status held to the
   CPU's; qwen3-0.6b prefill_32k's batched products and the rest a rank
   held to the JAX compile's dots a device within 5 %, and qwen3-0.6b
   train_4k's per-rank FLOPs 2x16x16 / 16x16 to the compile's ratio
   within 5 % (``tests/data/dryrun_jax_dots.json``);
   meanwhile each twin of ``examples/*.py`` (``examples/torch``) runs
   here on the card at small arguments with the counters set to 0 just
   before it, and fails if a kernel of its path was not launched
   (the JSON line's ``"examples"`` path); the operands each twin hands
   the kernels (the first of each shape, and its first JCSBA solve) are
   recorded, and every kernel is held against its plain version at them
   — the fusion loss at the twins' cohorts, attention at the reduced
   LMs' loss, train and prefill shapes, the SSD chunk at the mamba2
   prefill, the autograd Functions, B_min and the population kernel at
   each solve (timed in phase 4 where no other phase timed the shape);
4. time each kernel (CUDA events, after warm-up) beside its plain version,
   its bound and, where one PyTorch call computes the same function, that
   call, at every shape of phases 2, 3b, 7 and 8; a ``[floor]`` line gives the
   device time of a one-element ``add_``, the launch floor.

Imports nothing of JAX.  Exits non-zero, printing no result, without CUDA.
The last line is ``{"ok": true, "device": {...}}``; the line before it the
per-kernel JSON, and before that the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
#: outside the tensor cores and dense bfloat16 FLOP/s on them — a kernel's
#: bound is max(bytes, operations at the peak for its operands' type)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
DEVICE = "cuda"

#: where the TPU kernels this port replaces live in the JAX package
REPLACES = {
    "fusion_loss_fwd": "src/repro/kernels/fusion_loss/kernel.py:78",
    "fusion_loss_bwd": "src/repro/kernels/fusion_loss/kernel.py:215",
    "fusion_loss_reduce": "src/repro/kernels/fusion_loss/kernel.py:215",
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:25",
    "ssd_chunk_fwd": "src/repro/kernels/ssd_scan/kernel.py:22",
    # no Pallas kernel: XLA fuses these in the JAX package's jitted solve
    "jcsba_bmin_kernel": "src/repro/wireless/solver/jaxsolver.py:69",
    "jcsba_population_kernel": "src/repro/wireless/solver/jaxsolver.py:113",
}
_CSRC = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
SOURCES = {"fusion_loss_fwd": _CSRC.format("fusion_loss"),
           "fusion_loss_bwd": _CSRC.format("fusion_loss"),
           "fusion_loss_reduce": _CSRC.format("fusion_loss"),
           "flash_attention_fwd": _CSRC.format("flash_attention"),
           "ssd_chunk_fwd": _CSRC.format("ssd_scan"),
           "jcsba_bmin_kernel": _CSRC.format("jcsba_solver"),
           "jcsba_population_kernel": _CSRC.format("jcsba_solver")}
SOLVER_KERNELS = ("jcsba_bmin_kernel", "jcsba_population_kernel")
#: the kernels the main path launches (the training step reads no gsq/gdot,
#: so it launches no partial reduce)
PATH_KERNELS = ("fusion_loss_fwd", "fusion_loss_bwd", "flash_attention_fwd",
                "ssd_chunk_fwd") + SOLVER_KERNELS
#: the kernels each architecture's runs must launch
ARCH_KERNELS = {"lstm-cnn": ("fusion_loss_fwd", "fusion_loss_bwd"),
                "transformer": ("fusion_loss_fwd", "fusion_loss_bwd",
                                "flash_attention_fwd"),
                "ssd": ("fusion_loss_fwd", "fusion_loss_bwd",
                        "ssd_chunk_fwd")}
ARCH_KERNELS = {a: ks + SOLVER_KERNELS for a, ks in ARCH_KERNELS.items()}
#: the baseline schedulers, one CREMA-D round each
BASELINES = ("random", "round_robin", "selection", "dropout")

#: the seq and fused loops' phases: paper CREMA-D at the main path's size;
#: the fused runs evaluate every other round, so both graphs run
SEQ_ROUNDS = 2
FUSED_ROUNDS = 8
FUSED_KW = dict(K=10, n_samples=1200, engine="fused:pallas", eval_every=2)
#: the scenario axis: the JAX zoo benchmark's 12 rows
#: (benchmarks/scenario_zoo.py:default_zoo, copied as data: the port
#: imports nothing of benchmarks/) at the paper's scale, and its dense V
#: grid (benchmarks/v_frontier.py:32)
ZOO_ROWS = (
    dict(name="iid", split="iid", omega=0.0),
    dict(name="iid,om=0.3", split="iid", omega=0.3),
    dict(name="iid,om=0.6", split="iid", omega=0.6),
    dict(name="iid,om=0.6/0.2", split="iid", omega=(0.6, 0.2)),
    dict(name="dir01,om=0.3", split="dirichlet", alpha=0.1, omega=0.3),
    dict(name="dir05,om=0.3", split="dirichlet", alpha=0.5, omega=0.3),
    dict(name="nat,om=0.3", split="natural", alpha=0.5, n_groups=4,
         omega=0.3),
    dict(name="nat-sig2,om=0.3", split="natural", alpha=0.5, n_groups=4,
         group_sigma=2.0, omega=0.3),
    dict(name="iid,om=0.3,noise1", split="iid", omega=0.3, noise_sigma=1.0),
    dict(name="iid,om=0.3,erase03", split="iid", omega=0.3,
         erasure_rate=0.3),
    dict(name="iid,om=0.3,no-text", split="iid", omega=0.3,
         test_missing="text"),
    dict(name="iid,om=0.3,V=10", split="iid", omega=0.3, V=10.0),
)
ZOO_GEOM = dict(dataset="iemocap", K=10, n_per_client=120, n_test=128)
ZOO_ROUNDS, ZOO_EVAL, V_ROUNDS = 30, 5, 40
#: a population launch longer than this took the Q>0 branch (the κ/φ⁻¹
#: bisections: ~180 µs on the card; the closed-form branches ~3 µs)
Q_BRANCH_US = 50
DENSE_V_GRID = (0.0001, 0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0,
                50.0, 100.0)
#: each wrapper's kernels by their names in a profiler trace
TRACE_NAMES = {"fusion_loss_fwd": "fusion_fwd_",
               "fusion_loss_bwd": "fusion_bwd_",
               "flash_attention_fwd": "attn_", "ssd_chunk_fwd": "ssd_",
               "jcsba_bmin_kernel": "jcsba_bmin_kernel",
               "jcsba_population_kernel": "jcsba_population_kernel"}

#: the main path: (arch, dataset, rounds) at MFLExperiment's defaults; the
#: paper runs are cut from 5 + 2 rounds to 3 + 1 to fit the backbones in
MAIN_PATH = (("lstm-cnn", "crema_d", 3), ("lstm-cnn", "iemocap", 1),
             ("transformer", "crema_d", 2), ("transformer", "iemocap", 2),
             ("ssd", "crema_d", 2), ("ssd", "iemocap", 2))
MAIN_KW = dict(K=10, n_samples=1200, engine="batched:pallas")

# tolerances, float32 kernel against the plain version (another summation
# order): fusion-loss per-row losses and residuals, per-element gradients,
# and the gsq/gdot sums over K·T·V terms; attention and SSD as the JAX
# package's kernel sweeps hold its kernels (tests/test_kernels.py), and
# bfloat16 attention likewise
TOL_FWD = dict(rtol=1e-5, atol=1e-5)
TOL_BWD = dict(rtol=1e-5, atol=2e-6)
TOL_SUM = dict(rtol=1e-4, atol=1e-6)
TOL_ATTN = dict(rtol=2e-5, atol=2e-5)
TOL_ATTN_BF16 = dict(rtol=3e-2, atol=3e-2)
TOL_SSD = dict(rtol=1e-4, atol=1e-4)
TOL_GRAD = dict(rtol=1e-5, atol=1e-5)
# the solver kernels against their plain versions (tests/test_solver_parity
# .py's tolerances): J, and B in Hz (float32 bisections whose sums differ in
# order, which may move B by ulps near the κ root)
TOL_SOLVER_J = dict(rtol=1e-4, atol=1e-6)
TOL_SOLVER_B = dict(rtol=1e-3, atol=2.0)

#: the JAX package's fusion-loss sweep (tests/test_kernels.py): (M, T, V)
FUSION_SWEEP = ((1, 128, 1024), (2, 256, 2048), (3, 64, 4096), (4, 128, 512))
#: the JAX package's kernel sweeps (tests/test_kernels.py): attention
#: (B, H, KH, S, hd, window) and SSD chunks (B, nc, Q, nh, hp, N), with
#: the JAX configs' chunk (src/repro/models/config.py ssm_chunk = 256)
ATTN_SWEEP = ((1, 4, 2, 128, 64, None), (2, 4, 4, 256, 32, None),
              (1, 8, 2, 256, 64, 64), (1, 2, 1, 512, 128, 128))
SSD_SWEEP = ((1, 2, 64, 2, 32, 16), (2, 4, 32, 4, 16, 8),
             (1, 1, 128, 8, 64, 32),
             # the JAX configs' 256-token chunk: mamba2-370m and jamba
             (1, 1, 256, 2, 64, 128), (1, 1, 256, 2, 64, 16))


#: the serving path: full-width LMs from a random init on the card,
#: (arch, batch, prompt, generated tokens), and the kernel each one's bulk
#: prefill launches once a mixer layer
SERVE_RUNS = (("qwen3-0.6b", 8, 512, 64), ("mamba2-370m", 4, 512, 32),
              ("whisper-base", 4, 16, 16), ("gemma3-12b", 2, 2048, 32))
SERVE_KERNEL = {"qwen3-0.6b": "flash_attention_fwd",
                "mamba2-370m": "ssd_chunk_fwd",
                "whisper-base": "flash_attention_fwd",
                "gemma3-12b": "flash_attention_fwd"}
#: the serve runs whose prefill is checked kernel vs plain vs float32, and
#: the layers the float32 comparison keeps (None: all): gemma3-12b's float32
#: copy at full depth (51 GB beside its 25.5 GB of bf16 params) does not
#: fit the card, so its kernel-vs-plain prefill runs at full depth and the
#: float32 comparison at one super-block
SERVE_CHECKS = {"qwen3-0.6b": None, "mamba2-370m": None, "gemma3-12b": 6}
#: the teacher-forced A/B's prompt, the decode steps the graph is held to
#: the eager step over, and the reduced card-vs-CPU twins' batch and prompt
TF_PROMPT, GRAPH_STEPS, TWIN_B, TWIN_S = 128, 8, 2, 64
#: the wide attention regime's shapes on random bfloat16 operands (label,
#: (B, S, H, KH, hd, window)): gemma3-12b's local and global layers at its
#: serve and train shape, kimi-k2's attention at a 4096-token prompt
WIDE_RANDOM = (("gemma3-12b local (random)", (2, 2048, 16, 8, 256, 1024)),
               ("gemma3-12b global (random)", (2, 2048, 16, 8, 256, None)),
               ("kimi-k2-1t-a32b (random)", (1, 4096, 64, 8, 112, None)))
#: continuous serving: JAX's launch.continuous main() (IEMOCAP fused rounds,
#: K=6, n_samples=120, JCSBA, 4 requests, 32-token prompts) with the LM at
#: full width
CONT_KW = dict(rounds=3, steps_per_round=16)
CONT_B, CONT_PROMPT = 4, 32

#: the training path (``launch/train.py``, ``launch/steps.py``'s train
#: half): the JAX configs unchanged in width, bf16, random init —
#: (arch, layers kept or None for all, batch, sequence, steps); each run's
#: optimizer is ``make_optimizer``'s for the FULL config (Adafactor from
#: 30 B params on), its learning rate ``train_standard``'s
#: ``warmup_cosine(3e-4, 10, steps)``
TRAIN_RUNS = (("qwen3-0.6b", None, 8, 256, 8),
              ("whisper-base", None, 8, 256, 4),
              ("mamba2-370m", None, 4, 512, 3),
              ("llava-next-34b", 1, 4, 256, 3),
              ("llama4-scout-17b-a16e", 1, 4, 256, 3),
              ("gemma3-12b", 6, 2, 2048, 3))
#: runs on Adafactor where ``make_optimizer`` picks AdamW: gemma3-12b's one
#: super-block holds 3.36 B params (2.01 B of them the embedding and the
#: untied head), and AdamW's functional update keeps the old and the new
#: float32 moments and a float32 update tree at once (5 x 4 B a param,
#: 67 GB), beside 13.4 GB of bf16 params and grads and the float32
#: temporaries of the 1.0 B-param head (~12 GB): past the card's 80 GB;
#: Adafactor's factored state fits
TRAIN_ADAFACTOR = ("gemma3-12b",)
#: the VLM's extra step through ``vlm_loss_chunked``
TRAIN_LOSS_CHUNK = 128
#: reduced float32 archs run 3 steps on the card and on the CPU
TRAIN_TWINS = ("qwen3-0.6b", "whisper-base", "mamba2-370m",
               "llava-next-34b", "llama4-scout-17b-a16e", "jamba-v0.1-52b")
TWIN_LR = 1e-3
#: full-width kernel route against the plain route, one step, bf16: the
#: loss within 1e-3 of itself, the grads' global relative error (‖Δg‖ /
#: ‖g‖) within 3e-2, every leaf's max|Δ| within 0.25 of its max|g| — set
#: from the readings of five archs (loss ≤ 8.0e-5, global 6.7e-3–1.02e-2,
#: worst leaf 1.4e-2–9.4e-2, llama4-scout's MoE leaves the largest)
TOL_TRAIN_LOSS_BF16, TOL_TRAIN_GRAD_BF16, TOL_TRAIN_LEAF_BF16 = \
    1e-3, 3e-2, 0.25
#: the MoE serve at full width: (arch, layers, batch, prompt, generated)
MOE_SERVE = ("llama4-scout-17b-a16e", 1, 4, 64, 16)
#: [mesh]: benchmarks/population_scale.py's largest configuration
#: (K=100000, Random, J=10) and its --mesh-smoke default (K=5000, JCSBA
#: capped at a cohort of 10), iemocap, 2 samples a client, 3 rounds, V
#: [0.1, 1.0]; on one device, then on 2 ranks of the one card
POP_RUNS = (("random", 100000), ("jcsba", 5000))
POP_DATASET, POP_J, POP_N, POP_ROUNDS = "iemocap", 10, 2, 3
POP_V = (0.1, 1.0)
MESH_RANKS, MESH_TIMEOUT = 2, 600
MESH_DIR = os.path.join(ROOT, "build", "mesh")
MESH_KERNELS = ("fusion_loss_fwd", "fusion_loss_bwd") + SOLVER_KERNELS
#: a sharded sweep against the one-device sweep: the JAX package's own
#: tolerance (tests/test_sharded_sweep.py); graph replays against the
#: eager body: the fused tests' (tests/test_torch_isolation.py)
TOL_SHARD = dict(rtol=2e-6, atol=1e-7)
TOL_GRAPH = 1e-6

#: [dryrun]: the LM-scale dry run (``repro_torch.launch.dryrun``) on the
#: fake 16x16 or 2x16x16 mesh, one subprocess a combo (the fake group
#: stays out of this process), all started together; each combo must come
#: out as it does on the CPU (README's table of statuses): (arch, shape,
#: mesh, status, super-blocks, levers), the one-block combos with
#: attention in one chunk, as the reference's counts take it
DRYRUN_COMBOS = (
    ("qwen3-0.6b", "train_4k", "16x16", "ok", 1, {"attn_chunk": 4096}),
    ("qwen3-0.6b", "train_4k", "2x16x16", "ok", 1, {"attn_chunk": 4096}),
    ("qwen3-0.6b", "prefill_32k", "16x16", "ok", 1, {"attn_chunk": 32768}),
    ("kimi-k2-1t-a32b", "decode_32k", "16x16", "ok", 1, None),
    ("qwen3-0.6b", "decode_32k", "16x16", "ok", 2, None),
    ("llama4-scout-17b-a16e", "train_4k", "16x16", "ok", 2, None),
    ("gemma3-12b", "long_500k", "16x16", "ok", 2, None),
    ("jamba-v0.1-52b", "train_4k", "16x16", "ok", 2, None))
#: the JAX compile's dot FLOPs a device at one super-block and one
#: attention chunk (tools/dryrun_vs_jax.py --write)
DRYRUN_REFERENCE = os.path.join(ROOT, "tests", "data",
                                "dryrun_jax_dots.json")
#: combos whose batched products and the rest a rank are held to the
#: reference's within this fraction
DRYRUN_BAND = {("qwen3-0.6b", "prefill_32k", "16x16"): 0.05,
               ("kimi-k2-1t-a32b", "decode_32k", "16x16"): 0.05}
#: (arch, shape, fraction): the combo's per-rank FLOPs 2x16x16 / 16x16
#: held to the reference's dots' ratio within the fraction
DRYRUN_RATIO = ("qwen3-0.6b", "train_4k", 0.05)
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun_smoke")
DRYRUN_TIMEOUT = 600
#: [examples]: each twin of examples/*.py (examples/torch/) on the card
#: at small arguments, and the kernels its path must launch
EXAMPLES = (
    ("quickstart", ("--rounds", "2"),
     ("fusion_loss_fwd", "fusion_loss_bwd", "flash_attention_fwd")
     + SOLVER_KERNELS),
    ("wireless_mfl", ("--rounds", "2", "--n-samples", "400", "--engine",
                      "batched:pallas", "--out",
                      os.path.join(ROOT, "build", "examples",
                                   "wireless_mfl.json")),
     ("fusion_loss_fwd", "fusion_loss_bwd") + SOLVER_KERNELS),
    ("federated_pods", ("--rounds", "2"),
     ("flash_attention_fwd",) + SOLVER_KERNELS),
    ("serve_batched", ("--arch", "qwen3-0.6b"), ("flash_attention_fwd",)),
    ("serve_batched", ("--arch", "mamba2-370m"), ("ssd_chunk_fwd",)),
    ("serve_continuous", ("--rounds", "2", "--steps-per-round", "8"),
     ("fusion_loss_fwd", "fusion_loss_bwd", "flash_attention_fwd")
     + SOLVER_KERNELS),
)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """Per-call milliseconds from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_ms(torch, fn, iters: int = 50):
    """Mean device time of one call of ``fn`` from ``torch.profiler``: every
    kernel (and copy) the calls run on the device, summed, over the number
    of calls; None when the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(_device_us(e) for e in prof.key_averages()
                if getattr(e, "device_type", None) == cuda)
    return total / iters / 1e3 if total else None


def bound(bytes_ops, peak_flops=PEAK_F32_FLOPS):
    nbytes, ops = bytes_ops
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / peak_flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(torch, name, got, want, tol, errs):
    got = got.double()
    want = want.double()
    err = float((got - want).abs().max())
    ok = torch.allclose(got, want, **tol)
    print(f"  {name:44s} max|err| {err:.3e}  (rtol {tol['rtol']:g}, "
          f"atol {tol['atol']:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    errs.append(err)
    return err


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def build_phase():
    """One nvcc per source, all started together."""
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.fusion_loss import build as fl_build
    from repro_torch.kernels.jcsba_solver import build as js_build
    from repro_torch.kernels.ssd_scan import build as ssd_build
    libs = [fl_build.LIBRARY, fa_build.LIBRARY, ssd_build.LIBRARY,
            js_build.LIBRARY]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(verbose=True), libs))
    for lib in libs:
        lib.load()
    print(f"[build] {len(libs)} kernel libraries built (one nvcc each, in "
          f"parallel) and loaded in {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 2a: the fusion-loss kernels against their plain versions
# ---------------------------------------------------------------------------
def make_case(torch, labels, avail, mask, V, seg, seed, dtype=None):
    """Cohort inputs on the card for labels [K, T] and avail [M, K, T]:
    random logits (a broadcast head is [K, T/S, V]; float32, or ``dtype``)
    and cotangents that are zero on the rows the sample mask pads."""
    rng = np.random.default_rng(seed)
    K, T = labels.shape
    M = avail.shape[0]
    t = lambda x: torch.as_tensor(x, device=DEVICE)     # noqa: E731
    logits = [t((rng.normal(size=(K, T // s if s else T, V)) * 3.0)
                .astype(np.float32)).to(dtype or torch.float32)
              for s in seg]
    d_fused = rng.normal(size=(K, T)).astype(np.float32) * mask
    d_modal = rng.normal(size=(M, K, T)).astype(np.float32) * mask
    return dict(logits=logits, labels=t(labels), avail=t(avail),
                d_fused=t(d_fused), d_modal=t(d_modal), seg=tuple(seg),
                shape=(K, T, V, M))


def path_case(torch, exp, seed):
    """The kernels' inputs at the shape the main path gives them: labels,
    sample mask and modality ownership from the experiment's own client
    stack, with one client unscheduled (avail 0, as the round runs it) and
    one row with no modality at all."""
    _, labels, smask = exp._get_stacked()
    labels = labels.cpu().numpy()
    mask = smask.cpu().numpy().astype(np.float32)
    T = labels.shape[1]
    own = np.array([[m in mods for mods in exp.client_mods]
                    for m in exp.all_mods], np.float32)         # [M, K]
    avail = np.repeat(own[:, :, None], T, axis=2)
    avail[:, -1] = 0.0
    avail[:, 0, 0] = 0.0
    return make_case(torch, labels, avail, mask, exp.train_ds.n_classes,
                     (0,) * len(exp.all_mods), seed)


def seq_case(torch, exp, seed, mods=None):
    """The shape the ``seq`` loop gives the kernels: one client on its own
    unpadded shard, K=1, every row available, with one head for each of
    the client's modalities (``local_update`` passes only those): the first
    client that owns exactly ``mods`` (default: every modality)."""
    want = tuple(sorted(mods or exp.all_mods))
    k = next((i for i, own in enumerate(exp.client_mods)
              if tuple(sorted(own)) == want), None)
    if k is None:
        raise AssertionError(f"no client owns exactly {want}")
    labels = np.asarray(exp.clients[k].dataset.labels)[None]
    T = labels.shape[1]
    M = len(want)
    return make_case(torch, labels, np.ones((M, 1, T), np.float32),
                     np.ones((1, T), np.float32), exp.train_ds.n_classes,
                     (0,) * M, seed)


def lm_case(torch, dtype=None):
    """An LM-like shape the main path does not run, with one broadcast
    head: K=1, T=512, V=32000, M=3, seg=(0, 0, 128)."""
    K, T, V, M = 1, 512, 32000, 3
    labels = np.random.default_rng(2).integers(0, V, (K, T))
    avail = np.ones((M, K, T), np.float32)
    avail[:, 0, 0] = 0.0
    mask = np.ones((K, T), np.float32)
    mask[:, -3:] = 0.0
    return make_case(torch, labels, avail, mask, V, (0, 0, 128), seed=2,
                     dtype=dtype)


def sweep_case(torch, M, T, V, dtype, seed):
    """One client at a shape of the JAX fusion sweep, its availability as
    that test draws it (the first modality always there)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, V, (1, T))
    avail = np.maximum(rng.integers(0, 2, (M, 1, T)),
                       (np.arange(M) == 0)[:, None, None]).astype(np.float32)
    return make_case(torch, labels, avail, np.ones((1, T), np.float32), V,
                     (0,) * M, seed, dtype)


def case_label(torch, c):
    K, T, V, M = c["shape"]
    bf = c["logits"][0].dtype == torch.bfloat16
    return (f"K={K} T={T} V={V} M={M}"
            + (f" seg={c['seg']}" if any(c["seg"]) else "")
            + (" bf16" if bf else ""))


def work(case, nblk):
    """(bytes, operations) each fusion-loss kernel needs on this case: every
    input read once (the logits in their own type), every output written
    once: each modality's float32 gradient at that modality's own size (a
    broadcast head's [K, T/S, V], not the token grid the kernel writes it
    on).  The backward is counted as the main path runs it, without
    partials."""
    K, T, V, M = case["shape"]
    KT = K * T
    operands = sum(x.numel() * x.element_size() for x in case["logits"])
    dlogits = sum(x.numel() * 4 for x in case["logits"])
    rows_in = KT * 4 + M * KT * 4                          # labels, avail
    fwd = (operands + rows_in + (3 * KT + 3 * M * KT) * 4,
           KT * V * (5 * M + 4))
    bwd = (operands + rows_in + (2 * KT + 2 * M * KT) * 4 + dlogits,
           KT * V * (11 * M + 5))
    red = (K * nblk * M * 2 * 4 + 2 * K * M * 4, K * nblk * M * 2)
    return {"fusion_loss_fwd": fwd, "fusion_loss_bwd": bwd,
            "fusion_loss_reduce": red}


def kernel_phase(torch, ops, ref, exps):
    """Fusion-loss kernels vs plain (float32 and float64) at each paper
    experiment's shape, the LM-like one and the JAX fusion sweep's, the
    last two in float32 and bfloat16 (the plain versions upcast the same
    bfloat16 values, so the float32 tolerances hold); the plan's shared
    memory against the C side's.  Returns the cases and the max abs error
    per kernel against the float32 plain."""
    cases = {name: path_case(torch, exp, seed=1 + i)
             for i, (name, exp) in enumerate(exps.items())}
    cases["crema_d/seq"] = seq_case(torch, exps["crema_d"], seed=9)
    # a unimodal participant's step: M=1, the rows regime's one-head
    # instances
    for i, m in enumerate(exps["crema_d"].all_mods):
        cases[f"crema_d/seq {m}"] = seq_case(torch, exps["crema_d"],
                                             seed=20 + i, mods=(m,))
    cases["lm"] = lm_case(torch)
    cases["lm/bf16"] = lm_case(torch, torch.bfloat16)
    for i, (M, T, V) in enumerate(FUSION_SWEEP):
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "/bf16")):
            cases[f"jax-sweep{tag} M={M}"] = sweep_case(torch, M, T, V,
                                                        dtype, 10 + i)
    errs = {k: [] for k in ("fusion_loss_fwd", "fusion_loss_bwd",
                            "fusion_loss_reduce")}
    for label, c in cases.items():
        fusion_check(torch, ops, ref, label, c, errs)
    return cases, {k: max(v) for k, v in errs.items()}


def fusion_check(torch, ops, ref, label, c, errs):
    """One case of the fusion-loss kernels against their plain versions
    (float32 and float64), the plan's shared memory against the C side's,
    the autograd Function against the backward kernel; the float32 errors
    go into ``errs``."""
    from repro_torch.kernels.fusion_loss.build import load
    K, T, V, M = c["shape"]
    lg, lab, av = c["logits"], c["labels"], c["avail"]
    p = ops.plan(K, T, V, M, c["seg"], lg[0].dtype)
    print(f"[kernels] {label}: {case_label(torch, c)} ({p.regime} "
          f"regime, width {p.fwd.width} / {p.bwd.width}, "
          f"{p.fwd.blocks} / {p.bwd.blocks} blocks)")
    for bwd, d in ((0, p.fwd), (1, p.bwd)):
        c_smem = load().fusion_loss_smem_bytes(
            ops.REGIMES[p.regime], bwd, d.width, V, M,
            lg[0].element_size())
        if c_smem != d.smem:
            raise AssertionError(f"plan shared memory {d.smem} != the C "
                                 f"side's {c_smem}")
    print("  plan shared memory equal to the C side's: ok")
    out = ops.fusion_loss_fwd(lg, lab, av, c["seg"])
    dl, gsq, gdot = ops.fusion_loss_bwd(lg, lab, av, c["d_fused"],
                                        c["d_modal"], out[3], out[5],
                                        c["seg"])
    _, gsq2, gdot2 = ops.fusion_loss_bwd(lg, lab, av, c["d_fused"],
                                         c["d_modal"], out[3], out[5],
                                         c["seg"])
    torch.cuda.synchronize()
    if not (torch.equal(gsq, gsq2) and torch.equal(gdot, gdot2)):
        raise AssertionError("gsq/gdot differ between two runs")
    print("  gsq/gdot bitwise equal across two runs: ok")
    # the training step's backward writes no partials: same dlogits
    dl_step, no_sq, no_dot = ops.fusion_loss_bwd(
        lg, lab, av, c["d_fused"], c["d_modal"], out[3], out[5],
        c["seg"], with_partials=False)
    if (no_sq is not None or no_dot is not None
            or not all(map(torch.equal, dl_step, dl))):
        raise AssertionError("backward without partials differs")
    print("  backward without partials: dlogits bitwise equal: ok")
    stack = ops._plain_stack(lg, c["seg"])
    names = ("fused_nll", "modal_nll", "fused_max", "fused_lse",
             "modal_max", "modal_lse")
    for dtype in (torch.float32, torch.float64):
        tag = "f32" if dtype == torch.float32 else "f64"
        want = ref.fusion_loss_ref(stack, lab, av, dtype=dtype,
                                   save_residuals=True)
        sink = errs["fusion_loss_fwd"] if dtype == torch.float32 else []
        for n, g, w in zip(names, out, want):
            check(torch, f"fwd {n} vs plain {tag}", g, w, TOL_FWD, sink)
        d_w, gsq_w, gdot_w = ref.fusion_loss_ref_grads(
            stack, lab, av, c["d_fused"], c["d_modal"], dtype=dtype)
        f32 = dtype == torch.float32
        for m in range(M):
            check(torch, f"bwd dlogits[{m}] vs plain {tag}", dl[m],
                  d_w[m], TOL_BWD,
                  errs["fusion_loss_bwd"] if f32 else [])
        sink = errs["fusion_loss_reduce"] if f32 else []
        check(torch, f"reduce gsq vs plain {tag}", gsq, gsq_w.T,
              TOL_SUM, sink)
        check(torch, f"reduce gdot vs plain {tag}", gdot, gdot_w.T,
              TOL_SUM, sink)
    # the autograd Function: broadcast head folded back to [K, B, V]
    xs = [x.clone().requires_grad_() for x in lg]
    f_nll, m_nll = ops.FusionLoss.apply(c["seg"], lab, av, *xs)
    torch.autograd.backward((f_nll, m_nll), (c["d_fused"], c["d_modal"]))
    for m, (x, s) in enumerate(zip(xs, c["seg"])):
        # the Function casts the gradient to the operand's type
        want = dl[m] if not s else dl[m].reshape(K, -1, s, V).sum(2)
        check(torch, f"autograd grad[{m}] vs bwd kernel", x.grad,
              want.to(x.dtype), TOL_BWD, [])


# ---------------------------------------------------------------------------
# phase 2b: flash attention and the SSD chunk kernel against their plain
# versions
# ---------------------------------------------------------------------------
class Capture:
    """Records, per distinct operand shape (and attention window), the
    first operands the main path hands a front end (``module.name``) while
    the context is open."""

    def __init__(self, torch, module, name, label):
        self.torch, self.module, self.name = torch, module, name
        self.label = label
        self.seen = {}

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            key = tuple(tuple(a.shape) for a in args
                        if isinstance(a, self.torch.Tensor))
            if kw.get("window"):        # gemma3's local and global layers
                key += (("window", kw["window"]),)
            if key not in self.seen:
                self.seen[key] = dict(args=[self._clone(a) for a in args],
                                      kw=dict(kw), label=self.label)
            return self.orig(*args, **kw)

        setattr(self.module, self.name, wrapper)
        return self

    def _clone(self, a):
        """Tensors cloned, also inside a list or tuple (the fusion loss's
        logits)."""
        if isinstance(a, self.torch.Tensor):
            return a.detach().clone()
        if isinstance(a, (list, tuple)):
            return type(a)(self._clone(x) for x in a)
        return a

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def capture_backbone_operands(torch, exps):
    """The operands each backbone experiment's own forward passes hand the
    kernels: one cohort forward over the client stack and one eval forward
    over the test split."""
    from repro_torch.core.trees import tree_map
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    found = {"attn": {}, "ssd_chunk": {}, "ssd_forward": {}}
    for (arch, dataset), exp in exps.items():
        feats, _, _ = exp._get_stacked()
        K = exp.params.K
        stacked = {m: tree_map(lambda x: x.expand(K, *x.shape),
                               exp.global_params[m]) for m in feats}
        test = {m: torch.as_tensor(x, device=DEVICE)
                for m, x in exp.test_ds.features.items()}
        for where, run in (
                ("cohort", lambda: exp.adapter.modal_logits(stacked, feats)),
                ("eval", lambda: exp.adapter.eval_logits(exp.global_params,
                                                         test))):
            label = f"{arch}/{dataset}/{where}"
            caps = {"attn": Capture(torch, fa_ops, "flash_attention", label),
                    "ssd_chunk": Capture(torch, ssd_ops, "ssd_chunk", label),
                    "ssd_forward": Capture(torch, ssd_ops, "ssd_forward",
                                           label)}
            with torch.no_grad(), caps["attn"], caps["ssd_chunk"], \
                    caps["ssd_forward"]:
                run()
            for k, cap in caps.items():
                for key, rec in cap.seen.items():
                    found[k].setdefault(key, rec)
    return found


def attn_case(torch, q, k, v, window, label, dtype=None):
    """q [B,S,H,hd], k/v [B,S,KH,hd] on the card (the model's layout), with
    the regime the wrapper plans for them."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if dtype is not None:
        q, k, v = (t.to(dtype) for t in (q, k, v))
    B, S, H, hd = q.shape
    KH = k.shape[2]
    regime = fa_ops.plan(B, S, H, KH, hd, q.dtype,
                         fa_ops.aligned16((q, k, v), hd)).regime
    return dict(q=q, k=k, v=v, window=window, label=label, regime=regime,
                shape=f"B={B} S={S} H={H} KH={KH} hd={hd}"
                      + (f" window={window}" if window else "")
                      + ("" if q.dtype == torch.float32 else " bf16"))


def ssd_case(x, cum, Bm, Cm, label):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    B, nc, Q, nh, hp = x.shape
    N = Bm.shape[-1]
    return dict(x=x, cum=cum, Bm=Bm, Cm=Cm, label=label,
                regime=ssd_ops.plan(B, nc, Q, nh, hp, N).regime,
                shape=f"B={B} nc={nc} Q={Q} nh={nh} hp={hp} N={N}")


def backbone_cases(torch, found):
    """Attention and SSD cases: the main path's captured operands first,
    then the JAX sweep's shapes from a seeded generator on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    attn = [attn_case(torch, *rec["args"], rec["kw"].get("window"),
                      rec["label"]) for rec in found["attn"].values()]
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KH, S, hd, win in ATTN_SWEEP:
            q = torch.randn((B, H, S, hd), device=DEVICE, generator=g)
            k, v = (torch.randn((B, KH, S, hd), device=DEVICE, generator=g)
                    for _ in range(2))
            # the sweep's [B, H, S, hd] layout goes in as a strided view
            attn.append(attn_case(torch, q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), win, "jax-sweep", dtype))
    ssd = [ssd_case(*rec["args"], rec["label"])
           for rec in found["ssd_chunk"].values()]
    for B, nc, Q, nh, hp, N in SSD_SWEEP:
        x = torch.randn((B, nc, Q, nh, hp), device=DEVICE, generator=g)
        cum = torch.cumsum(-torch.rand((B, nc, Q, nh), device=DEVICE,
                                       generator=g) * 0.1, dim=2)
        Bm, Cm = (torch.randn((B, nc, Q, N), device=DEVICE, generator=g)
                  for _ in range(2))
        ssd.append(ssd_case(x, cum, Bm, Cm, "jax-sweep"))
    return attn, ssd


def backbone_kernel_phase(torch, found):
    """Flash attention and the SSD chunk kernel against their plain
    versions in float32 and float64 at every case; the autograd Functions
    against plain autograd at the main path's operands.  Returns the cases
    and the max abs error per kernel against the float32 plain version
    (float32 inputs)."""
    attn, ssd = backbone_cases(torch, found)
    errs = {"flash_attention_fwd": [], "ssd_chunk_fwd": []}
    backbone_checks(torch, attn, ssd, found, errs)
    return attn, ssd, {k: max(v) for k, v in errs.items()}


def backbone_checks(torch, attn, ssd, found, errs):
    """Flash attention and the SSD chunk kernel against their plain
    versions in float32 and float64 at the cases ``attn`` and ``ssd``; the
    autograd Functions against plain autograd at the operand records
    ``found``.  The float32 errors go into ``errs``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.models import layers, mamba2
    for c in attn:
        print(f"[kernels] flash_attention {c['label']}: {c['shape']} "
              f"({c['regime']} regime)")
        q, k, v, win = c["q"], c["k"], c["v"], c["window"]
        out = fa_ops.flash_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        f32 = q.dtype == torch.float32
        tol = TOL_ATTN if f32 else TOL_ATTN_BF16
        tq, tk, tv = (t.transpose(1, 2) for t in (q, k, v))
        for dtype in (None, torch.float64):
            want = fa_ref.attention_ref(tq, tk, tv, window=win,
                                        dtype=dtype).transpose(1, 2)
            tag = "f64" if dtype else "plain"
            check(torch, f"fwd vs {tag}", out.float(), want, tol,
                  errs["flash_attention_fwd"] if f32 and not dtype else [])
    for c in ssd:
        print(f"[kernels] ssd_chunk {c['label']}: {c['shape']} "
              f"({c['regime']} regime)")
        ins = (c["x"], c["cum"], c["Bm"], c["Cm"])
        y, st = ssd_ops.ssd_chunk(*ins)
        torch.cuda.synchronize()
        for dtype in (torch.float32, torch.float64):
            yw, sw = ssd_ref.ssd_chunk_ref(*ins, dtype=dtype)
            sink = errs["ssd_chunk_fwd"] if dtype == torch.float32 else []
            tag = "f32" if dtype == torch.float32 else "f64"
            check(torch, f"y_diag vs plain {tag}", y, yw, TOL_SSD, sink)
            check(torch, f"states vs plain {tag}", st, sw, TOL_SSD, sink)

    # the autograd Functions: kernel forward + recompute backward against
    # plain autograd, at every main-path operand set
    grads = [(rec, lambda *a, w=rec["kw"].get("window"):
              layers.pallas_attention(*a, w, a[0].shape[1]),
              lambda *a, w=rec["kw"].get("window"):
              layers.chunked_attention(*a, window=w, chunk=a[0].shape[1]),
              TOL_ATTN) for rec in found["attn"].values()]
    grads += [(rec, lambda *a, ch=rec["args"][5]: mamba2.ssd_pallas(
                   *a[:5], ch),
               lambda *a, ch=rec["args"][5]: mamba2.ssd_chunked(*a[:5], ch),
               TOL_SSD) for rec in found["ssd_forward"].values()]
    for rec, kern, plain, tol in grads:
        ins = [a for a in rec["args"] if isinstance(a, torch.Tensor)]
        outs = []
        for fn in (kern, plain):
            ts = [t.clone().requires_grad_() for t in ins]
            o = fn(*ts)
            cot = torch.randn(o.shape, device=DEVICE,
                              generator=torch.Generator(device=DEVICE)
                              .manual_seed(4))
            torch.autograd.backward(o, cot)
            outs.append((o.detach(), [t.grad for t in ts]))
        (o1, g1), (o2, g2) = outs
        name = "attention" if len(ins) == 3 else "ssd"
        shape = "x".join(map(str, ins[0].shape))
        check(torch, f"{name} autograd value {shape} ({rec['label']})", o1,
              o2, tol, [])
        for i, (a, b) in enumerate(zip(g1, g2)):
            check(torch, f"{name} autograd grad[{i}] vs plain autograd", a,
                  b, TOL_GRAD, [])


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def run_experiment(torch, exp, metric_keys, label, rounds):
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec = exp.run_round()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[main] {label} round {rec.round}: {dt * 1e3:.3f} ms "
              f"(sched {rec.sched_time_s * 1e3:.3f} ms) "
              f"part={rec.participants} fail={rec.failures} "
              f"E={rec.energy_total:.6f} J "
              f"acc={rec.metrics.get('multimodal', float('nan')):.4f} "
              f"loss={rec.metrics.get('loss', float('nan')):.4f}")
        if tuple(sorted(rec.metrics)) != tuple(sorted(
                metric_keys(exp.all_mods))):
            raise AssertionError(f"metrics {sorted(rec.metrics)} incomplete")
        if not all(math.isfinite(v) for v in rec.metrics.values()):
            raise AssertionError(f"non-finite metrics {rec.metrics}")
    from repro_torch.core.trees import tree_leaves
    for x in tree_leaves(exp.global_params):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("non-finite global params")


def profile_round(torch, exp, label):
    """One more round under ``torch.profiler``: the device's busy share of
    the round's wall time, the scheduler's share (JCSBA's solve on the card
    and its one read-back), and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec = exp.run_round()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats the time of the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda]
    if not events:
        print(f"[profile] {label}: the trace shows no device events: device "
              f"busy share not measured")
        return set()
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"[profile] {label} round {rec.round}: wall {wall_ms:.3f} ms, "
          f"scheduler {rec.sched_time_s * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.2%} of wall; idle "
          f"{1 - busy_ms / wall_ms:.2%}), {launches} device ops")
    for e in sorted(events, key=_device_us, reverse=True)[:8]:
        print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")
    return {e.key for e in events}


def twin_phase(torch, MFLExperiment, arch, dataset, rounds):
    """A small run on the card (kernels) against the same run on the CPU
    (plain versions): same participants, params within 1e-4."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.trees import tree_leaves
    kw = dict(K=4, n_samples=160, arch=arch)
    gpu = MFLExperiment(dataset, engine="batched:seq+pallas", **kw)
    cpu = MFLExperiment(dataset, engine="batched:seq", device="cpu", **kw)
    for _ in range(rounds):
        rg, rc = gpu.run_round(), cpu.run_round()
        if rg.participants != rc.participants:
            raise AssertionError(f"participants {rg.participants} (card) != "
                                 f"{rc.participants} (cpu)")
    a = tree_leaves(params_to_numpy(gpu.global_params))
    b = tree_leaves(params_to_numpy(cpu.global_params))
    err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    print(f"[main] {arch}/{dataset} twin run ({rounds} rounds) card/kernels "
          f"vs cpu/plain: participants equal, params max|err| {err:.3e} "
          f"(tol 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"{arch}/{dataset}: card and cpu twin runs "
                             f"disagree")


def remat_phase(torch, MFLExperiment, counters, arch):
    """One ``+remat`` round against the plain round on the same seed:
    same participants, params within 1e-6; prints both rounds' launches
    (under remat the cohort forward runs again in the backward)."""
    from repro_torch.core.trees import tree_leaves
    recs, params, counts = [], [], []
    for engine in (MAIN_KW["engine"], MAIN_KW["engine"] + "+remat"):
        exp = MFLExperiment("crema_d", arch=arch,
                            **dict(MAIN_KW, engine=engine))
        reset, read = counters
        reset()
        recs.append(exp.run_round())
        torch.cuda.synchronize()
        counts.append({k: v for k, v in read().items() if v})
        params.append(tree_leaves(exp.global_params))
    if recs[0].participants != recs[1].participants:
        raise AssertionError(f"{arch}: remat changed the participants")
    err = max(float((a - b).abs().max()) for a, b in zip(*params))
    print(f"[remat] {arch}/crema_d one round +remat vs plain: params "
          f"max|err| {err:.3e} (tol 1e-6); launches plain {counts[0]}, "
          f"remat {counts[1]}")
    if err > 1e-6:
        raise AssertionError(f"{arch}: the +remat round differs")


# ---------------------------------------------------------------------------
# phase 3: the schedulers — the host search's round, the baselines, and the
# JCSBA solve on the card against the plain solve on the CPU
# ---------------------------------------------------------------------------
def seq_round_phase(torch, MFLExperiment, exp_jax):
    """One CREMA-D round with the host ``seq`` search, beside the device
    solve's scheduler times of the main path's CREMA-D rounds."""
    exp = MFLExperiment("crema_d", **dict(MAIN_KW,
                                          engine="batched:seq+pallas"))
    rec = exp.run_round()
    torch.cuda.synchronize()
    dev = [r.sched_time_s * 1e3 for r in exp_jax.history]
    print(f"[sched] crema_d K=10 sched_time_s: batched:seq+pallas (host "
          f"immune search) {rec.sched_time_s * 1e3:.3f} ms; batched:pallas "
          f"(solver kernels on the card) "
          + ", ".join(f"{t:.3f}" for t in dev) + " ms")


def baseline_phase(torch, MFLExperiment, counters):
    """One CREMA-D round of each baseline scheduler (K=10, n=1200): every
    metric finite, the fusion-loss kernels launched, no solver kernel."""
    from repro_torch.fl.eval import metric_keys
    reset, read = counters
    for name in BASELINES:
        exp = MFLExperiment("crema_d", scheduler=name, **MAIN_KW)
        reset()
        run_experiment(torch, exp, metric_keys, f"{name}/crema_d", 1)
        now = read()
        rec = exp.history[-1]
        print(f"[sched] {name}/crema_d: participants {rec.participants}, "
              f"failures {rec.failures}, dropped {rec.dropped}, sched "
              f"{rec.sched_time_s * 1e3:.3f} ms, launches "
              f"{ {k: v for k, v in now.items() if v} }")
        if not (now["fusion_loss_fwd"] and now["fusion_loss_bwd"]):
            raise AssertionError(f"{name}: the fusion loss was not launched")
        if any(now[k] for k in SOLVER_KERNELS):
            raise AssertionError(f"{name}: a solver kernel was launched")


def cpu_draws(policy, seed):
    """A draw source on a CPU generator: the card run moves these bits to
    the card, so both twins schedule on the same bits."""
    import torch
    return policy.draws(torch.Generator().manual_seed(seed), "cpu")


def solver_twin_phase(torch, MFLExperiment, rounds=2):
    """JCSBA on the card's solver kernels against the plain solver on the
    CPU, on the same CPU-drawn bits (CREMA-D, K=4, n=160): participants
    equal, params within 1e-4."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.trees import tree_leaves
    kw = dict(K=4, n_samples=160, engine="batched:pallas",
              scheduler_kwargs={"draw_source": cpu_draws})
    gpu = MFLExperiment("crema_d", **kw)
    cpu = MFLExperiment("crema_d", device="cpu", **kw)
    for _ in range(rounds):
        rg, rc = gpu.run_round(), cpu.run_round()
        if rg.participants != rc.participants:
            raise AssertionError(f"jcsba twin: participants "
                                 f"{rg.participants} (card) != "
                                 f"{rc.participants} (cpu)")
    a = tree_leaves(params_to_numpy(gpu.global_params))
    b = tree_leaves(params_to_numpy(cpu.global_params))
    err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    print(f"[main] jcsba/crema_d twin run ({rounds} rounds, solver kernels "
          f"on the card vs plain solver on the cpu, same bits): "
          f"participants equal {[r.participants for r in gpu.history]}, "
          f"params max|err| {err:.3e} (tol 1e-4)")
    if err > 1e-4:
        raise AssertionError("jcsba twin runs disagree")


# ---------------------------------------------------------------------------
# phase 3a: the seq and fused loops
# ---------------------------------------------------------------------------
def _params_err(a, b):
    from repro_torch.core.trees import tree_leaves
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _timed_rounds(torch, exp, rounds):
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        exp.run_round()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def seq_phase(torch, MFLExperiment, counters):
    """Paper CREMA-D on ``seq:pallas`` against a ``batched:pallas`` twin
    (same seed, same draws): same participants, params within 1e-4, one
    fusion-loss forward and backward launch a participant.  Returns the
    seq run's launches."""
    reset, read = counters
    seq = MFLExperiment("crema_d", **dict(MAIN_KW, engine="seq:pallas"))
    bat = MFLExperiment("crema_d", **MAIN_KW)
    reset()
    t_seq = _timed_rounds(torch, seq, SEQ_ROUNDS)
    counts = read()
    t_bat = _timed_rounds(torch, bat, SEQ_ROUNDS)
    parts = [r.participants for r in seq.history]
    if parts != [r.participants for r in bat.history]:
        raise AssertionError(f"seq participants {parts} != batched "
                             f"{[r.participants for r in bat.history]}")
    err = _params_err(seq.global_params, bat.global_params)
    n = sum(len(p) for p in parts)
    print(f"[seq] crema_d K=10 n=1200 seq:pallas rounds "
          + ", ".join(f"{t:.3f}" for t in t_seq) + " ms; batched:pallas "
          + ", ".join(f"{t:.3f}" for t in t_bat) + f" ms; participants "
          f"{parts} (equal); params max|err| {err:.3e} (tol 1e-4); "
          f"launches {({k: v for k, v in counts.items() if v})} for {n} "
          f"participants")
    if err > 1e-4:
        raise AssertionError("seq and batched disagree")
    if not n or not (counts["fusion_loss_fwd"] == counts["fusion_loss_bwd"]
                     == n):
        raise AssertionError("seq: not one fusion-loss forward and backward "
                             "launch a participant")
    return counts


def graph_counts(eng, since=None):
    """Kernel launches of the fused runs: each graph's captured launches
    times its replays (since the replay counts ``since``, when given)."""
    out = {}
    for g, launched in eng.graph_launches.items():
        n = eng.replays[g] - (since or {}).get(g, 0)
        for k, v in launched.items():
            out[k] = out.get(k, 0) + v * n
    return out


def check_trace(names, kernels, label):
    """Every kernel in ``kernels`` by its trace name among ``names``."""
    missing = [k for k in kernels
               if not any(TRACE_NAMES[k] in n for n in names)]
    print(f"[fused] {label}: kernels in the profiled replay's trace: "
          + ", ".join(k for k in kernels if k not in missing)
          + (f"; MISSING {missing}" if missing else ""))
    if missing:
        raise AssertionError(f"{label}: {missing} not in the trace")


def fused_phase(torch, MFLExperiment, counters):
    """Paper CREMA-D on ``fused:pallas``: 8 rounds stepwise (graph
    replays) and 8 through ``run_scanned``, both against the body run
    eagerly on the card on the same inputs; then a profiled round whose
    trace must show the path's kernels.  Returns the launches (captured
    times replays)."""
    from repro_torch.fl.fused_round import draw_round_xs, tree_row
    reset, read = counters
    reset()
    step = MFLExperiment("crema_d", **FUSED_KW)
    t_step = _timed_rounds(torch, step, FUSED_ROUNDS)
    py = read()
    eng = step._fused_engine
    counts = graph_counts(eng)
    # a scan of the first two rounds captures both graphs; the rest is
    # timed
    scan = MFLExperiment("crema_d", **FUSED_KW)
    scan.run_scanned(2)
    t0 = time.perf_counter()
    scan.run_scanned(FUSED_ROUNDS - 2)
    torch.cuda.synchronize()
    t_scan = (time.perf_counter() - t0) * 1e3
    # the body eagerly on the card, on the same inputs
    eag = MFLExperiment("crema_d", **FUSED_KW)
    e_eng = eag._get_fused_engine()
    xs = draw_round_xs(eag, FUSED_ROUNDS)
    c, parts = eag._carry, []
    t0 = time.perf_counter()
    for i in range(FUSED_ROUNDS):
        c, aux = e_eng.step_eager(c, tree_row(xs, i))
        parts.append(sorted(int(k) for k in torch.nonzero(aux.ok)))
    torch.cuda.synchronize()
    t_eager = (time.perf_counter() - t0) * 1e3 / FUSED_ROUNDS
    for label, exp in (("stepwise", step), ("run_scanned", scan)):
        got = [r.participants for r in exp.history]
        err = _params_err(exp.global_params, c.params)
        print(f"[fused] crema_d {label} ({FUSED_ROUNDS} rounds, graph "
              f"replays) vs the eager body on the card: participants "
              f"{'equal' if got == parts else f'{got} != {parts}'}, "
              f"params max|err| {err:.3e} (tol 1e-4)")
        if got != parts or err > 1e-4:
            raise AssertionError(f"fused {label} disagrees with the eager "
                                 f"body")
    caps = {("eval" if g else "no eval"): round(v, 3)
            for g, v in eng.capture_seconds.items()}
    print(f"[fused] crema_d K=10 n=1200 fused:pallas rounds (stepwise; "
          f"rounds 0 and 1 capture the eval and no-eval graphs) "
          + ", ".join(f"{t:.3f}" for t in t_step) + f" ms; after capture "
          f"mean {np.mean(t_step[2:]):.3f} ms; run_scanned("
          f"{FUSED_ROUNDS - 2}) after a run_scanned(2) that captures "
          f"{t_scan:.3f} ms ({t_scan / (FUSED_ROUNDS - 2):.3f} ms a round); "
          f"eager "
          f"body {t_eager:.3f} ms a round; capture s {caps}; captures "
          f"{eng.capture_count}, replays "
          f"{ {('eval' if g else 'no eval'): n for g, n in eng.replays.items()} }")
    print(f"[fused] crema_d launches: captured a graph "
          f"{ {('eval' if g else 'no eval'): v for g, v in eng.graph_launches.items()} }"
          f"; captured x replays {counts}; the wrappers' own counts "
          f"(warm-up and capture) {({k: v for k, v in py.items() if v})}")
    if eng.capture_count != 2:
        raise AssertionError(f"{eng.capture_count} captures, expected 2")
    # one more step, its device span from CUDA events around it (the xs
    # copies and the replay; no profiler), beside its host wall time
    x = tree_row(draw_round_xs(step, 1), 0)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    step._carry, _ = eng.step(step._carry, x)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    span = start.elapsed_time(end)
    print(f"[fused] crema_d one step (eval {bool(x.eval_flag)}): device "
          f"span {span:.3f} ms (CUDA events), host wall {wall:.3f} ms; the "
          f"device idles at least {1 - span / wall:.2%} of the step")
    for name in ARCH_KERNELS["lstm-cnn"]:
        if not counts.get(name):
            raise AssertionError(f"{name} was not launched by the fused "
                                 f"round")
    names = profile_round(torch, step, "fused:pallas lstm-cnn/crema_d")
    check_trace(names, ARCH_KERNELS["lstm-cnn"], "lstm-cnn/crema_d")
    return counts


def fused_backbone_phase(torch, MFLExperiment, arch):
    """Two fused rounds with a backbone at full width (K=10, n=1200): the
    mixer kernel runs inside the graphs; a profiled round's trace shows
    it.  Returns the launches (captured times replays)."""
    exp = MFLExperiment("crema_d", arch=arch, **FUSED_KW)
    times = _timed_rounds(torch, exp, 2)
    eng = exp._fused_engine
    counts = graph_counts(eng)
    rec = exp.history[-1]
    print(f"[fused] {arch}/crema_d rounds (capture included) "
          + ", ".join(f"{t:.3f}" for t in times) + f" ms; capture s "
          f"{ {('eval' if g else 'no eval'): round(v, 3) for g, v in eng.capture_seconds.items()} }"
          f"; launches captured x replays {counts}; participants "
          f"{[r.participants for r in exp.history]}")
    for name in ARCH_KERNELS[arch]:
        if not counts.get(name):
            raise AssertionError(f"{name} was not launched by the fused "
                                 f"{arch} round")
    names = profile_round(torch, exp, f"fused:pallas {arch}/crema_d")
    check_trace(names, ARCH_KERNELS[arch], f"{arch}/crema_d")
    if not all(math.isfinite(v) for v in rec.metrics.values()):
        raise AssertionError(f"{arch}: non-finite fused metrics")
    return counts


def fused_twin_phase(torch, MFLExperiment, rounds=2):
    """The fused body run eagerly on the card against the CPU's fused run
    on the same CPU-drawn bits (CREMA-D, K=4, n=160): participants equal,
    params within 1e-4."""
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.trees import tree_leaves
    from repro_torch.fl.fused_round import draw_round_xs, tree_row
    kw = dict(K=4, n_samples=160, engine="fused:pallas",
              scheduler_kwargs={"draw_source": cpu_draws})
    gpu = MFLExperiment("crema_d", **kw)
    eng = gpu._get_fused_engine()
    xs = draw_round_xs(gpu, rounds)
    c, parts = gpu._carry, []
    for i in range(rounds):
        c, aux = eng.step_eager(c, tree_row(xs, i))
        parts.append(sorted(int(k) for k in torch.nonzero(aux.ok)))
    cpu = MFLExperiment("crema_d", device="cpu", **kw)
    cpu.run(rounds)
    want = [r.participants for r in cpu.history]
    err = max(float(np.abs(x - y).max()) for x, y in zip(
        tree_leaves(params_to_numpy(c.params)),
        tree_leaves(params_to_numpy(cpu.global_params))))
    print(f"[fused] crema_d eager body on the card vs the cpu ({rounds} "
          f"rounds, same cpu-drawn bits): participants {parts} "
          f"{'equal' if parts == want else f'!= {want}'}, params max|err| "
          f"{err:.3e} (tol 1e-4)")
    if parts != want or err > 1e-4:
        raise AssertionError("fused card and cpu twin runs disagree")


# ---------------------------------------------------------------------------
# phase 3c: the scenario axis — grids over the fused round
# ---------------------------------------------------------------------------
def zoo_specs(arch="lstm-cnn", rows=None):
    """The zoo's specs (seed i for row i, as ``default_zoo``)."""
    from repro_torch.data.scenarios import ScenarioSpec
    return [ScenarioSpec(seed=i, arch=arch, **ZOO_GEOM, **r)
            for i, r in enumerate(ZOO_ROWS if rows is None else rows)]


def zoo_grid(specs):
    """(stacked grid, params, stores/test_sets kwargs) under the JAX zoo
    benchmark's wireless parameters (``benchmarks/scenario_zoo.py:
    run_zoo``: B_max = 1 MHz a client, E_add = 2e-4)."""
    from repro_torch.data.scenarios import stack_scenarios
    from repro_torch.wireless.params import WirelessParams
    K = specs[0].K
    params = WirelessParams(K=K, B_max=1e6 * K, E_add=2e-4)
    grid = stack_scenarios(specs, params)
    return grid, params, dict(
        stores=grid.stores,
        test_sets=(grid.test_features, grid.test_labels))


def zoo_engine(specs, rounds, device=None, draw_source=None):
    """The JAX zoo benchmark's set-up in the port: the stacked grid, a
    ``from_store`` engine on row 0's store with JCSBA (J = K) and the
    kernels on its path (the ``pallas`` engine token), the grid's xs;
    returns (grid, engine, xs, stores/test_sets kwargs)."""
    from repro_torch.fl.client import make_adapter
    from repro_torch.fl.fused_round import (FusedRoundEngine,
                                            draw_population_xs)
    from repro_torch.wireless.channel import Channel
    from repro_torch.wireless.policies import JCSBAPolicy
    grid, params, kw = zoo_grid(specs)
    device = device or DEVICE
    K = params.K
    pol = JCSBAPolicy(K, max_cohort=K)
    eng = FusedRoundEngine.from_store(
        grid.store_row(0), params, pol,
        make_adapter(specs[0].dataset, specs[0].arch, loss_backend="pallas",
                     use_kernels=True), device=device)
    rng = np.random.default_rng(1)
    xs = draw_population_xs(Channel(params, rng), rng, K, rounds,
                            eval_every=ZOO_EVAL, include_final=True,
                            policy=pol, device=device,
                            draw_source=draw_source)
    return grid, eng, xs, kw


def _graph_label(key):
    return {True: "eval", False: "no eval", "grid": "grid eval"}[key]


class GridOperands:
    """Records, per distinct shape, the operands a grid's eager warm-up
    (the body run before each graph's capture) hands the kernel wrappers
    into ``found`` — the fusion backward (which also carries the
    forward's operands), attention, the SSD chunk and the SSD forward —
    for ``grid_kernel_phase`` to hold against the plain versions."""

    def __init__(self, torch, found, label):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.fusion_loss import ops as fl_ops
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        self.found = found
        self.caps = {
            "fusion_bwd": Capture(torch, fl_ops, "fusion_loss_bwd", label),
            "attn": Capture(torch, fa_ops, "flash_attention", label),
            "ssd_chunk": Capture(torch, ssd_ops, "ssd_chunk", label),
            "ssd_forward": Capture(torch, ssd_ops, "ssd_forward", label)}

    def __enter__(self):
        for c in self.caps.values():
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for k, c in self.caps.items():
            c.__exit__(*exc)
            for key, rec in c.seen.items():
                self.found.setdefault(k, {}).setdefault(key, rec)


def _capture_grid(torch, eng, grid, xs, found, label):
    """A 1-row grid of the first two rounds that captures their graphs
    (round 0 evaluates on the grid's split; round 1 is the no-eval graph
    unless it is also the final round), the warm-up's operands recorded
    into ``found``."""
    from repro_torch.core.trees import tree_map
    with GridOperands(torch, found, label):
        eng.scan_scenario_grid(
            {k: v[:1] for k, v in grid.overrides.items()}, eng.fresh_carry(),
            tree_map(lambda x: x[:2], xs),
            stores=grid.stores.row(slice(0, 1)),
            test_sets=({m: x[:1] for m, x in grid.test_features.items()},
                       grid.test_labels[:1]))
    torch.cuda.synchronize()


def _run_launches(eng, since, read, label):
    """(launches, replays) of one grid run after its graphs were captured:
    each graph's captured launches times its replays in that run
    (``since``: the replay counts before it).  The wrappers' own counts,
    set to 0 just before the run, must be 0: nothing launched outside the
    graphs."""
    outside = {k: v for k, v in read().items() if v}
    if outside:
        raise AssertionError(f"{label}: launches outside the graphs "
                             f"{outside}")
    return graph_counts(eng, since), {
        _graph_label(g): n - since.get(g, 0) for g, n in eng.replays.items()}


def _grid_times(torch, label, run, S, R):
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    print(f"[scenario] {label}: {S} rows x {R} rounds in {wall:.3f} ms "
          f"({wall / (S * R):.3f} ms a scenario-round)")
    return out, wall


def _rows_err(c, a, carries, auxs, s):
    """(participants equal, params max|err|) of grid row ``s`` against a
    reference run of that row (carry ``c``, aux ``a``; any device)."""
    from repro_torch.core.trees import tree_leaves
    same = all(bool((x.cpu() == y[s].cpu()).all())
               for x, y in ((a.ok, auxs.ok), (a.a, auxs.a)))
    err = max(float((x.cpu() - y[s].cpu()).abs().max())
              for x, y in zip(tree_leaves(c.params),
                              tree_leaves(carries.params)))
    return same, err


def zoo_phase(torch, counters, found):
    """The JAX benchmark's 12-row zoo (iemocap, K=10, 120 samples a
    client, 128 test samples, 30 rounds, eval every 5): one
    ``scan_scenario_grid`` with per-scenario stores and test splits,
    after a 1-row 2-round grid that captures the two graphs (its warm-up's
    kernel operands recorded into ``found``); 2 rows x 3 rounds replayed
    against the body run eagerly on the card and against the CPU on
    CPU-drawn bits; the swap's device time.  Returns the launches of the
    timed zoo run (captured times its replays)."""
    from repro_torch.core.trees import tree_leaves, tree_map
    from repro_torch.fl.fused_round import tree_row
    reset, read = counters
    specs = zoo_specs()
    grid, eng, xs, kw = zoo_engine(specs, ZOO_ROUNDS)
    S, R = grid.n, ZOO_ROUNDS
    _capture_grid(torch, eng, grid, xs, found, "lstm-cnn zoo")
    caps = {_graph_label(g): round(v, 3)
            for g, v in eng.capture_seconds.items()}
    reset()
    since = dict(eng.replays)
    (carries, auxs), wall = _grid_times(
        torch, "zoo (iemocap K=10 n=1200 JCSBA, graphs captured)",
        lambda: eng.scan_scenario_grid(grid.overrides, eng.fresh_carry(),
                                       xs, **kw), S, R)
    counts, replays = _run_launches(eng, since, read, "zoo")
    ok = auxs.ok.cpu().numpy()
    emask = auxs.eval_mask.cpu().numpy()
    mm = auxs.metrics["multimodal"].cpu().numpy()
    spent = carries.spent.sum(-1).cpu().numpy()
    print(f"[scenario] zoo: captures {eng.capture_count} for the whole zoo "
          f"(by the 1-row 2-round grid before it; capture s {caps}); the "
          f"timed run's replays {replays}; launches a graph "
          f"{ {_graph_label(g): v for g, v in eng.graph_launches.items()} }"
          f"; the timed run's launches (captured x its replays) {counts}; "
          f"none outside the graphs")
    for s, spec in enumerate(grid.specs):
        print(f"[scenario] zoo row {s:2d} {spec.label():24s} final "
              f"multimodal {mm[s, -1]:.4f} (eval rounds "
              f"{np.flatnonzero(emask[s]).tolist()}), mean participants "
              f"{ok[s].sum(-1).mean():.2f}, energy {spent[s]:.6f} J")
    if eng.capture_count != 2:
        raise AssertionError(f"zoo: {eng.capture_count} captures, "
                             f"expected 2")
    if not (emask[:, -1].all() and np.isfinite(mm[emask]).all()):
        raise AssertionError("zoo: a final or flagged metric is missing")
    if len({tuple(r.sum(-1)) for r in ok}) < 2:
        raise AssertionError("zoo: every row scheduled alike")
    for k in ARCH_KERNELS["lstm-cnn"]:
        if not counts.get(k):
            raise AssertionError(f"zoo: {k} was not launched")
    # 2 rows x 3 rounds: the replays against the body run eagerly
    two = zoo_specs(rows=ZOO_ROWS[:2])
    g2, _, kw2 = zoo_grid(two)
    xs3 = tree_map(lambda x: x[:3], xs)
    c2, a2 = eng.scan_scenario_grid(g2.overrides, eng.fresh_carry(), xs3,
                                    **kw2)
    for s in range(2):
        ovr, store, test = eng._grid_row(g2.overrides, s, **kw2)
        c, a = eng._scan_one_scenario(ovr, store, test, eng.fresh_carry(),
                                      xs3)
        same, err = _rows_err(c, a, c2, a2, s)
        print(f"[scenario] zoo row {s} (3 rounds, graph replays) vs the "
              f"eager body on the card: participants "
              f"{'equal' if same else 'DIFFER'}, params max|err| {err:.3e} "
              f"(tol 1e-4)")
        if not same or err > 1e-4:
            raise AssertionError("zoo replays disagree with the eager body")
    # the same 2 rows x 3 rounds on the card and on the CPU, CPU-drawn bits
    gg, ge, gxs, gkw = zoo_engine(two, 3, draw_source=cpu_draws)
    cg, ag = ge.scan_scenario_grid(gg.overrides, ge.fresh_carry(), gxs,
                                   **gkw)
    cgrid, ceng, cxs, ckw = zoo_engine(two, 3, device="cpu",
                                       draw_source=cpu_draws)
    cc, ac = ceng.scan_scenario_grid(cgrid.overrides, ceng.fresh_carry(),
                                     cxs, **ckw)
    for s in range(2):
        same, err = _rows_err(tree_row(cc, s), tree_row(ac, s), cg, ag, s)
        print(f"[scenario] zoo row {s} (3 rounds) on the card vs the cpu, "
              f"same cpu-drawn bits: participants "
              f"{'equal' if same else 'DIFFER'}, params max|err| {err:.3e} "
              f"(tol 1e-4)")
        if not same or err > 1e-4:
            raise AssertionError("zoo card and cpu runs disagree")
    # the swap: one scenario's rows into the static buffers
    ovr, stores, tests, _ = eng._grid_inputs(grid.overrides, **kw)
    keep = [(t, t.clone()) for t in
            [eng._solver_tmpl[k] for k in ovr] + eng._store.leaves()]
    nbytes = sum(v[0].numel() * v.element_size() for v in ovr.values()) \
        + sum(x[0].numel() * x.element_size() for x in stores.leaves()) \
        + sum(x[0].numel() * x.element_size()
              for x in tree_leaves(tests[0]) + [tests[1]])
    swap = time_ms(torch, lambda: eng._swap_in(ovr, stores, tests, 3),
                   iters=50, warmup=5)
    swap_dev = device_ms(torch, lambda: eng._swap_in(ovr, stores, tests, 3),
                         iters=20)
    for t, v in keep:
        t.copy_(v)
    per = wall / (S * R)
    print(f"[scenario] swap of one scenario ({nbytes / 1e6:.3f} MB: "
          f"overrides, store, test split): {swap:.6f} ms (CUDA events, "
          f"host enqueue included), device "
          + ("not measured" if swap_dev is None else f"{swap_dev:.6f} ms")
          + f"; {swap / (per * R):.4%} of a scenario's {R} rounds "
          f"({per * R:.3f} ms)")
    return counts


def v_grid_phase(torch, MFLExperiment, counters, found):
    """The dense V grid (``benchmarks/v_frontier.py:DENSE_V_GRID``) over
    paper IEMOCAP, K=10, n=1200, E_add = 2e-4 (the Q>0 branch), 40 rounds,
    eval every 5, through ``scan_v_grid`` after a 1-V 2-round grid that
    captures the two graphs (its warm-up's operands recorded into
    ``found``); the Q>0 population kernel's device ms a round, from a
    profiled 1-V run.  Returns the launches of the timed V-grid run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.trees import tree_map
    from repro_torch.fl.fused_round import draw_round_xs
    from repro_torch.wireless.params import WirelessParams
    exp = MFLExperiment("iemocap", K=10, n_samples=1200,
                        engine="fused:pallas", eval_every=ZOO_EVAL,
                        params=WirelessParams(K=10, B_max=1e7, E_add=2e-4))
    eng = exp._get_fused_engine()
    R = V_ROUNDS
    xs = draw_round_xs(exp, R, include_final=True)
    reset, read = counters
    with GridOperands(torch, found, "lstm-cnn V grid"):
        eng.scan_v_grid(DENSE_V_GRID[:1], exp._carry,
                        tree_map(lambda x: x[:2], xs))
    torch.cuda.synchronize()
    reset()
    since = dict(eng.replays)
    (carries, auxs), wall = _grid_times(
        torch, "V grid (iemocap K=10 n=1200 JCSBA E_add=2e-4, graphs "
               "captured)",
        lambda: eng.scan_v_grid(DENSE_V_GRID, exp._carry, xs),
        len(DENSE_V_GRID), R)
    counts, replays = _run_launches(eng, since, read, "V grid")
    ok = auxs.ok.cpu().numpy()
    mm = auxs.metrics["multimodal"].cpu().numpy()
    spent = carries.spent.sum(-1).cpu().numpy()
    qmax = carries.Q.amax(-1).cpu().numpy()
    parts = ok.sum((1, 2))
    for i, V in enumerate(DENSE_V_GRID):
        print(f"[scenario] V={V:<8g} final multimodal {mm[i, -1]:.4f}, "
              f"participants {int(parts[i])} over {R} rounds, energy "
              f"{spent[i]:.6f} J, max Q {qmax[i]:.6f}")
    print(f"[scenario] V grid: distinct participant counts across V "
          f"{sorted(set(int(p) for p in parts))}; captures "
          f"{eng.capture_count} (by the 1-V 2-round grid before it); the "
          f"timed run's replays {replays}, launches (captured x its "
          f"replays) {counts}; none outside the graphs")
    if eng.capture_count != 2 or not np.isfinite(mm[:, -1]).all():
        raise AssertionError("V grid: captures or final metrics wrong")
    if not (qmax > 0).any():
        raise AssertionError("V grid: the queues never grew (no Q>0 round)")
    # the population kernel's device time in a V-grid round: one V's 40
    # rounds profiled (its queues grow as the grid's do)
    V1 = DENSE_V_GRID[len(DENSE_V_GRID) // 2]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.scan_v_grid([V1], exp._carry, xs)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) == cuda]
    busy = sum(_device_us(e) for e in ev) / 1e3
    pop = [e for e in ev if "jcsba_population_kernel" in e.key]
    if not ev or not pop:
        print("[scenario] V grid profile: no device events; the population "
              "kernel's share not measured")
    else:
        pop_ms = sum(_device_us(e) for e in pop) / 1e3
        n = sum(e.count for e in pop)
        # launch by launch: the Q>0 branch (the κ/φ⁻¹ bisections) takes
        # tens of µs where the closed-form branches take a few
        durs = [e.time_range.elapsed_us() for e in prof.events()
                if "jcsba_population_kernel" in e.name
                and getattr(e, "device_type", None) == cuda
                and hasattr(e, "time_range")]
        slow = [d for d in durs if d > Q_BRANCH_US]
        split = (f"; {len(slow)} of {len(durs)} launches over "
                 f"{Q_BRANCH_US} µs (the Q>0 branch): "
                 f"{sum(slow) / 1e3 / R:.3f} ms a round, "
                 f"{sum(slow) / 1e3 / busy:.2%} of the busy time"
                 if len(durs) == n else "; per-launch split not measured")
        print(f"[scenario] V={V1:g} ({R} rounds, profiled): device busy "
              f"{busy / R:.3f} ms a round; population kernel {n} launches, "
              f"{pop_ms / R:.3f} ms a round ({pop_ms / busy:.2%} of the "
              f"busy time; {pop_ms / n:.6f} ms a launch){split}")
    return counts


def grid_v_graph_phase(torch):
    """The population kernel with V read from the device: one captured
    launch at the main path's shape (K=10, P=20 rows, queues > 0)
    replayed at two V copied into its V tensor, each against the plain
    version at that V.  Returns the max abs J error."""
    from repro_torch.kernels.jcsba_solver import ops, ref
    from repro_torch.kernels.jcsba_solver.checks import (antibody_rows,
                                                         synthetic_round)
    from repro_torch.wireless.solver import SolverHyper, torchsolver
    hp = SolverHyper()
    d = torchsolver.to_device(synthetic_round(10, 3), DEVICE)
    A = torch.as_tensor(antibody_rows(10, 20, 7), device=DEVICE)
    bm, ok = ref.bmin(d["gamma"], d["h"], d["tau_rem"], d["B_max"],
                      d["p_tx"], d["N0"], hp)
    ops.population_objective(A, bm, ok, d, hp)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        J, _, feas = ops.population_objective(A, bm, ok, d, hp)
    errs, seen = [], []
    for V in (0.5, 40.0):
        d["V"].fill_(V)
        g.replay()
        J_w, _, feas_w = ref.population_objective(A, bm, ok, d, hp)
        torch.cuda.synchronize()
        if not torch.equal(feas, feas_w):
            raise AssertionError(f"V={V}: feasibility differs from plain")
        fin = torch.isfinite(J_w)
        check(torch, f"captured population kernel, V={V} (device) J",
              J[fin], J_w[fin], TOL_SOLVER_J, errs)
        seen.append(J[fin].clone())
    if torch.equal(seen[0], seen[1]):
        raise AssertionError("the replays at two V gave one J")
    print(f"[scenario] population kernel in one captured graph at V = 0.5 "
          f"and 40 (device V, K=10, P=20, Q>0): J max|err| {max(errs):.3e} "
          f"(tol rtol {TOL_SOLVER_J['rtol']:g}, atol "
          f"{TOL_SOLVER_J['atol']:g})")
    return max(errs)


def arch_grid_phase(torch, arch, counters, found):
    """A 2-row grid on a backbone at full width (the JAX FL encoder
    presets), 2 rounds (both evaluate: the first of the cadence and the
    final), after a 1-row grid that captures the grid-eval graph (its
    warm-up's operands recorded into ``found``): finite final
    metrics, the mixer kernel launched in the replays.  Returns the
    launches of the timed 2-row run."""
    reset, read = counters
    specs = zoo_specs(arch, ZOO_ROWS[:2])
    grid, eng, xs, kw = zoo_engine(specs, 2)
    _capture_grid(torch, eng, grid, xs, found, f"{arch} grid")
    captured = eng.capture_count
    reset()
    since = dict(eng.replays)
    (carries, auxs), _ = _grid_times(
        torch, f"{arch} grid (graphs captured)",
        lambda: eng.scan_scenario_grid(grid.overrides, eng.fresh_carry(),
                                       xs, **kw), 2, 2)
    counts, replays = _run_launches(eng, since, read, f"{arch} grid")
    mm = auxs.metrics["multimodal"][:, -1].cpu().numpy()
    print(f"[scenario] {arch} grid: final multimodal {mm.tolist()}, "
          f"participants {auxs.ok.sum((1, 2)).tolist()}, captures "
          f"{eng.capture_count}; the timed run's replays {replays}, "
          f"launches (captured x its replays) {counts}; none outside the "
          f"graphs")
    if eng.capture_count != captured or not np.isfinite(mm).all():
        raise AssertionError(f"{arch} grid: the timed run captured, or a "
                             f"final metric is not finite")
    for k in ARCH_KERNELS[arch]:
        if not counts.get(k):
            raise AssertionError(f"{arch} grid: {k} was not launched")
    return counts


def grid_kernel_phase(torch, ops, ref, found, tag="grid"):
    """The kernels against their plain versions at the operands the grids'
    warm-ups handed them (``GridOperands``): the fusion loss at each
    grid's cohort shape (the zoo's T=120 leaves each client a 24-row tail
    block in the rows regime), attention and the SSD chunk at the backbone
    grids' cohort and eval shapes, the autograd Functions at their
    operands; the same at the examples' operands with ``tag="examples"``.
    Returns (fusion cases, attention cases, SSD cases, max abs error per
    kernel against the float32 plain version)."""
    errs = {k: [] for k in ("fusion_loss_fwd", "fusion_loss_bwd",
                            "fusion_loss_reduce", "flash_attention_fwd",
                            "ssd_chunk_fwd")}
    cases = {}
    for rec in found.get("fusion_bwd", {}).values():
        lg, lab, av, df, dm = rec["args"][:5]
        K, T = lab.shape
        label = f"{tag} {rec['label']}"
        cases[label] = dict(logits=list(lg), labels=lab, avail=av,
                            d_fused=df, d_modal=dm,
                            seg=tuple(rec["args"][7]),
                            shape=(K, T, lg[0].shape[-1], len(lg)))
        fusion_check(torch, ops, ref, label, cases[label], errs)
    attn = [attn_case(torch, *rec["args"], rec["kw"].get("window"),
                      f"{tag} {rec['label']}")
            for rec in found.get("attn", {}).values()]
    ssd = [ssd_case(*rec["args"], f"{tag} {rec['label']}")
           for rec in found.get("ssd_chunk", {}).values()]
    backbone_checks(torch, attn, ssd,
                    {k: found.get(k, {}) for k in ("attn", "ssd_forward")},
                    errs)
    empty = [k for k, v in errs.items() if not v]
    if empty:
        raise AssertionError(f"{tag}: no operands recorded for {empty}")
    return cases, attn, ssd, {k: max(v) for k, v in errs.items()}


# ---------------------------------------------------------------------------
# phase 5: serving — the LM decode stack at full width
# ---------------------------------------------------------------------------
def _serve_args(arch, B, prompt, gen, *extra):
    from repro_torch.launch import serve
    return serve.build_parser().parse_args(
        ["--arch", arch, "--batch", str(B), "--prompt-len", str(prompt),
         "--gen-len", str(gen), "--device", DEVICE, *extra])


def profile_fn(torch, fn, label, top=6, share=None):
    """One call of ``fn`` under ``torch.profiler``: wall, device busy
    (idle) and device ops, the kernels that take the device time and,
    with ``share``, the part of the busy time in kernels whose names hold
    it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda]
    if not events:
        print(f"[profile] {label}: the trace shows no device events: device "
              f"busy share not measured")
        return None
    busy = sum(_device_us(e) for e in events) / 1e3
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms (idle {1 - busy / wall_ms:.2%}), "
          f"{sum(e.count for e in events)} device ops")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        print(f"[profile]   {_device_us(e) / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:90]}")
    if share:
        part = [e for e in events if share in e.key]
        ms = sum(_device_us(e) for e in part) / 1e3
        print(f"[profile]   {share}*: {ms:.3f} ms in "
              f"{sum(e.count for e in part)} launches, {ms / busy:.2%} of "
              f"the device busy time")
    return busy


def serve_phase(torch, counters, found):
    """``launch.serve.serve`` at full width for each of ``SERVE_RUNS``: a
    short warm-up call (which records the kernels' operands into
    ``found``), then the measured call with the counters set to 0 just
    before it and read after; the bulk prefill must launch its kernel
    once a mixer layer.  Returns the launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import serve
    reset, read = counters
    total = {}
    for arch, B, prompt, gen in SERVE_RUNS:
        t0 = time.perf_counter()
        caps = [Capture(torch, fa_ops, "flash_attention", f"serve {arch}"),
                Capture(torch, ssd_ops, "ssd_chunk", f"serve {arch}")]
        with caps[0], caps[1]:
            serve.serve(_serve_args(arch, B, prompt, 2))
        for key, cap in zip(("attn", "ssd_chunk"), caps):
            for shape, rec in cap.seen.items():
                found.setdefault(key, {}).setdefault(shape, rec)
        torch.cuda.empty_cache()
        stats = {}
        reset()
        out = serve.serve(_serve_args(arch, B, prompt, gen), stats)
        now = read()
        cfg = stats["cfg"]
        # every layer (whisper: every decoder layer) has the mixer whose
        # kernel the prefill launches
        n_mix = cfg.n_layers
        kern = SERVE_KERNEL[arch]
        ok = (tuple(out.shape) == (B, gen) and int(out.min()) >= 0
              and int(out.max()) < cfg.vocab_size)
        print(f"[serve] {arch}: B={B} prompt={prompt} generated={gen} "
              f"({cfg.dtype}, {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}): "
              f"bulk prefill {stats['prefill_ms']:.3f} ms; decode "
              f"{stats['decode_p50_ms']:.4f} ms/step median, "
              f"{stats['decode_p99_ms']:.4f} p99 over "
              f"{len(stats['decode_ms'])} graph replays; "
              f"{stats['tok_s']:.1f} tok/s as the [serve] line counts, "
              f"{stats['decode_tok_s']:.1f} decode-only; peak "
              f"{stats['peak_bytes'] / 2 ** 30:.3f} GiB; captures "
              f"{stats['captures']}; launches {({k: v for k, v in now.items() if v})}; "
              f"{time.perf_counter() - t0:.3f} s")
        if not ok or now[kern] != n_mix or stats["captures"] != 1:
            raise AssertionError(f"serve {arch}: tokens {tuple(out.shape)}, "
                                 f"{kern} launched {now[kern]} times for "
                                 f"{n_mix} mixer layers, "
                                 f"{stats['captures']} captures")
        for k, v in now.items():
            total[k] = total.get(k, 0) + v
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return total


def _rel(a, b):
    """max|a - b| over max(1, max|b|), in float32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _rel_max(a, b):
    """max|a - b| over max|b|: the error relative to the largest value."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / float(b.abs().max())


def serve_twin_phase(torch):
    """Reduced f32 qwen3-0.6b and mamba2-370m on the card (kernels,
    graph decode) against the CPU (plain versions) on the same params and
    prompts: next tokens identical, logits and every cache leaf within
    1e-4 of max(1, the CPU's largest magnitude), over the bulk prefill and
    ``GRAPH_STEPS`` decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.core.trees import tree_leaves, tree_map
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    for arch in ("qwen3-0.6b", "mamba2-370m"):
        cfg = get_config(arch).reduced()
        params = steps.init_fn(cfg)(torch.Generator().manual_seed(0))
        tokens = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (TWIN_B, TWIN_S)))
        runs = {}
        for dev in (DEVICE, "cpu"):
            p = tree_map(lambda t: t.to(dev), params)
            cache = T.init_cache(cfg, TWIN_B, TWIN_S + GRAPH_STEPS,
                                 torch.float32, dev)
            logits, cache = T.prefill_with_cache(p, tokens.to(dev), cache,
                                                 cfg)
            lgs, toks = [logits], [logits.argmax(-1)]
            for i in range(GRAPH_STEPS):
                lg, cache = T.decode_step(p, cache, toks[-1][:, None],
                                          TWIN_S + i, cfg)
                lgs.append(lg[:, 0])
                toks.append(lg[:, 0].argmax(-1))
            runs[dev] = ([t.cpu() for t in lgs], [t.cpu() for t in toks],
                         [t.cpu() for t in tree_leaves(cache)])
        (lg_g, tk_g, c_g), (lg_c, tk_c, c_c) = runs[DEVICE], runs["cpu"]
        same = all(torch.equal(a, b) for a, b in zip(tk_g, tk_c))
        l_err = max(_rel(a, b) for a, b in zip(lg_g, lg_c))
        c_err = max(_rel(a, b) for a, b in zip(c_g, c_c))
        print(f"[serve] {arch} reduced f32 card (kernels) vs cpu (plain): "
              f"prefill + {GRAPH_STEPS} decode steps, tokens "
              f"{'identical' if same else 'DIFFER'}, logits rel err "
              f"{l_err:.3e}, caches rel err {c_err:.3e} (tol 1e-4)")
        if not same or l_err > 1e-4 or c_err > 1e-4:
            raise AssertionError(f"{arch}: card and cpu serving disagree")


def _prefills(torch, cfg, params, tokens, impls):
    """The bulk prefill of ``tokens`` once per ``impls`` entry: ``pallas``
    (the kernels) and ``xla`` (the plain path) on ``params``, ``f32`` the
    plain path on a float32 copy of them.  Returns {impl: (logits,
    cache)}."""
    from repro_torch.core.trees import tree_map
    from repro_torch.models import transformer as T
    B, prompt = tokens.shape
    res = {}
    for impl in impls:
        p = (tree_map(lambda t: t.float(), params) if impl == "f32"
             else params)
        cache = T.init_cache(cfg, B, prompt + GRAPH_STEPS + 1,
                             torch.float32 if impl == "f32" else None)
        res[impl] = T.prefill_with_cache(
            p, tokens, cache, cfg, attn_chunk=64,
            impl="xla" if impl == "f32" else impl)
        del p
    return res


def _prefill_errs(res):
    """(logits, caches) relative to their largest value: the kernel
    prefill against the plain one and, where ``res`` has ``f32``, each
    against it."""
    from repro_torch.core.trees import tree_leaves

    def errs(a, b):
        return (_rel_max(res[a][0], res[b][0]), max(
            _rel_max(x, y) for x, y in zip(tree_leaves(res[a][1]),
                                           tree_leaves(res[b][1]))))

    e = {"kernel vs plain": errs("pallas", "xla")}
    if "f32" in res:
        e["kernel vs f32"] = errs("pallas", "f32")
        e["plain vs f32"] = errs("xla", "f32")
    return e


def serve_checks_phase(torch):
    """At full width, bf16, on the card, for each of ``SERVE_CHECKS``: the
    kernel prefill (``impl="pallas"``) against the plain prefill
    (``"xla"``) and both against a float32 copy of the same params (the
    plain path; gemma3-12b's at one super-block, beside its full-depth
    kernel-vs-plain prefill), the last position's logits and the caches
    relative to their largest value; the decode graph's replays against
    the eager step (tokens identical); a profiled decode step and prefill
    (its kernel's share of the device time); and the teacher-forced A/B at
    a ``TF_PROMPT``-token prompt."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.serve import Decoder
    from repro_torch.models import transformer as T
    out = {}
    for arch, B, prompt, gen in SERVE_RUNS:
        if arch not in SERVE_CHECKS:
            continue
        cfg = get_config(arch)
        params = steps.init_fn(cfg)(torch.Generator(DEVICE).manual_seed(0))
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, 1000, (B, prompt)), device=DEVICE)
        ccfg, cparams = cfg, params
        if SERVE_CHECKS[arch]:
            res = _prefills(torch, cfg, params, tokens, ("pallas", "xla"))
            ek, ec = _prefill_errs(res)["kernel vs plain"]
            print(f"[serve] {arch} full width and depth bf16 prefill "
                  f"({cfg.n_layers} layers), B={B} S={prompt}: kernel vs "
                  f"plain logits {ek:.3e}, caches {ec:.3e} (relative to "
                  f"the largest value)")
            del res
            ccfg = dataclasses.replace(cfg, n_layers=SERVE_CHECKS[arch])
            cparams = steps.init_fn(ccfg)(
                torch.Generator(DEVICE).manual_seed(0))
        res = _prefills(torch, ccfg, cparams, tokens, ("pallas", "xla",
                                                        "f32"))
        e = _prefill_errs(res)
        agree = int((res["pallas"][0].argmax(-1)
                     == res["xla"][0].argmax(-1)).sum())
        print(f"[serve] {arch} full width bf16 prefill ({ccfg.n_layers} "
              f"layers), B={B} S={prompt}: "
              + "; ".join(f"{k} logits {v[0]:.3e}, caches {v[1]:.3e}"
                          for k, v in e.items())
              + f" (relative to the largest value; expected within 2e-2); "
                f"next tokens agree {agree}/{B}")
        if e["kernel vs f32"][0] > 2 * e["plain vs f32"][0] + 1e-3:
            raise AssertionError(f"{arch}: the kernel prefill is further "
                                 f"from float32 than twice the plain one")
        del cparams
        del res
        # decode: graph replays against the eager step from the same state
        decs = []
        for _ in range(2):
            cache = T.init_cache(cfg, B, prompt + GRAPH_STEPS + 1)
            nxt, cache = steps.make_bulk_prefill(cfg)(params, tokens, cache)
            d = Decoder(cfg, params, cache, B, DEVICE)
            d.set(nxt, prompt)
            decs.append(d)
        g, eg = decs
        same = all(torch.equal(g.step(), eg.eager_step())
                   for _ in range(GRAPH_STEPS))
        print(f"[serve] {arch} decode: {GRAPH_STEPS} steps, graph replays "
              f"vs the eager step: tokens {'identical' if same else 'DIFFER'}"
              f"; captures {g.graph.captures}, replays {g.graph.replays}")
        if not same or g.graph.captures != 1:
            raise AssertionError(f"{arch}: decode graph replays differ from "
                                 f"the eager step")
        profile_fn(torch, g.step, f"serve {arch} one decode step (graph "
                                  f"replay)")
        cache = T.init_cache(cfg, B, prompt + GRAPH_STEPS + 1)
        profile_fn(torch, lambda: T.prefill_with_cache(params, tokens, cache,
                                                       cfg, attn_chunk=64),
                   f"serve {arch} bulk prefill B={B} S={prompt}",
                   share=TRACE_NAMES[SERVE_KERNEL[arch]])
        del decs, g, eg, cache
        if arch == "qwen3-0.6b":
            out["tf"] = teacher_forced_ab(torch, cfg, params, tokens)
        del params
        # freed now, not at a later collection: gemma3-12b's 25.5 GB of
        # params were still held at the next phase's peak without it
        gc.collect()
        torch.cuda.empty_cache()
    return out


def teacher_forced_ab(torch, cfg, params, tokens):
    """Bulk prefill against teacher-forced decode at a ``TF_PROMPT``-token
    prompt on the same params, both warm (the bulk pass run once before,
    the decode graph captured before): host clock ending in
    ``synchronize()``."""
    from repro_torch.launch import steps
    from repro_torch.launch.serve import Decoder, teacher_forced_prefill
    from repro_torch.models import transformer as T
    B, S = tokens.shape[0], TF_PROMPT
    tok = tokens[:, :S]
    cache = T.init_cache(cfg, B, S + 1)
    bulk = steps.make_bulk_prefill(cfg)
    bulk(params, tok, cache)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nb, _ = bulk(params, tok, cache)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dec = Decoder(cfg, params, T.init_cache(cfg, B, S + 1), B, DEVICE)
    teacher_forced_prefill(dec.serve_step, params, dec.cache,
                           tok[:, :2])      # warm-up and capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    teacher_forced_prefill(dec.serve_step, params, dec.cache, tok)
    torch.cuda.synchronize()
    tf_ms = (time.perf_counter() - t0) * 1e3
    bulk_ms = float(np.median(times))
    same = torch.equal(dec.token, nb)
    print(f"[serve] qwen3-0.6b teacher-forced A/B at prompt {S}, B={B}: "
          f"bulk {bulk_ms:.3f} ms (median of 3), teacher-forced "
          f"{tf_ms:.3f} ms ({S} graph replays), bulk "
          f"{tf_ms / bulk_ms:.2f}x faster; next tokens "
          f"{'identical' if same else 'differ (bf16 orders)'}")
    return dict(bulk_ms=bulk_ms, tf_ms=tf_ms)


def wide_random_cases(torch):
    """Random bfloat16 operands at each of ``WIDE_RANDOM``'s shapes."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    cases = []
    for label, (B, S, H, KH, hd, win) in WIDE_RANDOM:
        q, k, v = (torch.randn(s, device=DEVICE, generator=g)
                   .to(torch.bfloat16)
                   for s in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)))
        cases.append(attn_case(torch, q, k, v, win, label))
    return cases


def serving_kernel_phase(torch, found):
    """Both backbone kernels against their plain versions (float32 and
    float64) at the operands the serving prefills handed them, and
    attention at ``WIDE_RANDOM``'s shapes.  Returns the cases and the max
    abs error per kernel against the float32 plain version."""
    attn = [attn_case(torch, *rec["args"], rec["kw"].get("window"),
                      rec["label"]) for rec in found.get("attn", {}).values()]
    if sum(c["regime"] == "wide" for c in attn) < 2:
        raise AssertionError("serving: gemma3-12b's local and global "
                             "prefill operands not recorded on the wide "
                             "regime")
    attn += wide_random_cases(torch)
    ssd = [ssd_case(*rec["args"], rec["label"])
           for rec in found.get("ssd_chunk", {}).values()]
    if len(attn) < 6 or not ssd:
        raise AssertionError("serving: kernel operands not recorded")
    errs = {"flash_attention_fwd": [], "ssd_chunk_fwd": []}
    backbone_checks(torch, attn, ssd, {"attn": {}, "ssd_forward": {}}, errs)
    # bfloat16 attention records no float32 error (``backbone_checks``)
    return attn, ssd, {k: max(v) for k, v in errs.items() if v}


def continuous_phase(torch, counters):
    """Full-width qwen3-0.6b served beside IEMOCAP fused rounds
    (``run_continuous``), the counters set to 0 just before and read
    after; then a hot swap against a fresh server restored to the same
    state.  Returns the launches (the wrappers' own and the fused rounds'
    captured launches times replays)."""
    from repro_torch.configs import get_config
    from repro_torch.core.trees import tree_map
    from repro_torch.fl.runtime import MFLExperiment
    from repro_torch.launch import steps
    from repro_torch.launch.continuous import ContinuousServer, run_continuous
    reset, read = counters
    t_start = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    exp = MFLExperiment(dataset="iemocap", scheduler="jcsba", K=6,
                        n_samples=120, seed=0, eval_every=10 ** 9,
                        engine="fused:pallas")
    feats = {m: x[:CONT_B] for m, x in sorted(exp.test_ds.features.items())}
    lm = steps.init_fn(cfg)(torch.Generator(DEVICE).manual_seed(0))
    max_len = CONT_PROMPT + CONT_KW["rounds"] * CONT_KW["steps_per_round"] + 8
    srv = ContinuousServer(cfg, lm, exp.global_params, feats,
                           max_len=max_len)
    ptrs = {dt: b.data_ptr() for dt, b in srv.bufs.items()}
    prompts = np.random.default_rng(0).integers(0, 1000,
                                                (CONT_B, CONT_PROMPT))
    reset()
    rep = run_continuous(exp, srv, prompts, **CONT_KW)
    now = read()
    eng = exp._fused_engine
    counts = {k: now.get(k, 0) + graph_counts(eng).get(k, 0) for k in now}
    st = np.array(rep["steady_latencies_s"]) * 1e3
    ps = np.array(rep["post_swap_latencies_s"]) * 1e3
    sw = np.array(rep["swap_walls_s"]) * 1e3
    print(f"[continuous] qwen3-0.6b full width (bf16) beside IEMOCAP fused "
          f"rounds (K=6, n=120, JCSBA), B={CONT_B}, prompt {CONT_PROMPT}, "
          f"{CONT_KW['rounds']} rounds x {CONT_KW['steps_per_round']} steps: "
          f"steady p50 {np.percentile(st, 50):.4f} p99 "
          f"{np.percentile(st, 99):.4f} ms; post-swap p50 "
          f"{np.percentile(ps, 50):.4f} p99 {np.percentile(ps, 99):.4f} ms; "
          f"{rep['tokens_per_s']:.1f} tok/s; swap "
          + ", ".join(f"{x:.3f}" for x in sw) + f" ms, {rep['swap_bytes']} "
          f"bytes written of {srv.spec.nbytes()}; rounds "
          + ", ".join(f"{x * 1e3:.3f}" for x in rep["round_walls_s"])
          + f" ms; captures {rep['compile_counts']}, recompiles "
          f"{rep['recompiles']}; launches {({k: v for k, v in counts.items() if v})}")
    if sum(rep["recompiles"].values()) or \
            rep["compile_counts"] != {"decode_captures": 1}:
        raise AssertionError(f"continuous: captures {rep['compile_counts']},"
                             f" recompiles {rep['recompiles']}")
    if {dt: b.data_ptr() for dt, b in srv.bufs.items()} != ptrs:
        raise AssertionError("continuous: a swap moved the flat buffers")
    if not counts["flash_attention_fwd"] or not counts["fusion_loss_fwd"] \
            or not counts["jcsba_population_kernel"]:
        raise AssertionError(f"continuous: a kernel was not launched "
                             f"{counts}")
    # the hot swap against a fresh server with the new params, restored to
    # the same state (tests/test_decode_consistency.py's contract)
    state = srv.state()
    exp.run_scanned(1)
    new = tree_map(torch.clone, eng.round_params(exp._carry))
    srv.swap(new)
    fresh = ContinuousServer(cfg, lm, new, feats, max_len=max_len)
    fresh.load_state(state)
    same = True
    for _ in range(GRAPH_STEPS):
        srv.decode_step()
        fresh.decode_step()
        same &= torch.equal(srv.token, fresh.token)
    print(f"[continuous] hot swap vs a fresh server with the new params at "
          f"the same state: {GRAPH_STEPS} steps, tokens "
          f"{'identical' if same else 'DIFFER'}; captures "
          f"{srv.compile_counts()} (swapped), {fresh.compile_counts()} "
          f"(fresh); {time.perf_counter() - t_start:.3f} s")
    if not same or srv.compile_counts() != {"decode_captures": 1}:
        raise AssertionError("continuous: the hot swap differs from a fresh "
                             "server")
    del srv, fresh, lm
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 6: training — the LM train step at full width, card vs CPU, kernel
# route vs plain route, the MoE serve
# ---------------------------------------------------------------------------
def _train_cfg(arch, n_layers=None, reduced=False):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
        if cfg.ssm_state:
            cfg = dataclasses.replace(cfg, ssm_chunk=8)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def _train_batches(cfg, B, S, n, device):
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import train
    stream, rng = TokenStream(cfg.vocab_size, seed=0), \
        np.random.default_rng(0)
    return [train.to_device(train.make_batch(cfg, stream, rng, B, S),
                            device) for _ in range(n)]


def _grad_errs(ga, gb):
    """(‖ga − gb‖ / ‖gb‖ over every leaf, the largest leaf's max|Δ| over
    its max|gb|)."""
    from repro_torch.core.trees import tree_leaves
    num = den = 0.0
    worst = 0.0
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        d = (a.float() - b.float())
        num += float(d.square().sum())
        den += float(b.float().square().sum())
        worst = max(worst, float(d.abs().max())
                    / max(float(b.float().abs().max()), 1e-30))
    return math.sqrt(num / max(den, 1e-30)), worst


def train_kernel_vs_plain(torch, cfg, params, batch, label, **kw):
    """One step's value and grads at full width from the same params,
    kernel route against plain route (``impl="pallas"`` / ``"xla"``)."""
    from repro_torch.launch import steps
    out = {}
    for impl in ("pallas", "xla"):
        loss = steps.make_loss_fn(cfg, attn_chunk=256, impl=impl, **kw)
        out[impl] = steps.value_and_grad(loss, params, batch)
    (lk, gk), (lp, gp) = out["pallas"], out["xla"]
    l_err = abs(float(lk) - float(lp)) / abs(float(lp))
    g_rel, g_worst = _grad_errs(gk, gp)
    print(f"[train] {label} kernel route vs plain route, one step from "
          f"the same params (bf16): loss {float(lk):.6f} vs "
          f"{float(lp):.6f}, relative {l_err:.3e} (tol "
          f"{TOL_TRAIN_LOSS_BF16:g}); grads ‖Δg‖/‖g‖ {g_rel:.3e} (tol "
          f"{TOL_TRAIN_GRAD_BF16:g}), worst leaf max|Δ|/max|g| "
          f"{g_worst:.3e} (tol {TOL_TRAIN_LEAF_BF16:g})")
    if not (l_err <= TOL_TRAIN_LOSS_BF16 and g_rel <= TOL_TRAIN_GRAD_BF16
            and g_worst <= TOL_TRAIN_LEAF_BF16):
        raise AssertionError(f"{label}: the kernel route's loss or grads "
                             f"disagree with the plain route's")
    del out, gk, gp
    torch.cuda.empty_cache()


def _expected_train_launches(cfg, n_steps, loss_steps):
    """Kernel launches of ``n_steps`` train steps: the attention kernel
    once an attention layer (the decoder's self-attention for Whisper),
    the SSD kernel once a Mamba2 layer (both backwards recompute through
    the plain path), the fusion loss once a loss call each way."""
    pattern = cfg.block_pattern()
    n_attn = (cfg.n_layers if cfg.arch_type == "audio" else
              cfg.n_blocks * sum(s.kind == "attn" for s in pattern))
    n_ssd = cfg.n_blocks * sum(s.kind == "mamba" for s in pattern)
    fused = cfg.arch_type in ("audio", "vlm")
    return {"flash_attention_fwd": n_attn * n_steps,
            "ssd_chunk_fwd": n_ssd * n_steps,
            "fusion_loss_fwd": loss_steps if fused else 0,
            "fusion_loss_bwd": loss_steps if fused else 0}


def train_run(torch, counters, found, arch, n_layers, B, S, n_steps):
    """One full-width training run through ``launch.steps``: the kernel
    route against the plain route on step 0's batch, then ``n_steps``
    steps with the peak-memory counter and the launch counters reset just
    before, the kernels' operands recorded on the way.  Returns (launches,
    summary)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fusion_loss import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import steps
    from repro_torch.models import analysis
    from repro_torch.optim import adafactor, warmup_cosine
    reset, read = counters
    t_run = time.perf_counter()
    cfg = _train_cfg(arch, n_layers)
    n_full = steps.param_count(steps.params_shape(_train_cfg(arch)))
    lr = warmup_cosine(3e-4, 10, n_steps)
    if arch in TRAIN_ADAFACTOR:
        opt, opt_name = adafactor(lr), "adafactor (AdamW's state too large)"
    else:
        opt, opt_name = steps.make_optimizer(cfg, n_full, lr=lr)
    params = steps.init_fn(cfg)(torch.Generator(DEVICE).manual_seed(0))
    batches = _train_batches(cfg, B, S, n_steps, DEVICE)
    label = (f"{arch} ({cfg.n_layers} of {_train_cfg(arch).n_layers} "
             f"layers)" if n_layers else arch)
    train_kernel_vs_plain(torch, cfg, params, batches[0], label)
    n_total, n_active = analysis.param_counts(params, cfg)
    flops = analysis.model_flops(cfg, params, analysis.StepShape(
        S, B, "train"))["model_flops"]
    opt_state = opt.init(params)
    step = steps.make_train_step(cfg, opt, attn_chunk=min(256, S))
    caps = [Capture(torch, fa_ops, "flash_attention", f"train {arch}"),
            Capture(torch, ssd_ops, "ssd_chunk", f"train {arch}"),
            Capture(torch, ops, "fusion_loss_fwd", f"train {arch}")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    ms, losses = [], []
    with caps[0], caps[1], caps[2]:
        for b in batches:
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
    now = read()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for key, cap in zip(("attn", "ssd_chunk", "fusion"), caps):
        for shape, rec in cap.seen.items():
            found.setdefault(key, {}).setdefault(shape, rec)
    want = _expected_train_launches(cfg, n_steps, n_steps)
    p50 = float(np.median(ms[1:]))
    mfu = flops / (p50 / 1e3) / PEAK_BF16_FLOPS
    print(f"[train] {label}: B={B} S={S} {n_steps} steps, {opt_name}, "
          f"{cfg.dtype}, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_total / 1e9:.4f} B params ({n_active / 1e9:.4f} B active): "
          f"step ms p50 {p50:.3f} after step 0 (steps "
          + ", ".join(f"{x:.3f}" for x in ms)
          + f"); {B * S / (p50 / 1e3):.1f} tok/s; peak "
          f"{peak:.3f} GiB; mfu {mfu:.4%} ({flops / 1e12:.3f} model "
          f"TFLOP a step over the bf16 dense peak); losses "
          + " -> ".join(f"{x:.4f}" for x in losses) + "; launches "
          + f"{({k: v for k, v in now.items() if v})}; "
          f"{time.perf_counter() - t_run:.3f} s ({gpu_line()})")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {arch}: a loss is not finite")
    for k, v in want.items():
        if now[k] != v:
            raise AssertionError(f"train {arch}: {k} launched {now[k]} "
                                 f"times, {v} expected")
    summary = dict(cfg=cfg, params=params, opt=opt, opt_state=opt_state,
                   batches=batches, step=step, p50=p50, peak=peak, mfu=mfu)
    return now, summary


def train_vlm_chunked_step(torch, counters, found, run):
    """One more VLM step through ``vlm_loss_chunked`` (TRAIN_LOSS_CHUNK
    positions a chunk, each through the fusion-loss kernels)."""
    from repro_torch.kernels.fusion_loss import ops
    from repro_torch.launch import steps
    reset, read = counters
    cfg, b = run["cfg"], run["batches"][0]
    S = b["tokens"].shape[1]
    train_kernel_vs_plain(torch, cfg, run["params"], b,
                          f"llava-next-34b loss_chunk={TRAIN_LOSS_CHUNK}",
                          loss_chunk=TRAIN_LOSS_CHUNK)
    step = steps.make_train_step(cfg, run["opt"], attn_chunk=min(256, S),
                                 loss_chunk=TRAIN_LOSS_CHUNK)
    cap = Capture(torch, ops, "fusion_loss_fwd", "train llava chunked")
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cap:
        _, _, loss = step(run["params"], run["opt_state"], b)
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    now = read()
    for shape, rec in cap.seen.items():
        found.setdefault("fusion", {}).setdefault(shape, rec)
    chunks = S // TRAIN_LOSS_CHUNK
    want = _expected_train_launches(cfg, 1, chunks)
    print(f"[train] llava-next-34b step with loss_chunk={TRAIN_LOSS_CHUNK}"
          f" ({chunks} chunks): {dt:.3f} ms, loss {float(loss):.4f}; "
          f"launches {({k: v for k, v in now.items() if v})}")
    if not math.isfinite(float(loss)) or any(now[k] != v
                                             for k, v in want.items()):
        raise AssertionError(f"train llava chunked: loss {float(loss)}, "
                             f"launches {now}, {want} expected")
    return now


def train_phase(torch, counters, found):
    """Every ``TRAIN_RUNS`` run (the qwen3 and gemma3 ones profiled for a
    step), the VLM's chunked-loss step.  Returns the launches of the train steps."""
    total = {}
    for arch, n_layers, B, S, n_steps in TRAIN_RUNS:
        now, run = train_run(torch, counters, found, arch, n_layers, B, S,
                             n_steps)
        if arch == "qwen3-0.6b":
            profile_fn(torch, lambda: run["step"](
                run["params"], run["opt_state"], run["batches"][0]),
                "train qwen3-0.6b one step (B=8, S=256)", top=12)
        if arch == "gemma3-12b":
            profile_fn(torch, lambda: run["step"](
                run["params"], run["opt_state"], run["batches"][0]),
                f"train gemma3-12b one step ({n_layers} layers, B={B}, "
                f"S={S})", top=8, share=TRACE_NAMES["flash_attention_fwd"])
        if arch == "llava-next-34b":
            extra = train_vlm_chunked_step(torch, counters, found, run)
            now = {k: now[k] + extra[k] for k in now}
        for k, v in now.items():
            total[k] = total.get(k, 0) + v
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return total


def train_twin_phase(torch, counters):
    """Reduced float32 archs, 3 steps on the card (kernel route) against
    the CPU (plain versions), each step from the CPU's params and
    optimizer state of the step before (AdamW's and Adafactor's sign can
    flip where a gradient is near 0, and a flipped coordinate can flip an
    MoE router later): the loss within 1e-5 relative, the params within
    2.5·lr with at least 99.9 % of the elements within 1e-4 of max(1,
    |CPU|), every optimizer state leaf within 1e-4 — the CPU tests'
    tolerances (tests/test_torch_train.py)."""
    from repro_torch.core.trees import tree_leaves, tree_map
    from repro_torch.launch import steps
    reset, read = counters
    for arch in TRAIN_TWINS:
        cfg = _train_cfg(arch, reduced=True)
        n_full = steps.param_count(steps.params_shape(_train_cfg(arch)))
        opt, opt_name = steps.make_optimizer(cfg, n_full, lr=TWIN_LR)
        step = steps.make_train_step(cfg, opt, attn_chunk=32)
        p = steps.init_fn(cfg)(torch.Generator().manual_seed(0))
        st = opt.init(p)
        batches = _train_batches(cfg, 2, 64, 3, "cpu")
        reset()
        l_err = s_err = p_err = 0.0
        flipped = n = 0
        for b in batches:
            to_card = lambda t: t.to(DEVICE)      # noqa: E731
            pg, sg, lg = step(tree_map(to_card, p), tree_map(to_card, st),
                              tree_map(to_card, b))
            p, st, lc = step(p, st, b)
            l_err = max(l_err, abs(float(lg) - float(lc))
                        / max(1.0, abs(float(lc))))
            for a, c in zip(tree_leaves(sg), tree_leaves(st)):
                s_err = max(s_err, _rel(a.cpu(), c))
            for a, c in zip(tree_leaves(pg), tree_leaves(p)):
                err = (a.cpu().float() - c.float()).abs()
                p_err = max(p_err, float(err.max()))
                flipped += int((err > 1e-4 * max(1.0, float(
                    c.float().abs().max()))).sum())
                n += err.numel()
        now = read()
        kerns = {k: v for k, v in now.items() if v}
        print(f"[train] {arch} reduced f32 card (kernels) vs cpu (plain), 3 "
              f"steps each from the cpu's state, {opt_name}: loss rel err "
              f"{l_err:.3e} (tol 1e-5), state rel err {s_err:.3e} (tol "
              f"1e-4), params max|err| {p_err:.3e} (tol 2.5·lr = "
              f"{2.5 * TWIN_LR:g}), {flipped} of {n} elements past 1e-4 "
              f"(tol 0.1 %); card launches {kerns}")
        want = _expected_train_launches(cfg, 3, 3)
        if (l_err > 1e-5 or s_err > 1e-4 or p_err > 2.5 * TWIN_LR
                or flipped > 1e-3 * n
                or any(now[k] != v for k, v in want.items())):
            raise AssertionError(f"train {arch}: card and cpu disagree or "
                                 f"launches {now} != {want}")


def moe_serve_phase(torch, counters, found):
    """``launch.serve.serve`` of llama4-scout at full width with one
    layer: the MoE dispatch inside the captured decode graph, 0
    recaptures.  Returns the launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    reset, read = counters
    arch, n_layers, B, prompt, gen = MOE_SERVE
    cap = Capture(torch, fa_ops, "flash_attention", f"serve {arch}")
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    reset()
    with cap:
        out = serve.serve(_serve_args(arch, B, prompt, gen, "--n-layers",
                                      str(n_layers)), stats)
    now = read()
    for shape, rec in cap.seen.items():
        found.setdefault("attn", {}).setdefault(shape, rec)
    cfg = stats["cfg"]
    print(f"[serve] {arch} ({n_layers} layer, bf16, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} + shared, vocab "
          f"{cfg.vocab_size}): B={B} prompt={prompt} generated={gen}: bulk "
          f"prefill {stats['prefill_ms']:.3f} ms; decode "
          f"{stats['decode_p50_ms']:.4f} ms/step median, "
          f"{stats['decode_p99_ms']:.4f} p99 over {len(stats['decode_ms'])} "
          f"graph replays; {stats['tok_s']:.1f} tok/s; peak "
          f"{stats['peak_bytes'] / 2 ** 30:.3f} GiB; captures "
          f"{stats['captures']}, recaptures {stats['captures'] - 1}; "
          f"launches {({k: v for k, v in now.items() if v})} "
          f"({gpu_line()})")
    if (tuple(out.shape) != (B, gen) or stats["captures"] != 1
            or now["flash_attention_fwd"] != n_layers):
        raise AssertionError(f"serve {arch}: tokens {tuple(out.shape)}, "
                             f"captures {stats['captures']}, launches {now}")
    del out
    torch.cuda.empty_cache()
    return now


def train_fusion_case(torch, rec, seed):
    """A fusion-loss case at operands a train step handed the forward
    kernel, with random cotangents."""
    logits, labels, avail, seg = rec["args"]
    K, T = labels.shape
    M, V = len(logits), logits[0].shape[-1]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return dict(logits=list(logits), labels=labels, avail=avail,
                d_fused=torch.randn((K, T), device=DEVICE, generator=g),
                d_modal=torch.randn((M, K, T), device=DEVICE, generator=g),
                seg=tuple(seg), shape=(K, T, V, M))


def train_kernel_phase(torch, ops, ref, found):
    """Every kernel against its plain version at the operands the train
    steps recorded.  Returns the cases (fusion by label, attention, SSD)
    and the max abs error per kernel against the float32 plain version."""
    cases = {f"{rec['label']} " + "x".join(map(str, rec["args"][1].shape)):
             train_fusion_case(torch, rec, 30 + i)
             for i, rec in enumerate(found.get("fusion", {}).values())}
    errs = {k: [] for k in ("fusion_loss_fwd", "fusion_loss_bwd",
                            "fusion_loss_reduce", "flash_attention_fwd",
                            "ssd_chunk_fwd")}
    for label, c in cases.items():
        fusion_check(torch, ops, ref, label, c, errs)
    attn = [attn_case(torch, *rec["args"], rec["kw"].get("window"),
                      rec["label"]) for rec in found.get("attn", {}).values()]
    ssd = [ssd_case(*rec["args"], rec["label"])
           for rec in found.get("ssd_chunk", {}).values()]
    if len(cases) < 3 or len(attn) < 5 or not ssd:
        raise AssertionError("train: kernel operands not recorded")
    backbone_checks(torch, attn, ssd, {"attn": {}, "ssd_forward": {}}, errs)
    return cases, attn, ssd, {k: max(v) for k, v in errs.items() if v}


def train_section(torch, counters, ops, ref):
    """Phase 6 whole: the full-width runs, the card-vs-CPU twins, the MoE
    serve and the kernels at the recorded train operands.  Returns (the
    train steps' launches, the MoE serve's, fusion cases, attention
    cases, SSD cases, max errors)."""
    found = {}
    by_train = train_phase(torch, counters, found)
    for k in ("flash_attention_fwd", "ssd_chunk_fwd", "fusion_loss_fwd",
              "fusion_loss_bwd"):
        if not by_train.get(k):
            raise AssertionError(f"train: {k} was not launched")
    train_twin_phase(torch, counters)
    moe = moe_serve_phase(torch, counters, found)
    return (by_train, moe) + train_kernel_phase(torch, ops, ref, found)


# ---------------------------------------------------------------------------
# phase 3b: the JCSBA solver kernels against their plain versions
# ---------------------------------------------------------------------------
class record_launches:
    """Records each population launch made while open — its rows, B_min,
    ok and ``want_B``, cloned — and lets the launch go on as it would."""

    def __enter__(self):
        from repro_torch.kernels.jcsba_solver import ops
        self.ops, self.orig, self.seen = ops, ops.population_objective, []

        def wrapper(A, bmin_, ok, data, hp, want_B=False, args=None):
            self.seen.append((A.clone(), bmin_.clone(), ok.clone(), want_B))
            return self.orig(A, bmin_, ok, data, hp, want_B, args)

        ops.population_objective = wrapper
        return self

    def __exit__(self, *exc):
        self.ops.population_objective = self.orig


class SolverCapture:
    """Records the first solve the main path hands ``solve_core`` (round
    data, warm-start seeds, draws, hyper-parameters) and every population
    launch of that solve, while open."""

    def __enter__(self):
        from repro_torch.wireless import policies
        self.mod, self.orig, self.seen = policies, policies.solve_core, None

        def wrapper(data, seeds, draws, hp):
            if self.seen is not None:
                return self.orig(data, seeds, draws, hp)
            inputs = (dict(data), seeds.clone(),
                      tuple(d.clone() for d in draws), hp)
            with record_launches() as rec:
                out = self.orig(data, seeds, draws, hp)
            self.seen = inputs + (rec.seen,)
            return out

        self.mod.solve_core = wrapper
        return self

    def __exit__(self, *exc):
        self.mod.solve_core = self.orig


#: operations of φ at one point besides its numerator (x: 3, log1p: 1,
#: the branch test: 1, the quotient: 8; a transcendental counted as one),
#: of each numerator (the exact one: 3, the series below PHI_SERIES_X: 6),
#: of one bisection step around φ (midpoint, compare, two selects) and of
#: one rate evaluation
OPS_PHI, OPS_NUM_EXACT, OPS_NUM_SERIES, OPS_STEP, OPS_RATE = 13, 3, 6, 4, 6


def phi_ops(torch, B, d):
    """Operations of φ at each point of B: one numerator, the one its x
    takes."""
    from repro_torch.wireless.solver.common import PHI_SERIES_X
    x = d["p_tx"] * d["h"] / (B * d["N0"])
    return OPS_PHI + torch.where(x < PHI_SERIES_X, OPS_NUM_SERIES,
                                 OPS_NUM_EXACT)


def solver_work(torch, d, A, bm, ok, hp):
    """(bytes, operations) of one population launch on these rows, as this
    data needs them.  Bytes: every input read once, J and feasible written
    once.  Operations, per row: φ(B_min) of every client and the row's
    sums; for a row on the KKT path, the κ walk replayed on the host with
    the plain version's float32 operations (``ref.allocate``'s u_a/u_b),
    charging at each of its n_k + 1 points n_b bisection steps of each
    participant that is not pinned at it (pinned and Q ≤ 0 participants
    bisect nothing, as in the kernel), each φ with the numerator its x
    takes, and the Σ over participants; the slack spread or the
    closed-form split; the energy of each participant and the bound over
    [M, K] of each feasible row."""
    import math
    from repro_torch.kernels.jcsba_solver import ref
    from repro_torch.wireless.solver.common import KAPPA_TINY, TOL_B
    d = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in d.items()}
    A, bm, ok = A.cpu().to(torch.bool), bm.cpu(), ok.cpu()
    Q, B_max = d["Q"], d["B_max"]
    P, K = A.shape
    M = d["zeta2"].shape[0]
    nbytes = (P * K + 6 * 4 * K + K + M * 4 + 2 * M * K * 4 + M * K + 4
              + P * 5)
    Af = A.to(torch.float32)
    s = Af.sum(-1)
    tot = (Af * bm).sum(-1)
    feas = ~(A & ~ok).any(-1) & (tot <= B_max + TOL_B)
    active = A & (Q > 0)
    kkt = feas & (tot < B_max - TOL_B) & active.any(-1)
    ops = P * (int(phi_ops(torch, bm, d).sum()) + 6 * K)
    ops += int((feas * s).sum()) * (OPS_RATE + 6 + 2) \
        + int(feas.sum()) * M * K * 8
    if not kkt.any():
        return nbytes, ops
    phi_b = ref.phi(bm, Q, d["gamma"], d["h"], d["p_tx"], d["N0"])
    Ak, sk = A[kkt], s[kkt]
    k_lo = torch.clamp_max(torch.where(active[kkt], phi_b, 0.0).amin(-1),
                           -1e-35)
    u_a = torch.log(-k_lo)
    u_b = torch.full_like(u_a, math.log(KAPPA_TINY))
    for it in range(hp.n_bisect_k + 1):
        last = it == hp.n_bisect_k
        u = u_b if last else 0.5 * (u_a + u_b)
        kap = -torch.exp(u)[:, None]
        pinned = phi_b >= kap
        live = Ak & ~pinned
        lo = bm.expand(Ak.shape)
        hi = torch.full(Ak.shape, B_max)
        for _ in range(hp.n_bisect_b):
            mid = 0.5 * (lo + hi)
            ops += int(torch.where(live, phi_ops(torch, mid, d) + OPS_STEP,
                                   0).sum())
            under = ref.phi(mid, Q, d["gamma"], d["h"], d["p_tx"],
                            d["N0"]) < kap
            lo, hi = torch.where(under, mid, lo), torch.where(under, hi, mid)
        ops += int(sk.sum()) + (0 if last else 4 * len(sk))
        if last:
            break
        t = torch.where(Ak, torch.where(pinned, bm, 0.5 * (lo + hi)),
                        0.0).sum(-1)
        under = t < B_max
        u_a, u_b = torch.where(under, u, u_a), torch.where(under, u_b, u)
    return nbytes, ops + int(sk.sum()) * 4


def bmin_work(K, hp):
    """(bytes, operations) of one B_min launch: Γ, h, τ read; B_min and ok
    written; per client the target and ceiling (6) and n_b bisection steps
    of a rate evaluation."""
    return 3 * 4 * K + 5 * K, K * (6 + hp.n_bisect_b * (OPS_RATE + OPS_STEP))


def solver_check(torch, label, d, A, bm, ok, hp, errs):
    """One population launch's rows through the kernel and the plain
    version, on the same inputs: feasibility equal, J and B within
    tolerance.  Returns the plain version's count of feasible rows."""
    from repro_torch.kernels.jcsba_solver import ops, ref
    J, B, feas = ops.population_objective(A, bm, ok, d, hp, want_B=True)
    J_w, B_w, feas_w = ref.population_objective(A, bm, ok, d, hp,
                                                want_B=True)
    torch.cuda.synchronize()
    if not (torch.equal(feas, feas_w)
            and torch.equal(torch.isinf(J), torch.isinf(J_w))):
        raise AssertionError(f"population kernel, {label}: feasibility "
                             f"differs")
    fin = torch.isfinite(J_w)
    if fin.any():                          # else every row is infeasible
        check(torch, f"{label} J", J[fin], J_w[fin], TOL_SOLVER_J, errs)
    check(torch, f"{label} B (Hz)", B, B_w, TOL_SOLVER_B, [])
    return int(feas_w.sum())


def bmin_check(torch, label, d, hp, errs):
    """The B_min kernel against its plain version on one round: ok equal,
    B_min within 1e-6.  Returns the plain version's (B_min, ok)."""
    from repro_torch.kernels.jcsba_solver import ops, ref
    args = (d["gamma"], d["h"], d["tau_rem"], d["B_max"], d["p_tx"],
            d["N0"], hp)
    bm, ok = ops.bmin(*args)
    bm_w, ok_w = ref.bmin(*args)
    torch.cuda.synchronize()
    if not torch.equal(ok, ok_w):
        raise AssertionError(f"bmin kernel, {label}: ok differs from plain")
    check(torch, f"{label} bmin", bm, bm_w, dict(rtol=1e-6, atol=0.0), errs)
    print(f"[solver] {label}: ok {int(ok_w.sum())} of {ok_w.numel()} "
          f"clients")
    return bm_w, ok_w


def solver_phase(torch, captured):
    """Both solver kernels against their plain versions: B_min at each
    round; every population launch of the main path's captured solve
    (CREMA-D, K=10: P = 20, 24, 4 and 1 on the rows the search made) and of
    the same solve with queues > 0, each on its own inputs; K = 100 and
    1000 synthetic rounds at P = 24, 20, 4 and 1; one whole solve with the
    kernels against one with the plain versions on the captured draws.
    Returns the timing cases (at the main path, the launch of each P with
    the most work) and the max abs errors (B_min, J)."""
    from repro_torch.kernels.jcsba_solver.checks import (antibody_rows,
                                                         plain_versions,
                                                         synthetic_round)
    from repro_torch.wireless.solver import torchsolver
    data, seeds, draws, hp, launches = captured
    K0 = data["Q"].shape[0]
    # the paper's defaults keep the Lyapunov queues at 0, so the captured
    # rounds take the all-Q≤0 branch; the same round with queues drawn in
    # (0, 0.01) runs the κ/φ⁻¹ bisections at the main path's shape
    g = torch.Generator(device=DEVICE).manual_seed(7)
    data_q = dict(data, Q=torch.rand(K0, generator=g, device=DEVICE) * 0.01)
    with record_launches() as rec:
        torchsolver.solve_core(data_q, seeds, draws, hp)
    errs = {k: [] for k in SOLVER_KERNELS}
    rows = []
    bmin_check(torch, f"main-path K={K0}", data, hp,
               errs["jcsba_bmin_kernel"])
    for tag, d, seen in (("", data, launches), (" Q>0", data_q, rec.seen)):
        heaviest, nfeas = {}, 0
        for i, (A, bm, ok, want_B) in enumerate(seen):
            P = A.shape[0]
            nfeas += solver_check(torch, f"launch {i} P={P}{tag}", d, A, bm,
                                  ok, hp, errs["jcsba_population_kernel"])
            w = solver_work(torch, d, A, bm, ok, hp)
            if P not in heaviest or w[1] > heaviest[P][-1][1]:
                heaviest[P] = (i, A, bm, ok, want_B, w)
        print(f"[solver] main-path K={K0}{tag}: each of the solve's "
              f"{len(seen)} population launches (P = "
              + ", ".join(str(A.shape[0]) for A, *_ in seen)
              + f") matches the plain version; {nfeas} of "
              f"{sum(A.shape[0] for A, *_ in seen)} rows feasible")
        if sorted(heaviest) != [1, 4, 20, 24]:
            raise AssertionError(f"the solve launched P = "
                                 f"{sorted(heaviest)}, expected 1, 4, 20 "
                                 f"and 24")
        for P in (20, 24, 4, 1):
            i, A, bm, ok, want_B, w = heaviest[P]
            rows.append((f"main-path K={K0}{tag} P={P} (launch {i})", d, A,
                         bm, ok, want_B, w, hp))
    for K in (100, 1000):
        d = torchsolver.to_device(synthetic_round(K, K), DEVICE)
        bm, ok = bmin_check(torch, f"K={K}", d, hp,
                            errs["jcsba_bmin_kernel"])
        A24 = antibody_rows(K, 24, K + 24)
        for P, A in ((24, A24), (20, antibody_rows(K, 20, K + 20)),
                     (4, antibody_rows(K, 4, K + 4)), (1, A24[1:2])):
            A = torch.as_tensor(A, device=DEVICE).contiguous()
            nfeas = solver_check(torch, f"K={K} P={P}", d, A, bm, ok, hp,
                                 errs["jcsba_population_kernel"])
            print(f"[solver] K={K} P={P}: {nfeas} of {P} rows feasible")
            rows.append((f"K={K} P={P}", d, A, bm, ok, False,
                         solver_work(torch, d, A, bm, ok, hp), hp))
    # one whole solve each way on the captured draws
    for tag, d in (("", data), (" Q>0", data_q)):
        t0 = time.perf_counter()
        a, J, B = torchsolver.solve_core(d, seeds, draws, hp)
        torch.cuda.synchronize()
        t_kern = (time.perf_counter() - t0) * 1e3
        with plain_versions():
            t0 = time.perf_counter()
            a_w, J_w, B_w = torchsolver.solve_core(d, seeds, draws, hp)
            torch.cuda.synchronize()
            t_plain = (time.perf_counter() - t0) * 1e3
        if not torch.equal(a, a_w):
            raise AssertionError(f"solve: a* {a.tolist()} (kernels) != "
                                 f"{a_w.tolist()} (plain)")
        check(torch, "solve J* kernels vs plain", J, J_w, TOL_SOLVER_J, [])
        check(torch, "solve B* kernels vs plain (Hz)", B, B_w, TOL_SOLVER_B,
              [])
        print(f"[solver] whole solve at the main path's K={K0}{tag} "
              f"(S={hp.S}, G={hp.G}): a* equal {a.int().tolist()}; wall "
              f"{t_kern:.3f} ms with the kernels, {t_plain:.3f} ms with the "
              f"plain versions")
    return rows, hp, {k: max(v) for k, v in errs.items()}


SOLVER_LIB = "none: no single PyTorch call computes this function"


def bmin_row(torch, label, d, hp, args=None):
    """A [time] row of the B_min kernel on the round data ``d``."""
    from repro_torch.kernels.jcsba_solver import ops, ref
    K = d["gamma"].shape[0]
    bm = (d["gamma"], d["h"], d["tau_rem"], d["B_max"], d["p_tx"], d["N0"],
          hp)
    return time_row(torch, "jcsba_bmin_kernel", label, f"K={K}",
                    lambda: ops._launch_bmin(*bm, args),
                    lambda: ref.bmin(*bm), None, SOLVER_LIB,
                    bmin_work(K, hp))


def solver_timing_phase(torch, rows, bmin_rows=()):
    """[time] rows for the two solver kernels at every solver case: the
    population kernel as the search launches it (the solve's one
    ``SolverArgs``; B only for the winner's row), B_min on the round data
    of each K's first case, and on the first (label, round data, hp) of
    each other K in ``bmin_rows``, such as a rank's slice of the
    clients."""
    from repro_torch.kernels.jcsba_solver import ops, ref
    out = {k: [] for k in SOLVER_KERNELS}
    seen_K = set()
    for label, d, A, bm, ok, want_B, work_, hp in rows:
        K = A.shape[1]
        args = ops.launch_args(d, hp)
        if K not in seen_K:
            seen_K.add(K)
            out["jcsba_bmin_kernel"].append(
                bmin_row(torch, label.split(" P=")[0], d, hp, args))
        out["jcsba_population_kernel"].append(time_row(
            torch, "jcsba_population_kernel", label,
            f"P={A.shape[0]} K={K} M={d['zeta2'].shape[0]}"
            + (" with B" if want_B else ""),
            lambda: ops._launch_population(A, bm, ok, d, hp, want_B, args),
            lambda: ref.population_objective(A, bm, ok, d, hp, want_B),
            None, SOLVER_LIB, work_, plain_iters=3))
    for label, d, hp in bmin_rows:
        if d["gamma"].shape[0] not in seen_K:
            seen_K.add(d["gamma"].shape[0])
            out["jcsba_bmin_kernel"].append(bmin_row(torch, label, d, hp))
    return out


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def floor_ms(torch):
    """Device time of a one-element ``add_``: the launch floor."""
    one = torch.zeros(1, device=DEVICE)
    return device_ms(torch, lambda: one.add_(1.0))


def timing_phase(torch, ops, ref, cases):
    per_shape = {}
    for label, c in cases.items():
        lgs, lab, av, shape = ops._kernel_operands(
            c["logits"], c["labels"], c["avail"], c["seg"])
        out = ops._launch_fwd(lgs, lab, av, c["seg"], shape)
        df, dm = c["d_fused"], c["d_modal"]
        _, partials = ops._launch_bwd(lgs, lab, av, df, dm, out[3], out[5],
                                      c["seg"], shape)
        # the backward is timed as the training step runs it: no partials
        stack = ops._plain_stack(c["logits"], c["seg"])
        calls = {
            "fusion_loss_fwd": (
                lambda: ops._launch_fwd(lgs, lab, av, c["seg"], shape),
                lambda: ref.fusion_loss_ref(stack, lab, av,
                                            save_residuals=True),
                None),
            "fusion_loss_bwd": (
                lambda: ops._launch_bwd(lgs, lab, av, df, dm, out[3],
                                        out[5], c["seg"], shape, False),
                lambda: ref.fusion_loss_ref_grads(stack, lab, av, df, dm),
                None),
            "fusion_loss_reduce": (
                lambda: ops._launch_reduce(partials),
                lambda: partials.sum(dim=1),
                lambda: partials.sum(dim=1)),
        }
        p = ops.plan(*shape, tuple(c["seg"]), lgs[0].dtype)
        w = work(c, p.nblk)
        shape_txt = (f"{case_label(torch, c)} ({p.regime} "
                     f"{p.fwd.width}/{p.bwd.width})")
        rows = {}
        for name, (kern, plain, lib) in calls.items():
            lib_txt = ("partials.sum(dim=1)" if lib else
                       "none: no single PyTorch call computes this function")
            rows[name] = time_row(torch, name, label, shape_txt, kern, plain,
                                  lib, lib_txt, w[name])
        per_shape[label] = rows
    return per_shape


def time_row(torch, name, label, shape_txt, kern, plain, lib, lib_txt,
             work_, regime=None, peak_flops=PEAK_F32_FLOPS, plain_iters=20):
    """``device_ms`` is every device kernel one call of the wrapper
    launches, summed (a call of a kernel in two launches is charged for
    both)."""
    b_ms, b_by = bound(work_, peak_flops)
    if regime:
        shape_txt = f"{shape_txt} ({regime})"
    row = {"ms": time_ms(torch, kern),
           "device_ms": device_ms(torch, kern),
           "plain_ms": time_ms(torch, plain, iters=plain_iters,
                               warmup=min(3, plain_iters)),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": (time_ms(torch, lib) if lib else None),
           "library_device_ms": (device_ms(torch, lib) if lib else None),
           "shape": shape_txt, "label": label}
    dev_txt = ("not measured" if row["device_ms"] is None
               else f"{row['device_ms']:.6f} ms")
    lib_ms = ("" if lib is None else
              f"{row['library_ms']:.6f} ms (device "
              + ("not measured" if row["library_device_ms"] is None
                 else f"{row['library_device_ms']:.6f} ms") + ") ")
    print(f"[time] {label} {name} ({shape_txt}): {row['ms']:.6f} ms/launch "
          f"(device {dev_txt}), plain {row['plain_ms']:.6f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}), library {lib_ms}({lib_txt})")
    return row


def attn_work(c):
    """(bytes, operations) of one attention call: q, k, v read once, o
    written once; per visible (query, key) pair the two hd-long products
    (4·hd) plus scale, exp and sum."""
    B, S, H, hd = c["q"].shape
    KH = c["k"].shape[2]
    esz = c["q"].element_size()
    win = c["window"]
    pairs = sum(min(i + 1, win) if win else i + 1 for i in range(S))
    return ((2 * B * S * H * hd + 2 * B * S * KH * hd) * esz,
            B * H * pairs * (4 * hd + 3))


def ssd_work(c):
    """(bytes, operations) of one SSD chunk call: x, cum, B, C read once,
    y_diag and the states written once.  Per (batch, chunk) the lower
    triangle of C·Bᵀ, 2N a pair (the scores do not depend on the head);
    per head the decay on it (exp and product, 2 a pair), W·x over the
    triangle (2·hp a pair), the decay to the chunk's end (Q exps), x
    scaled by it (Q·hp) and the state product Bᵀ·(decay ∘ x) (2·Q·N·hp)."""
    B, nc, Q, nh, hp = c["x"].shape
    N = c["Bm"].shape[-1]
    nbytes = 4 * (2 * c["x"].numel() + c["cum"].numel()
                  + 2 * c["Bm"].numel() + B * nc * nh * N * hp)
    tri = Q * (Q + 1) // 2
    head = tri * 2 + tri * 2 * hp + Q + Q * hp + 2 * Q * N * hp
    return nbytes, B * nc * (tri * 2 * N + nh * head)


def backbone_timing_phase(torch, attn, ssd):
    """Times of the two backbone kernels at every case; the library call
    for attention is ``F.scaled_dot_product_attention(..., enable_gqa=
    True)`` on the same q/k/v, causal, or with the window's band as a
    boolean mask (timing only; the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    rows = {"flash_attention_fwd": [], "ssd_chunk_fwd": []}
    for c in attn:
        q, k, v, win = c["q"], c["k"], c["v"], c["window"]
        tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if win is None:
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                tq, tk, tv, is_causal=True, enable_gqa=True)
            lib_txt = ("F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True)")
        else:
            pos = torch.arange(q.shape[1], device=q.device)
            band = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - win)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                tq, tk, tv, attn_mask=band, enable_gqa=True)
            lib_txt = ("F.scaled_dot_product_attention(attn_mask=the "
                       "causal window band, enable_gqa=True)")
        rows["flash_attention_fwd"].append(time_row(
            torch, "flash_attention_fwd", c["label"], c["shape"],
            lambda: fa_ops._launch(q, k, v, win),
            lambda: fa_ref.attention_ref(tq, tk, tv, window=win), lib,
            lib_txt,
            attn_work(c), c["regime"],
            PEAK_F32_FLOPS if q.dtype == torch.float32 else PEAK_BF16_FLOPS))
    for c in ssd:
        ins = (c["x"], c["cum"], c["Bm"], c["Cm"])
        rows["ssd_chunk_fwd"].append(time_row(
            torch, "ssd_chunk_fwd", c["label"], c["shape"],
            lambda: ssd_ops._launch(*ins),
            lambda: ssd_ref.ssd_chunk_ref(*ins), None,
            "none: no single PyTorch call computes this function",
            ssd_work(c), c["regime"]))
    return rows


# ---------------------------------------------------------------------------
# phase 7: the multi-device layer — population-scale fused rounds on one
# device, the same sweeps client-sharded over two ranks of the one card
# (gloo), the zoo scenario-sharded, a 1-rank NCCL group capturing the
# client-sharded round, and the continuous server on a mesh
# ---------------------------------------------------------------------------
def population_params(K):
    """``benchmarks/population_scale.py``'s wireless parameters: the
    paper's 1 MHz a client, E_add = 2e-4."""
    from repro_torch.wireless.params import WirelessParams
    return WirelessParams(K=K, B_max=1e6 * K, E_add=2e-4)


def population_store(K):
    """``benchmarks/population_scale.py:build_population`` in the port: a
    numpy ``synthetic_population`` (ω = 0.2, seed 0) with its Eqs. 15-18
    cost vectors."""
    from repro_torch.data.partition import synthetic_population
    from repro_torch.data.scenarios import DATASET_SHAPES
    from repro_torch.wireless.cost import population_costs
    from repro_torch.wireless.params import MODALITY_PROFILES
    shapes, n_classes = DATASET_SHAPES[POP_DATASET]
    store = synthetic_population(K, POP_N, shapes, n_classes, 0.2, seed=0)
    cost = population_costs(store.has_modality, store.modalities,
                            store.sizes, MODALITY_PROFILES[POP_DATASET],
                            population_params(K))
    return dataclasses.replace(
        store, gamma_bits=cost.gamma_bits.astype(np.float32),
        tau_cmp=cost.tau_cmp.astype(np.float32),
        e_cmp=cost.e_cmp.astype(np.float32))


def save_store(store, path):
    """A numpy store as one ``.npy`` a leaf under ``path``, for the ranks
    to map (``load_store``)."""
    import pickle
    os.makedirs(path, exist_ok=True)
    names = []

    def put(x):
        names.append(f"{len(names)}.npy")
        np.save(os.path.join(path, names[-1]), x)
        return names[-1]
    with open(os.path.join(path, "store.pkl"), "wb") as f:
        pickle.dump(store._map(put), f)


def load_store(path):
    import pickle
    with open(os.path.join(path, "store.pkl"), "rb") as f:
        names = pickle.load(f)
    # copy-on-write maps: writable arrays, read from disk as touched
    return names._map(lambda n: np.load(os.path.join(path, n),
                                        mmap_mode="c"))


def population_engine(name, K, store, mesh=None):
    """``from_store`` at the population benchmark's set-up: Random with
    J=10, or JCSBA capped at a cohort of 10; the kernels on the path."""
    from repro_torch.fl.client import make_adapter
    from repro_torch.fl.fused_round import FusedRoundEngine
    from repro_torch.wireless.policies import JCSBAPolicy, RandomPolicy
    pol = (JCSBAPolicy(K, max_cohort=POP_J) if name == "jcsba"
           else RandomPolicy(K, POP_J))
    return FusedRoundEngine.from_store(
        store, population_params(K), pol,
        make_adapter(POP_DATASET, "lstm-cnn", loss_backend="pallas",
                     use_kernels=True), V=1.0, seed=0, device=DEVICE,
        mesh=mesh)


def population_xs(eng, K, rounds=POP_ROUNDS):
    from repro_torch.fl.fused_round import draw_population_xs
    from repro_torch.wireless.channel import Channel
    rng = np.random.default_rng(1)
    return draw_population_xs(Channel(population_params(K), rng), rng, K,
                              rounds, policy=eng.policy, device=DEVICE)


def _gib(tensors):
    return sum(t.numel() * t.element_size() for t in tensors) / 2 ** 30


def _cpu(out):
    from repro_torch.core.trees import tree_map
    return tuple(tree_map(lambda x: x.detach().cpu(), t) for t in out)


def sweep_err(torch, got, ref):
    """(schedules equal, max |err| over the float leaves, every leaf equal
    or within ``TOL_SHARD``) of a sweep's (carries, auxs) against a
    reference's, both on the host."""
    from repro_torch.core.trees import tree_leaves
    same = all(torch.equal(g, r) for g, r in
               ((got[1].a, ref[1].a), (got[1].ok, ref[1].ok)))
    err, close = 0.0, True
    for g, r in zip(tree_leaves(got[0]) + tree_leaves(got[1]),
                    tree_leaves(ref[0]) + tree_leaves(ref[1])):
        if g.shape != r.shape or g.dtype != r.dtype:
            return False, math.inf, False
        if not g.dtype.is_floating_point:
            close &= torch.equal(g, r)
            continue
        fin = torch.isfinite(r)
        if fin.any():
            err = max(err, float((g[fin] - r[fin]).abs().max()))
        close &= torch.equal(g, r) or torch.allclose(g, r, equal_nan=True,
                                                     **TOL_SHARD)
    return same, err, close


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def population_phase(torch, counters, name, K, counts, found):
    """One device: the population sweep (2 V x 3 rounds), its graph
    captured by a 1-round sweep first, then timed with the counters set to
    0 just before it; then one eager round of the same body, whose kernel
    operands (the fusion loss's, the solve's) go into ``found``; the store
    handed to the ranks, the result kept as their reference."""
    from repro_torch.core.trees import tree_map
    from repro_torch.fl.fused_round import tree_row
    from repro_torch.kernels.fusion_loss import ops as fl_ops
    reset, read = counters
    t0 = time.perf_counter()
    store = population_store(K)
    built = time.perf_counter() - t0
    save_store(store, os.path.join(MESH_DIR, f"{name}_store"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = population_engine(name, K, store)
    del store
    carry, xs = eng.fresh_carry(), population_xs(eng, K)
    eng.scan_v_grid(POP_V, carry, tree_map(lambda x: x[:1], xs), mesh=None)
    torch.cuda.synchronize()
    reset()
    since = dict(eng.replays)
    t0 = time.perf_counter()
    out = eng.scan_v_grid(POP_V, carry, xs, mesh=None)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launched = graph_counts(eng, since)
    _add(launched, read())
    _add(counts, launched)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    ref = _cpu(out)
    torch.save(ref, os.path.join(MESH_DIR, f"{name}_single.pt"))
    label = f"mesh one device {name} K={K}"
    fusion, solve = (Capture(torch, fl_ops, "fusion_loss_bwd", label),
                     SolverCapture())
    with fusion, solve:
        eng.step_eager(eng.fresh_carry(), tree_row(xs, 0))
    torch.cuda.synchronize()
    for rec in fusion.seen.values():
        found.setdefault("fusion", {})[
            f"{label} " + "x".join(map(str, rec["args"][1].shape))] = rec
    if solve.seen is not None:
        found["solve"] = (label, solve.seen)
    n = len(POP_V) * POP_ROUNDS
    sched = float(ref[1].ok.sum(-1).float().mean())
    info = dict(ms=wall / n, store=_gib(eng._store.leaves()),
                peak=peak, capture=sum(eng.capture_seconds.values()))
    print(f"[mesh] one device: {POP_DATASET} K={K} J={POP_J} {name} "
          f"n={POP_N} a client, V {list(POP_V)} x {POP_ROUNDS} rounds "
          f"(eval off) in {wall:.3f} ms = {info['ms']:.3f} ms a "
          f"scenario-round (graph replays; capture "
          f"{info['capture']:.3f} s; store built in {built:.3f} s on the "
          f"host); store {info['store']:.4f} GiB, peak {peak:.4f} GiB "
          f"above the phase's start; {sched:g} scheduled a round; "
          f"launches {launched}")
    if not all(bool(torch.isfinite(x).all()) for x in _leaves(ref[0].params)):
        raise AssertionError(f"mesh: population {name} K={K}: a non-finite "
                             f"param")
    del eng, out
    torch.cuda.empty_cache()
    return info


def _leaves(tree):
    from repro_torch.core.trees import tree_leaves
    return tree_leaves(tree)


def nccl_capture_phase(torch, counts):
    """A 1-rank NCCL group: the JCSBA population engine built on a 1×1
    ("scenario", "clients") mesh, whose round — the channel reassembly,
    the shard's B_min and the cohort gather, all ``all_reduce``s — is
    captured with its collectives in the graph (after the eager warm-up
    made the communicator).  NCCL refuses two ranks on one card, so this
    is the only capture of collectives a one-card machine can run.
    Replays against the eager body, round by round; the launches counted
    are the replays' (captured launches x replays)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core.trees import tree_map
    from repro_torch.fl.fused_round import tree_row
    name, K = POP_RUNS[-1]
    init = os.path.join(MESH_DIR, "pg_nccl")
    if os.path.exists(init):
        os.remove(init)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("scenario", "clients"))
        eng = population_engine(name, K, load_store(
            os.path.join(MESH_DIR, f"{name}_store")), mesh=mesh)
        xs = population_xs(eng, K)
        eager, ref = eng.fresh_carry(), []
        for i in range(POP_ROUNDS):
            eager, ae = eng.step_eager(eager, tree_row(xs, i))
            ref.append((tree_map(torch.clone, eager.params), ae.ok, ae.a))
        graph = eng.fresh_carry()
        same, err = True, 0.0
        for i, (params, ok, a) in enumerate(ref):
            graph, ag = eng.step(graph, tree_row(xs, i))
            same &= bool(torch.equal(ok, ag.ok) and torch.equal(a, ag.a))
            err = max(err, max(float((x - y).abs().max()) for x, y in zip(
                _leaves(params), _leaves(graph.params))))
        torch.cuda.synchronize()
        launched = graph_counts(eng)
        _add(counts, launched)
        print(f"[mesh] 1-rank NCCL group (the only capture of collectives "
              f"a one-card machine runs: NCCL takes one rank a card), "
              f"{name} K={K} on a 1x1 ('scenario', 'clients') mesh: round "
              f"body {eng.round_body}, captures {eng.capture_count}, "
              f"{POP_ROUNDS} replays vs the eager body: schedules "
              f"{'identical' if same else 'DIFFER'}, params max|err| "
              f"{err:.3e} (atol {TOL_GRAPH:g}); launches a graph "
              f"{ {str(g): v for g, v in eng.graph_launches.items()} }, "
              f"the replays' {launched}")
        if eng.round_body != "captured" or eng.capture_count != 1 or \
                not same or err > TOL_GRAPH:
            raise AssertionError("mesh: the NCCL-captured client-sharded "
                                 "round differs from its eager body")
        # the graph holds NCCL kernels: free it while the group lives
        del eng, graph, eager, ref
    finally:
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


def launch_mesh_ranks():
    """``MESH_RANKS`` processes of this script on one gloo group
    (``repro_torch.launch.ranks``), each running ``mesh_rank``; every one
    is stopped before this returns, and a rank that fails fails the
    phase.  Returns each rank's JSON summary; its other lines are echoed."""
    from repro_torch.launch.ranks import Ranks
    init = os.path.join(MESH_DIR, "pg_gloo")
    if os.path.exists(init):
        os.remove(init)
    t0 = time.perf_counter()
    texts = Ranks([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                   init], MESH_RANKS, MESH_DIR, MESH_TIMEOUT).outputs()
    outs = []
    for r, text in enumerate(texts):
        lines = text.strip().splitlines()
        for line in lines[:-1]:
            print(f"  [rank {r}] {line}")
        outs.append(json.loads(lines[-1]))
    print(f"[mesh] {MESH_RANKS} ranks on the one card (gloo): "
          f"{time.perf_counter() - t0:.3f} s, start-up included")
    return outs


def mesh_kernel_phase(torch, ops, ref, found):
    """The kernels against their plain versions at the operands of the
    one-device eager rounds: the fusion loss at the population cohort,
    B_min on the K=5000 round and on each rank's slice of it (the rows a
    rank's B_min launch takes), the population kernel at the first launch
    of each P of that round's solve.  Returns (fusion cases, the first of
    each shape; population rows; B_min rows; max abs error per kernel)."""
    errs = {k: [] for k in ("fusion_loss_fwd", "fusion_loss_bwd",
                            "fusion_loss_reduce") + SOLVER_KERNELS}
    cases = {}
    for label, rec in found["fusion"].items():
        lg, lab, av, df, dm = rec["args"][:5]
        K, T = lab.shape
        c = dict(logits=list(lg), labels=lab, avail=av, d_fused=df,
                 d_modal=dm, seg=tuple(rec["args"][7]),
                 shape=(K, T, lg[0].shape[-1], len(lg)))
        fusion_check(torch, ops, ref, label, c, errs)
        if all(c["shape"] != o["shape"] for o in cases.values()):
            cases[label] = c
    label, (data, _, _, hp, launches) = found["solve"]
    K = data["gamma"].shape[0]
    bmin_check(torch, f"{label} B_min", data, hp, errs["jcsba_bmin_kernel"])
    n = K // MESH_RANKS
    bmin_rows = []
    for r in range(MESH_RANKS):
        d = dict(data, **{k: data[k][r * n:(r + 1) * n]
                          for k in ("gamma", "h", "tau_rem")})
        bmin_rows.append((f"{label} B_min, rank {r}'s {n} rows", d, hp))
        bmin_check(torch, bmin_rows[-1][0], d, hp,
                   errs["jcsba_bmin_kernel"])
    rows = []
    for i, (A, bm, ok, want_B) in enumerate(launches):
        P = A.shape[0]
        if any(r[2].shape[0] == P for r in rows):
            continue
        rows.append((f"{label} P={P} (launch {i})", data, A, bm, ok, want_B,
                     solver_work(torch, data, A, bm, ok, hp), hp))
        nfeas = solver_check(torch, rows[-1][0], data, A, bm, ok, hp,
                             errs["jcsba_population_kernel"])
        print(f"[solver] {rows[-1][0]}: {nfeas} of {P} rows feasible")
    return cases, rows, bmin_rows, {k: max(v) for k, v in errs.items()
                                    if v}


def mesh_phase(torch, counters, ops, ref):
    """Phase 7.  Returns (the launches of the phase's runs of the path —
    the one-device population sweeps (captured x replays), the
    NCCL-captured rounds' replays, and each rank's sweeps, zoo (captured x
    replays) and mesh server —, then ``mesh_kernel_phase``'s fusion cases,
    population rows, B_min rows and max errors)."""
    t_start = time.perf_counter()
    os.makedirs(MESH_DIR, exist_ok=True)
    print(f"[mesh] device memory at the phase's start: allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB", flush=True)
    counts, found = {}, {}
    single = {name: population_phase(torch, counters, name, K, counts, found)
              for name, K in POP_RUNS}
    nccl_capture_phase(torch, counts)
    outs = launch_mesh_ranks()
    for name, K in POP_RUNS:
        s = single[name]
        for o in outs:
            r = o[name]
            print(f"[mesh] rank {o['rank']} of a 1x2 ('scenario', "
                  f"'clients') mesh, {name} K={K}: round body "
                  f"{r['round_body']}, {r['store_rows']} client rows, "
                  f"store {r['store']:.4f} GiB ({r['store'] / s['store']:.3f}"
                  f" of one device's), peak {r['peak']:.4f} GiB "
                  f"({r['peak'] / s['peak']:.3f}); {r['ms']:.3f} ms a "
                  f"scenario-round (one device: {s['ms']:.3f}); vs the "
                  f"one-device sweep: schedules "
                  f"{'identical' if r['same'] else 'DIFFER'}, max|err| "
                  f"{r['err']:.3e} (rtol {TOL_SHARD['rtol']:g}, atol "
                  f"{TOL_SHARD['atol']:g}) {'ok' if r['close'] else 'FAIL'};"
                  f" B_min launches {r['bmin_launches']} on rows "
                  f"{r['bmin_rows']}")
            if not (r["same"] and r["close"]):
                raise AssertionError(f"mesh: rank {o['rank']} {name} sweep "
                                     f"differs from one device's")
            if name != "jcsba":
                continue
            n = len(POP_V) * POP_ROUNDS
            print(f"[mesh] rank {o['rank']} {name} K={K}: each of the "
                  f"{r['solves']} solves' B_min and ok (reassembled from "
                  f"the ranks' {K // MESH_RANKS}-row slices) and h "
                  f"(reassembled) against the B_min kernel on all {K} "
                  f"clients of the same round, one device: "
                  f"{'bit for bit' if r['bmin_same'] else 'DIFFER'}; "
                  f"clients with ok a solve {r['bmin_ok']}")
            if not r["bmin_launches"] or r["bmin_rows"] != [K // MESH_RANKS] \
                    or r["solves"] != n or not r["bmin_same"]:
                raise AssertionError(f"mesh: B_min not on K/2 rows, or its "
                                     f"reassembly differs from one "
                                     f"device's: {r}")
    for o in outs:
        z, v = o["zoo"], o["serve"]
        print(f"[mesh] rank {o['rank']} of a 2x1 ('scenario',) mesh: the "
              f"{z['rows']}-row zoo x {ZOO_ROUNDS} rounds, its block of "
              f"{z['block']} rows through its own captured round pair "
              f"(captures {z['captures']}): {z['wall']:.3f} ms = "
              f"{z['ms']:.3f} ms a scenario-round of the grid (PR 17 one "
              f"device, call 6: 17.987)"
              + ("" if z["same"] is None else
                 f"; vs the one-device zoo: schedules "
                 f"{'identical' if z['same'] else 'DIFFER'}, max|err| "
                 f"{z['err']:.3e} {'ok' if z['close'] else 'FAIL'}"))
        print(f"[mesh] rank {o['rank']}: ContinuousServer(mesh=) "
              f"qwen3-0.6b full width bf16, B={CONT_B}, {v['steps']} steps "
              f"with a hot swap after {v['steps'] // 2}: tokens "
              f"{'identical' if v['same'] else 'DIFFER'} to the unsharded "
              f"server's (run after the counts were read); placements "
              f"{v['placements']}; swap {v['swap_ms']:.3f} ms")
        if z["same"] is False or z["close"] is False or not v["same"]:
            raise AssertionError(f"mesh: rank {o['rank']}: the zoo or the "
                                 f"server differs from one device's")
        _add(counts, o["launches"])
    if outs[0]["serve"]["tokens"] != outs[1]["serve"]["tokens"]:
        raise AssertionError("mesh: the ranks' servers disagree")
    for k in MESH_KERNELS:
        if not counts.get(k):
            raise AssertionError(f"mesh: {k} was not launched")
    print(f"[mesh] launches {counts}; phase "
          f"{time.perf_counter() - t_start:.3f} s")
    return (counts,) + mesh_kernel_phase(torch, ops, ref, found)


def mesh_rank(rank, world, init):
    """One rank of ``launch_mesh_ranks``: the two population sweeps on a
    1×2 ("scenario", "clients") mesh, the zoo on a 2×1 ("scenario",) mesh,
    the continuous server on a mesh; prints its summary as JSON, last."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts as read
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fusion_loss import ops
    from repro_torch.kernels.jcsba_solver import ops as js_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.mesh import make_population_mesh, make_sweep_mesh

    def reset():
        for m in (ops, fa_ops, ssd_ops, js_ops):
            m.reset_launch_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores (one share each) and the one card
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        out = {"rank": rank, "launches": {}}
        pop = make_population_mesh(n_scenario=1)
        for name, K in POP_RUNS:
            out[name] = rank_population(torch, (reset, read), name, K, pop,
                                        out["launches"])
        sweep = make_sweep_mesh()
        out["zoo"], params, feats = rank_zoo(torch, (reset, read), sweep,
                                             rank, out["launches"])
        out["serve"] = rank_serve(torch, (reset, read), sweep, *params,
                                  feats, out["launches"])
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def rank_population(torch, counters, name, K, mesh, counts):
    """This rank's block of the population sweep: an engine holding K/2
    clients, a 1-round warm-up sweep, then the timed sweep with the
    counters set to 0 just before it (gloo: the body runs eagerly), the
    rows of each B_min launch and each solve's round data recorded on the
    way.  After the counts are read, each solve's reassembled B_min, ok
    and h are held against the B_min kernel on the whole round, as one
    device runs it."""
    from repro_torch.core.trees import tree_map
    from repro_torch.kernels.jcsba_solver import ops as js_ops
    from repro_torch.wireless import policies
    reset, read = counters
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = population_engine(name, K, load_store(
        os.path.join(MESH_DIR, f"{name}_store")), mesh=mesh)
    carry, xs = eng.fresh_carry(), population_xs(eng, K)
    eng.scan_v_grid(POP_V, carry, tree_map(lambda x: x[:1], xs), mesh=mesh)
    torch.cuda.synchronize()
    rows, solves = set(), []
    bmin0, solve0 = js_ops._launch_bmin, policies.solve_core

    def bmin_spy(gamma, *a, **kw):
        rows.add(int(gamma.shape[0]))
        return bmin0(gamma, *a, **kw)

    def solve_spy(data, *a):
        solves.append(dict(data))
        return solve0(data, *a)
    js_ops._launch_bmin, policies.solve_core = bmin_spy, solve_spy
    reset()
    try:
        t0 = time.perf_counter()
        out = eng.scan_v_grid(POP_V, carry, xs, mesh=mesh)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        js_ops._launch_bmin, policies.solve_core = bmin0, solve0
    launched = read()
    _add(counts, launched)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    same, err, close = sweep_err(torch, _cpu(out), torch.load(
        os.path.join(MESH_DIR, f"{name}_single.pt"), weights_only=False))
    bmin_same = None if not solves else True
    for i, d in enumerate(solves):
        h1 = xs.h[i % POP_ROUNDS]
        bm1, ok1 = js_ops.bmin(d["gamma"], h1, d["tau_rem"], d["B_max"],
                               d["p_tx"], d["N0"], eng.policy.hp)
        bmin_same &= bool(torch.equal(d["h"], h1)
                          and torch.equal(d["bmin"], bm1)
                          and torch.equal(d["bmin_ok"], ok1))
    res = dict(ms=wall / (len(POP_V) * POP_ROUNDS),
               store=_gib(eng._store.leaves()), peak=peak,
               store_rows=int(eng._store.labels.shape[0]),
               round_body=eng.round_body, same=same, err=err, close=close,
               bmin_launches=launched.get("jcsba_bmin_kernel", 0),
               bmin_rows=sorted(rows), solves=len(solves),
               bmin_same=bmin_same,
               bmin_ok=[int(d["bmin_ok"].sum()) for d in solves])
    del eng, out, solves
    torch.cuda.empty_cache()
    return res


def rank_zoo(torch, counters, mesh, rank, counts):
    """The 12-row zoo, this rank's block of rows: a 2-row sweep on the
    mesh captures each rank's round pair, then the whole zoo is timed with
    the counters set to 0 just before it; rank 0 also runs the one-device
    zoo (PR 17's path) as the reference, after the counts are read.
    Returns (summary, the engine's initial and row 0's final params, the
    zoo's first test features) for the server."""
    from repro_torch.core.trees import tree_map
    reset, read = counters
    specs = zoo_specs()
    grid, eng, xs, kw = zoo_engine(specs, ZOO_ROUNDS)
    S = grid.n
    eng.scan_scenario_grid(
        {k: v[:MESH_RANKS] for k, v in grid.overrides.items()},
        eng.fresh_carry(), tree_map(lambda x: x[:2], xs),
        stores=grid.stores.row(slice(0, MESH_RANKS)),
        test_sets=({m: x[:MESH_RANKS] for m, x in grid.test_features.items()},
                   grid.test_labels[:MESH_RANKS]), mesh=mesh)
    torch.cuda.synchronize()
    reset()
    since = dict(eng.replays)
    t0 = time.perf_counter()
    out = eng.scan_scenario_grid(grid.overrides, eng.fresh_carry(), xs,
                                 mesh=mesh, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launched = graph_counts(eng, since)
    _add(launched, read())
    _add(counts, launched)
    res = dict(rows=S, block=-(-S // MESH_RANKS), wall=wall,
               ms=wall / (S * ZOO_ROUNDS), captures=eng.capture_count,
               same=None, err=None, close=None)
    if rank == 0:
        ref = eng.scan_scenario_grid(grid.overrides, eng.fresh_carry(), xs,
                                     mesh=None, **kw)
        res["same"], res["err"], res["close"] = sweep_err(
            torch, _cpu(out), _cpu(ref))
    feats = {m: torch.as_tensor(x[0, :CONT_B])
             for m, x in sorted(grid.test_features.items())}
    return res, (eng._global_params0, tree_map(lambda x: x[0].clone(),
                                              out[0].params)), feats


def rank_serve(torch, counters, mesh, init, new, feats, counts):
    """Full-width qwen3-0.6b (bf16) served on the mesh on this rank:
    tokens step by step from the ``init`` fusion params, a hot swap to
    ``new`` halfway, the counters set to 0 just before the server is
    built and read just after its last step (the bulk prefill launches the
    attention kernel); then the same run of the server without a mesh,
    whose tokens the mesh server's must equal."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.continuous import ContinuousServer
    reset, read = counters
    cfg = get_config("qwen3-0.6b")
    lm = steps.init_fn(cfg)(torch.Generator(DEVICE).manual_seed(0))
    max_len = CONT_PROMPT + 2 * GRAPH_STEPS + 8
    prompts = np.random.default_rng(0).integers(0, 1000,
                                                (CONT_B, CONT_PROMPT))

    def serve(on):
        server = ContinuousServer(cfg, lm, init, feats, max_len=max_len,
                                  mesh=on, device=DEVICE)
        server.start(prompts)
        tokens, swap_ms = [], 0.0
        for step in range(2 * GRAPH_STEPS):
            if step == GRAPH_STEPS:
                swap_ms = server.swap(new) * 1e3
            server.decode_step()
            tokens.append(server.token.reshape(-1).tolist())
        return server, tokens, swap_ms
    reset()
    server, tokens, swap_ms = serve(mesh)
    _add(counts, read())
    placements = sorted({type(p).__name__ for ps in
                         _leaves(server.placements) for p in ps})
    del server
    torch.cuda.empty_cache()
    plain = serve(None)[1]
    del lm
    torch.cuda.empty_cache()
    return dict(steps=2 * GRAPH_STEPS, same=tokens == plain, tokens=tokens,
                placements=placements, swap_ms=swap_ms)


# ---------------------------------------------------------------------------
# the dry run and the examples
# ---------------------------------------------------------------------------
def dryrun_start():
    """Start one ``python -m repro_torch.launch.dryrun --device cuda``
    a combo of ``DRYRUN_COMBOS``, all together."""
    from repro_torch.launch import dryrun as D
    procs = [D.start_combo(arch, mesh, DRYRUN_DIR, shape_name=shape,
                           blocks=blocks, overrides=levers)
             for arch, shape, mesh, _, blocks, levers in DRYRUN_COMBOS]
    return procs, time.perf_counter()


def dryrun_finish(started, card):
    """Wait for the dry-run processes (each is stopped before this
    returns), hold every record's status to the CPU's, the ``DRYRUN_BAND``
    combos' batched products and the rest a rank to the JAX compile's
    dots a device, and ``DRYRUN_RATIO``'s per-rank FLOPs 2x16x16 / 16x16
    to the compile's."""
    import json
    from repro_torch.launch import dryrun as D
    with open(DRYRUN_REFERENCE) as f:
        ref = json.load(f)["combos"]
    procs, t0 = started
    bad = []
    per_rank = {}
    try:
        for (p, log), (arch, shape, mesh, want, blocks, levers) in zip(
                procs, DRYRUN_COMBOS):
            p.wait(timeout=DRYRUN_TIMEOUT)
            if p.returncode:
                with open(log) as f:
                    bad.append(f"dryrun {arch} {shape} {mesh}: exit "
                               f"{p.returncode}\n{f.read()[-3000:]}")
                continue
            tag = D.record_tag(arch, shape, mesh, levers, blocks)
            rec = D.read_record(DRYRUN_DIR, tag)
            coll = rec.get("collectives", {})
            split = (rec.get("counted_flops_global", 0)
                     / max(rec.get("counted_flops_per_rank", 0), 1))
            per_rank[arch, shape, mesh] = rec.get("counted_flops_per_rank")
            # a 2x16x16 combo: its per-rank FLOPs over the 16x16 combo's,
            # beside the JAX compile's dots'
            ratio = ""
            if mesh == "2x16x16" and per_rank.get((arch, shape, "16x16")):
                got = (rec.get("counted_flops_per_rank", 0)
                       / per_rank[arch, shape, "16x16"])
                dots = [sum(ref[arch][shape][m][k] for k in (
                    "batched_dot_flops", "other_dot_flops"))
                    for m in ("16x16", "2x16x16")]
                ratio = (f"; per-rank flops 2x16x16 / 16x16 {got}, the JAX "
                         f"compile's dots' {dots[1] / dots[0]}")
                if DRYRUN_RATIO[:2] == (arch, shape) and abs(
                        got / (dots[1] / dots[0]) - 1) > DRYRUN_RATIO[2]:
                    bad.append(f"dryrun {arch} {shape}: 2x16x16 / 16x16 "
                               f"{got} against the JAX compile's "
                               f"{dots[1] / dots[0]}")
            band = DRYRUN_BAND.get((arch, shape, mesh))
            if band and rec["status"] == "ok":
                j = ref[arch][shape][mesh]
                fb = rec["counted_batched_flops_per_rank"]
                for what, got, want_ in (
                        ("batched", fb, j["batched_dot_flops"]),
                        ("other", rec["counted_flops_per_rank"] - fb,
                         j["other_dot_flops"])):
                    print(f"[dryrun] {tag}: {what} flops a rank {got}, the "
                          f"JAX compile's {want_}: {got / want_}")
                    if abs(got / want_ - 1) > band:
                        bad.append(f"dryrun {tag}: {what} {got} against "
                                   f"the JAX compile's {want_}")
            print(f"[dryrun] {tag}: {rec['status']} step "
                  f"{rec.get('step_s')} s; counted flops a rank "
                  f"{rec.get('counted_flops_per_rank')} (global "
                  f"{rec.get('counted_flops_global')}, global / per-rank "
                  f"{split}); counted bytes a rank "
                  f"{rec.get('counted_bytes_per_rank')}; temporary peak a "
                  f"rank {rec.get('counted_peak_bytes_per_rank')} bytes; "
                  f"argument bytes a rank "
                  f"{rec.get('argument_size_in_bytes')}; collective "
                  f"operand bytes {coll.get('total_operand_bytes')} "
                  f"{coll.get('op_counts')}{ratio}")
            if rec["status"] != want:
                bad.append(f"dryrun {tag}: {rec['status']} on the card, "
                           f"{want} on the CPU: {rec.get('error')}")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"[dryrun] {len(procs)} combos: {time.perf_counter() - t0:.3f} s, "
          f"start-up included ({card})")
    if bad:
        raise AssertionError("\n".join(bad))


def load_example(name):
    """``examples/torch/<name>.py`` as a module (its ``main(argv)``)."""
    import importlib.util
    path = os.path.join(ROOT, "examples", "torch", name + ".py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch, counters, card, found, solves):
    """``[examples]``: each of ``EXAMPLES`` in this process with the
    counters set to 0 just before it and read after; fails if it raises
    or if a kernel of its path was not launched.  The operands each twin
    hands the kernel wrappers go into ``found`` (``GridOperands``: the
    first of each shape, from eager calls, also ahead of a graph capture)
    and its first JCSBA solve, with that solve's population launches,
    into ``solves`` (``SolverCapture``), for ``examples_kernel_phase``.
    Returns the summed launches."""
    reset, read = counters
    total = {}
    for name, args, kernels in EXAMPLES:
        mod = load_example(name)
        label = name + (f" {args[args.index('--arch') + 1]}"
                        if "--arch" in args else "")
        solve = SolverCapture()
        reset()
        t0 = time.perf_counter()
        with GridOperands(torch, found, label), solve:
            mod.main(["--device", "cuda", *args])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        now = read()
        print(f"[examples] {name} {' '.join(args)}: {dt:.3f} s ({card}); "
              f"launches {now}")
        for k in kernels:
            if not now[k]:
                raise AssertionError(f"examples: {name} did not launch {k}")
        if set(SOLVER_KERNELS) & set(kernels):
            if solve.seen is None:
                raise AssertionError(f"examples: {name}: no JCSBA solve "
                                     f"recorded")
            solves[label] = solve.seen
        for k, v in now.items():
            total[k] = total.get(k, 0) + v
    return total


def examples_kernel_phase(torch, ops, ref, found, solves):
    """The kernels against their plain versions at the operands the
    examples' twins recorded (``examples_phase``): the fusion loss,
    attention and the SSD chunk at each shape and the autograd Functions
    at their operands (``grid_kernel_phase``); B_min on each twin's first
    solve's round data and the population kernel at the first launch of
    each P of that solve.  Returns (fusion cases, attention cases, SSD
    cases, population rows, B_min rows, max abs error per kernel)."""
    cases, attn, ssd, errs = grid_kernel_phase(torch, ops, ref, found,
                                               tag="examples")
    serr = {k: [] for k in SOLVER_KERNELS}
    rows, bmin_rows = [], []
    for label, (data, _, _, hp, launches) in solves.items():
        K = data["gamma"].shape[0]
        bmin_rows.append((f"examples {label} B_min", data, hp))
        bmin_check(torch, bmin_rows[-1][0], data, hp,
                   serr["jcsba_bmin_kernel"])
        for i, (A, bm, ok, want_B) in enumerate(launches):
            P = A.shape[0]
            if any(r[2].shape == A.shape for r in rows):
                continue
            rows.append((f"examples {label} P={P} K={K} (launch {i})", data,
                         A, bm, ok, want_B,
                         solver_work(torch, data, A, bm, ok, hp), hp))
            nfeas = solver_check(torch, rows[-1][0], data, A, bm, ok, hp,
                                 serr["jcsba_population_kernel"])
            print(f"[solver] {rows[-1][0]}: {nfeas} of {P} rows feasible")
    empty = [k for k, v in serr.items() if not v]
    if empty:
        raise AssertionError(f"examples: no operands recorded for {empty}")
    errs.update({k: max(v) for k, v in serr.items()})
    return cases, attn, ssd, rows, bmin_rows, errs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 1
    from repro_torch.fl.eval import metric_keys
    from repro_torch.fl.runtime import MFLExperiment
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fusion_loss import ops, ref
    from repro_torch.kernels.jcsba_solver import ops as js_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = gpu_line()
    print(f"[gpu] {card}")
    t_start = time.perf_counter()

    def reset_counts():
        for m in (ops, fa_ops, ssd_ops, js_ops):
            m.reset_launch_counts()

    from repro_torch.kernels import launch_counts as read_counts

    # phase 1: build
    build_phase()

    # phase 2: the main path's experiments, and the kernels against their
    # plain versions at the shapes those experiments give them
    exps = {}
    for arch, dataset, _ in MAIN_PATH:
        t0 = time.perf_counter()
        exps[arch, dataset] = MFLExperiment(dataset, arch=arch, **MAIN_KW)
        print(f"[main] {arch}/{dataset}: set-up "
              f"{time.perf_counter() - t0:.3f} s")
    cases, max_err = kernel_phase(
        torch, ops, ref, {d: e for (a, d), e in exps.items()
                          if a == "lstm-cnn"})
    found = capture_backbone_operands(
        torch, {key: e for key, e in exps.items() if key[0] != "lstm-cnn"})
    attn, ssd, bb_err = backbone_kernel_phase(torch, found)
    max_err.update(bb_err)

    # phase 3: the main path, counters set to 0 just before and read after
    # each run
    launches = {k: 0 for k in read_counts()}
    capture = SolverCapture()
    for arch, dataset, rounds in MAIN_PATH:
        label = f"{arch}/{dataset}"
        reset_counts()
        if (arch, dataset) == ("lstm-cnn", "crema_d"):
            with capture:
                run_experiment(torch, exps[arch, dataset], metric_keys,
                               label, rounds)
        else:
            run_experiment(torch, exps[arch, dataset], metric_keys, label,
                           rounds)
        now = read_counts()
        print(f"[main] {label} launches ({rounds} rounds): {now}; solver "
              f"kernels a round: "
              + ", ".join(f"{k} {now[k] / rounds:g}" for k in SOLVER_KERNELS))
        for name in ARCH_KERNELS[arch]:
            if not now[name]:
                raise AssertionError(f"{name} was not launched by {label}")
        for k, v in now.items():
            launches[k] += v
    if launches["fusion_loss_reduce"]:
        raise AssertionError("the training step launched the partial reduce")
    for arch in ("transformer", "ssd"):
        remat_phase(torch, MFLExperiment, (reset_counts, read_counts), arch)
    for arch, dataset, rounds in MAIN_PATH:
        twin_phase(torch, MFLExperiment, arch, dataset, min(rounds, 2))
    solver_twin_phase(torch, MFLExperiment)
    seq_round_phase(torch, MFLExperiment, exps["lstm-cnn", "crema_d"])
    baseline_phase(torch, MFLExperiment, (reset_counts, read_counts))
    for arch in ("lstm-cnn", "transformer", "ssd"):
        profile_round(torch, exps[arch, "crema_d"], f"{arch}/crema_d")

    # phase 3a: the seq and fused loops, each with the counters set to 0
    # just before it
    counters = (reset_counts, read_counts)
    by_path = {"seq": seq_phase(torch, MFLExperiment, counters)}
    by_path["fused"] = fused_phase(torch, MFLExperiment, counters)
    for arch in ("transformer", "ssd"):
        for k, v in fused_backbone_phase(torch, MFLExperiment,
                                         arch).items():
            by_path["fused"][k] = by_path["fused"].get(k, 0) + v
    fused_twin_phase(torch, MFLExperiment)

    # phase 3c: the scenario axis — the zoo, the V grid, the backbones'
    # grids (launches: each timed grid run's captured launches times its
    # replays, the capturing 1-row grids left out), the kernels at the
    # grids' recorded operands, and the population kernel reading V from
    # the device in a captured graph
    grid_found = {}
    runs = [zoo_phase(torch, counters, grid_found),
            v_grid_phase(torch, MFLExperiment, counters, grid_found)]
    runs += [arch_grid_phase(torch, arch, counters, grid_found)
             for arch in ("transformer", "ssd")]
    by_path["scenario"] = {}
    for counts in runs:
        for k, v in counts.items():
            by_path["scenario"][k] = by_path["scenario"].get(k, 0) + v
    g_cases, g_attn, g_ssd, g_err = grid_kernel_phase(torch, ops, ref,
                                                      grid_found)
    for k, v in g_err.items():
        max_err[k] = max(max_err[k], v)
    # timed beside the main path's shapes (``other_shapes``)
    cases.update(g_cases)
    attn += g_attn
    ssd += g_ssd
    v_err = grid_v_graph_phase(torch)

    # phase 5: serving — each full-width serve run with the counters set
    # to 0 just before it; the card against the CPU, the kernel prefill
    # against the plain one, the decode graph against the eager step;
    # the kernels at the serving shapes (timed beside the others); the
    # continuous server beside fused rounds
    serve_found = {}
    by_path["serve"] = serve_phase(torch, counters, serve_found)
    serve_twin_phase(torch)
    serve_checks_phase(torch)
    s_attn, s_ssd, s_err = serving_kernel_phase(torch, serve_found)
    for k, v in s_err.items():
        max_err[k] = max(max_err[k], v)
    attn += s_attn
    ssd += s_ssd
    by_path["continuous"] = continuous_phase(torch, counters)

    # phase 6: training — the full-width train runs (counters set to 0
    # just before each), card vs CPU, the MoE serve (counted with the
    # serve runs), the kernels at the train operands (timed with the
    # others)
    by_path["train"], moe, t_cases, t_attn, t_ssd, t_err = train_section(
        torch, counters, ops, ref)
    for k, v in moe.items():
        by_path["serve"][k] = by_path["serve"].get(k, 0) + v
    for k, v in t_err.items():
        max_err[k] = max(max_err[k], v)
    cases.update(t_cases)
    attn += t_attn
    ssd += t_ssd

    # phase 7: the multi-device layer — population-scale sweeps on one
    # device and client-sharded on two ranks of the card, the zoo
    # scenario-sharded, the NCCL-captured client round, the server on a
    # mesh (counters set to 0 just before each run, the ranks' summed);
    # the kernels at the operands these runs recorded (timed with the
    # others)
    by_path["mesh"], m_cases, m_rows, m_bmin, m_err = mesh_phase(
        torch, counters, ops, ref)
    cases.update(m_cases)

    # phase 8: the LM-scale dry run in subprocesses (no kernel: impl="xla"
    # on fake tensors), while the examples' twins run here on the card,
    # each with the counters set to 0 just before it
    started = dryrun_start()
    ex_found, ex_solves = {}, {}
    try:
        by_path["examples"] = examples_phase(torch, counters, card,
                                             ex_found, ex_solves)
    finally:
        dryrun_finish(started, card)
    # the kernels at the operands the twins recorded (timed with the
    # others)
    e_cases, e_attn, e_ssd, e_rows, e_bmin, e_err = examples_kernel_phase(
        torch, ops, ref, ex_found, ex_solves)
    cases.update(e_cases)
    attn += e_attn
    ssd += e_ssd

    # phase 3b: the solver kernels at the main path's captured round
    solver_rows_, _, solver_err = solver_phase(torch, capture.seen)
    solver_err["jcsba_population_kernel"] = max(
        solver_err["jcsba_population_kernel"], v_err)
    max_err.update(solver_err)
    for k, v in list(m_err.items()) + list(e_err.items()):
        max_err[k] = max(max_err[k], v)

    # phase 4: times
    floor = floor_ms(torch)
    print(f"[floor] one-element add_: device "
          + ("not measured" if floor is None else f"{floor:.6f} ms")
          + f" ({card})")
    times = timing_phase(torch, ops, ref, cases)
    bb_times = backbone_timing_phase(torch, attn, ssd)
    # the examples' population rows at shapes no other phase timed
    def pop_shape(r):
        return tuple(r[2].shape), r[1]["zeta2"].shape[0], r[5]

    timed = {pop_shape(r) for r in solver_rows_ + m_rows}
    e_rows = [r for r in e_rows if pop_shape(r) not in timed]
    bb_times.update(solver_timing_phase(torch, solver_rows_ + m_rows
                                        + e_rows, m_bmin + e_bmin))

    def entry(name):
        rows = (bb_times[name] if name in bb_times else
                [times[label][name] for label in times])
        row = rows[0]
        return {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            # the batched main path's launches are ``launches``; the seq
            # loop's, the fused loop's and the four timed scenario grids'
            # (captured times replays), the serve runs' (the MoE serve
            # included), the continuous server's, the train steps'
            # (``[train]``), the multi-device phase's (``[mesh]``) and the
            # examples' twins' (``[examples]``)
            "launches_by_path": {"batched": launches[name],
                                 **{p: c.get(name, 0)
                                    for p, c in by_path.items()}},
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "shape": row["shape"],
            "other_shapes": rows[1:],
            **({"tpu_kernel": "none: XLA fuses jaxsolver.solve_core; the "
                              "JAX package has no pallas_call for it"}
               if name in SOLVER_KERNELS else {}),
        }

    # the partial reduce runs only where gsq/gdot are asked for
    # (fusion_loss_grads), not on the main path
    print("[reduce] " + json.dumps(entry("fusion_loss_reduce")))
    kernels = [entry(name) for name in PATH_KERNELS]
    print(f"[done] {time.perf_counter() - t_start:.3f} s after the card "
          f"check")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:         # a rank of phase 7
        sys.exit(mesh_rank(int(sys.argv[3]), int(sys.argv[4]), sys.argv[2]))
    sys.exit(main())
