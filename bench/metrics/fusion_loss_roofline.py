"""The fusion loss's public entry (kernels/fusion_loss via
``fused_multimodal_loss``, forward and backward as the cohort step calls
it) at the cell's loss shapes (K, T, V, M), as a share of its roofline, in
%: max(bytes once ÷ 3.35 TB/s, operations ÷ 67 TFLOP/s) ÷ its device time.
The time is the entry captured 20 times in one CUDA graph, replayed under
the profiler, and taken from the trace as the union of the replays'
kernel intervals, so it holds no launch cost and measures the same work
whatever implements the entry.  Counts: ``harness/counts.py``."""
import torch

from bench.harness import counts, peaks


def read(run):
    if run.device == "cpu":
        return None
    from repro_torch.kernels.fusion_loss.ops import fused_multimodal_loss
    K, T, V, M = run.loss_shape()
    gen = torch.Generator(device="cuda").manual_seed(0)
    mods = sorted(run.cell.config["modalities"])
    logits = {m: torch.randn((K, T, V), generator=gen, device="cuda")
              .requires_grad_() for m in mods}
    labels = torch.randint(0, V, (K, T), generator=gen, device="cuda",
                           dtype=torch.int32)
    avail = {m: torch.ones(K, device="cuda") for m in mods}
    mask = torch.ones((K, T), device="cuda")
    vw = run.cell.config["train"]["v_weights"]
    leaves = [logits[m] for m in mods]

    def entry():
        total, _ = fused_multimodal_loss(logits, labels, vw, avail=avail,
                                         sample_mask=mask)
        return torch.autograd.grad(total.sum(), leaves)

    seconds = run.device_time_in_graph(entry)
    bound = max(counts.fusion_entry_bytes(K, T, V, M) / peaks.HBM_BYTES_PER_S,
                counts.fusion_entry_flops(K, T, V, M) / peaks.F32_FLOPS)
    return 100.0 * bound / seconds
