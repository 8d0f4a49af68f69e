"""The whole round's share of the card's float32 peak, in %: the model
FLOPs of the rounds of the measured window (``harness/counts.py``: three
forward passes a training sample of every client that uploads a modality,
over its samples, plus the held-out forward on eval rounds; products and
convolutions only) ÷ the window's wall time (host clock) ÷ 67 TFLOP/s,
the published float32 rate of an H100 SXM outside the tensor cores.  The
run sets TF32 off (the configuration's precision), so no product runs on
the tensor cores.  Layer: the whole round (the cohort step of
fl/client.py over models/paper_models.py, and fl/eval.py)."""
from bench.harness.peaks import F32_FLOPS


def read(run):
    if run.device == "cpu" or run.window_s <= 0 or run.flops <= 0:
        return None
    return 100.0 * run.flops / run.window_s / F32_FLOPS
