"""The operation and byte counts at known shapes, worked by hand."""
import json
import os

import numpy as np
import pytest

from bench.harness import counts

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def _config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def test_lstm_flops_by_hand():
    spec = {"steps": 3, "input": 2, "hidden": 4, "layers": 2, "fc": 5}
    # a step: layer 0 2·(2·16 + 4·16) = 192, layer 1 2·(4·16 + 4·16) = 256
    assert counts.lstm_forward_flops(spec, 7) == 3 * (192 + 256) + 2 * 4 * 5 \
        + 2 * 5 * 7


def test_cnn_flops_by_hand():
    spec = {"height": 6, "channels": 1, "kernel": 3, "filters": 2,
            "conv_layers": 2, "pool_stride": 3, "fc": [4]}
    # conv 0 at 6x6: 2·36·2·9·1; pool to 2x2; conv 1: 2·4·2·9·2; pool to 1x1
    want = 2 * 36 * 2 * 9 + 2 * 4 * 2 * 9 * 2 + 2 * 2 * 4 + 2 * 4 * 3
    assert counts.cnn_forward_flops(spec, 3) == want


@pytest.mark.parametrize("name, want", [
    ("crema_d", {"audio": 2066400, "image": 4223872}),
    ("iemocap", {"audio": 2066800, "text": 3234000})])
def test_paper_models_forward_flops(name, want):
    cfg = _config(name)
    assert {m: counts.forward_flops(cfg, m) for m in cfg["modalities"]} \
        == want


def test_round_flops_counts_uploads_and_eval():
    cfg = _config("iemocap")
    D = np.array([10, 20, 30])
    up = np.array([[1, 0, 1], [0, 1, 0]], bool)      # audio, text rows
    a, t = 2066800, 3234000
    train = 3 * (a * (10 + 30) + t * 20)
    assert counts.round_flops(cfg, D, up, 5, False) == train
    assert counts.round_flops(cfg, D, up, 5, True) == train + 5 * (a + t)


def test_fusion_entry_counts():
    # logits and their gradient 2·2·10·96·6, labels and mask 2·10·96,
    # avail 2·10, loss and upstream gradient 2·10, four bytes each
    assert counts.fusion_entry_bytes(10, 96, 6, 2) == 4 * (
        2 * 2 * 10 * 96 * 6 + 2 * 10 * 96 + 2 * 10 + 2 * 10) == 100000
    assert counts.fusion_entry_flops(10, 96, 6, 2) == 10 * 96 * (
        2 * 6 + 5 * 6 * 3 + 4 * 6 * 3)
