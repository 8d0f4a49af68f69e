"""What every traffic mix's driver shares.  A mix file names its driver
(``"driver": "<name>"``), and the driver is the ``Driver`` class of
``bench/drivers/<name>.py``, found by that name as a per-layer metric's
reader is (``spec.driver_class``); it is fed only by the mix's parameters.

A driver builds the experiment from the configuration, the mix and the
seed (``setup``), runs one timed call (``call``, returning the
scenario-rounds it completed), and after the window judges what the timed
path produced against the reference (``check``).  For the calibration
(``bench/calibrate.py``) it also drives what the check follows beyond
set-up (``checked_call``) and can put the reference at TF32 in the
program's place (``use_control``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..reference import fl as ref_fl
from . import spec


def mflexperiment(cell, seed: int, device):
    """The cell's ``MFLExperiment``, built from its configuration and mix."""
    from repro_torch.fl.runtime import MFLExperiment
    from repro_torch.wireless.params import WirelessParams
    t = cell.traffic
    params = WirelessParams(K=int(t["K"]), **t.get("wireless", {}))
    return MFLExperiment(cell.config["dataset"], scheduler=t["scheduler"],
                         K=int(t["K"]), omega=t["omega"],
                         n_samples=int(t["n_samples"]), V=float(t["V"]),
                         eta=float(cell.config["train"]["eta"]),
                         seed=int(seed), params=params,
                         eval_every=int(t["eval_every"]), engine=t["engine"],
                         device=device)


def check_widths(exp, config):
    """The program's weights have the configuration's shapes (the
    reference builds its models from the configuration's widths)."""
    want = ref_fl.named_leaves(ref_fl.models.init_model(config, 0))
    got = ref_fl.named_leaves(exp.init_params)
    bad = sorted(k for k in set(want) | set(got)
                 if k not in want or k not in got
                 or tuple(want[k].shape) != tuple(got[k].shape))
    if bad:
        raise RuntimeError(f"the program's model departs from the "
                           f"configuration's widths at {bad}")


class Driver:
    #: a traced part holds a whole number of these calls, so that its
    #: counts a round repeat exactly from run to run
    trace_period = 1

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.calls: List[dict] = []

    def build(self):
        """The experiment, checked against the configuration's widths, and
        which clients own which modality."""
        self.exp = exp = mflexperiment(self.cell, self.seed, self.device)
        check_widths(exp, self.cell.config)
        self.mods = sorted(exp.all_mods)
        self.has = np.array([[m in cm for cm in exp.client_mods]
                             for m in self.mods])
        return exp

    def upload(self, ok) -> np.ndarray:
        """[M, K] clients that upload each modality, from a round's [K]
        participants (JCSBA drops no modality: a participant uploads every
        modality it owns)."""
        return self.has & np.asarray(ok, bool)[None]

    def loss_shape(self):
        """(K, T, V, M) of the cohort's fusion loss."""
        t = self.cell.traffic
        return (int(t["K"]), int(max(self.exp.data_sizes)),
                int(self.cell.config["classes"]),
                len(self.cell.config["modalities"]))

    def checked_call(self):
        """Drive what the check follows beyond set-up (nothing, where
        set-up drives it)."""

    def setup(self):
        raise NotImplementedError

    def call(self) -> int:
        raise NotImplementedError

    def call_flops(self, c) -> float:
        raise NotImplementedError

    def check(self) -> Dict[str, float]:
        raise NotImplementedError

    def use_control(self):
        raise NotImplementedError


def make(cell, seed: int, device) -> Driver:
    return spec.driver_class(cell.traffic["driver"])(cell, seed, device)
