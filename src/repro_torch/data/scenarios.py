"""Scenario library — FedMultimodal-style heterogeneity axes as data.

A numpy copy of the JAX package's ``data/scenarios.py``: the same spec,
the same numpy stream, so the stores, test splits and solver-data rows
equal the JAX package's bit for bit.

The paper's experiments fix one data regime (synthetic IEMOCAP/CREMA-like,
uniform IID shards, one scalar ω).  Real federated deployments differ along
several independent axes, which the FedMultimodal benchmark suite names
precisely: how clients are *split* (natural speaker/device groups vs
Dirichlet-α label skew vs IID), which modalities each client *has* (per-
modality missingness), and how *corrupted* the features are (noise,
erasure, test-time missing modalities).  ``ScenarioSpec`` freezes one point
of that product space; ``build_scenario`` materialises it as a vectorized
``ClientStore`` + held-out test split; ``stack_scenarios`` stacks many specs
into the ``(overrides, stores, test sets)`` triple that
``FusedRoundEngine.scan_scenario_grid`` sweeps — a scenario *zoo* instead
of a V-line.

Everything is built on the ``data/partition.py`` substrate
(``missing_masks``: every client keeps ≥1 modality, every modality keeps
≥1 owner, for any feasible per-modality ω_m), with pure array ops — no
per-client Python loops — so zoo rows scale to population-sized K.

Grid rows must share K, n_per_client, the modality set and feature shapes
(one captured round replays every row); everything else — split law, ω_m
vectors, SNRs, corruption, V, seeds — varies freely per row.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..core import aggregation as agg
from ..models.config import FL_ARCHS
from ..wireless.cost import population_costs
from .partition import (ClientStore, missing_counts, missing_masks,
                        normalize_omegas)

#: feature shapes + class counts of the synthetic stand-in corpora
#: (data/synthetic.py) — the shapes ``PaperModelAdapter`` builds models for
DATASET_SHAPES = {"iemocap": ({"audio": (32, 11), "text": (24, 100)}, 10),
                  "crema_d": ({"audio": (32, 11), "image": (32, 32, 3)}, 6)}

SPLIT_LAWS = ("iid", "dirichlet", "natural")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One frozen point of the scenario product space.

    * ``split`` — client split law: ``"iid"`` (uniform label draws),
      ``"dirichlet"`` (per-client class distribution ~ Dir(α·1), small α =
      strong label skew), ``"natural"`` (``n_groups`` speaker/device groups:
      group-level Dir(α) label distributions plus a per-group feature offset
      of scale ``group_sigma`` — clients in a group look alike, the
      FedMultimodal natural-split regime);
    * ``omega`` / ``snr`` — per-modality missing ratio and class-signal
      scale; scalar, mapping or sorted-modality-order sequence (broadcast
      rules of ``data.partition.normalize_omegas``);
    * corruption — ``noise_sigma`` adds feature noise, ``erasure_rate``
      zeroes whole (client, sample, modality) feature blocks (sensor
      dropouts that still carry Eq.-12 weight), ``test_missing`` zeroes one
      modality of the *test* split (deployment-time missing sensor);
    * ``V`` — the Lyapunov drift penalty: the old V-grid is just this field
      varying across rows;
    * ``arch`` — the model-family axis (``models.config.FL_ARCHS``):
      ``"lstm-cnn"`` (the paper's submodels) or a transformer/SSD encoder
      stack (``fl.client.make_adapter``).  Param pytrees differ per arch,
      so one captured round covers one arch — grid rows must agree
      (Table 3 × {lstm-cnn, transformer, ssd} is three stacked grids).
    """
    name: str = ""
    dataset: str = "iemocap"
    K: int = 10
    n_per_client: int = 8
    n_test: int = 128
    split: str = "iid"
    alpha: float = 0.5
    n_groups: int = 4
    group_sigma: float = 1.0
    omega: object = 0.3
    snr: object = 1.0
    noise_sigma: float = 0.0
    erasure_rate: float = 0.0
    test_missing: Optional[str] = None
    V: float = 1.0
    seed: int = 0
    arch: str = "lstm-cnn"

    def __post_init__(self):
        if self.dataset not in DATASET_SHAPES:
            raise ValueError(f"unknown dataset {self.dataset!r}; "
                             f"choose from {sorted(DATASET_SHAPES)}")
        if self.arch not in FL_ARCHS:
            raise ValueError(f"unknown arch {self.arch!r}; "
                             f"choose from {FL_ARCHS}")
        if self.split not in SPLIT_LAWS:
            raise ValueError(f"unknown split {self.split!r}; "
                             f"choose from {SPLIT_LAWS}")
        if self.split != "iid" and not self.alpha > 0:
            raise ValueError(f"split={self.split!r} needs alpha > 0")
        if self.split == "natural" and self.n_groups < 1:
            raise ValueError("natural split needs n_groups >= 1")
        if not 0.0 <= self.erasure_rate <= 1.0:
            raise ValueError("erasure_rate must lie in [0, 1]")
        mods = self.modalities
        if self.test_missing is not None and self.test_missing not in mods:
            raise ValueError(f"test_missing={self.test_missing!r} is not a "
                             f"{self.dataset} modality {mods}")
        # normalize omega/snr to per-modality tuples up front so invalid
        # specs fail at construction, not mid-sweep
        object.__setattr__(self, "omega",
                           normalize_omegas(self.omega, mods))
        object.__setattr__(self, "snr", normalize_omegas(self.snr, mods))
        missing_counts(self.K, self.omega)      # range / feasibility check

    @property
    def modalities(self) -> Tuple[str, ...]:
        return tuple(sorted(DATASET_SHAPES[self.dataset][0]))

    @property
    def n_classes(self) -> int:
        return DATASET_SHAPES[self.dataset][1]

    def label(self) -> str:
        if self.name:
            return self.name
        om = "/".join(f"{w:g}" for w in self.omega)
        bits = [self.split, f"om={om}", f"V={self.V:g}"]
        if self.arch != "lstm-cnn":
            bits.append(self.arch)
        if self.noise_sigma:
            bits.append(f"noise={self.noise_sigma:g}")
        if self.erasure_rate:
            bits.append(f"erase={self.erasure_rate:g}")
        if self.test_missing:
            bits.append(f"no-{self.test_missing}")
        return ",".join(bits)


def _smooth(protos: np.ndarray) -> np.ndarray:
    """Two-pass smoothing along the leading feature axis (the temporal /
    spatial axis of every modality here), as data/synthetic.py does, so
    sequence models can integrate evidence."""
    for _ in range(2):
        protos[:, 1:] = 0.5 * (protos[:, 1:] + protos[:, :-1])
    return protos


def _sample_labels(rng, p: np.ndarray, n: int) -> np.ndarray:
    """Vectorized categorical draws: one row of ``p`` [R, C] per row of the
    output [R, n]."""
    cdf = np.cumsum(p, axis=-1)
    u = rng.random((p.shape[0], n))
    return np.minimum((u[..., None] > cdf[:, None, :]).sum(-1),
                      p.shape[1] - 1).astype(np.int32)


def build_scenario(spec: ScenarioSpec, params):
    """Materialise one spec → ``(ClientStore, test_features, test_labels)``.

    Pure array ops throughout (no per-client loops); ``params`` is the
    ``WirelessParams`` whose Eqs. 15-18 fill the store's cost vectors
    (``wireless.cost.population_costs`` over the ownership masks).  The rng
    draw order is fixed (masks → label laws → labels → per-modality protos/
    noise/corruption) so a spec is a complete, reproducible description."""
    from ..wireless.params import MODALITY_PROFILES

    shapes, C = DATASET_SHAPES[spec.dataset]
    mods = spec.modalities
    K, n, nt = spec.K, spec.n_per_client, spec.n_test
    rng = np.random.default_rng(spec.seed)

    miss = missing_masks(K, spec.omega, rng)
    has = {m: ~miss[i] for i, m in enumerate(mods)}

    groups = (np.arange(K) * spec.n_groups) // K    # contiguous blocks
    if spec.split == "iid":
        labels = rng.integers(0, C, (K, n)).astype(np.int32)
    elif spec.split == "dirichlet":
        p = rng.dirichlet([spec.alpha] * C, size=K)
        labels = _sample_labels(rng, p, n)
    else:                                           # natural groups
        p_g = rng.dirichlet([spec.alpha] * C, size=spec.n_groups)
        labels = _sample_labels(rng, p_g[groups], n)
    test_labels = rng.integers(0, C, nt).astype(np.int32)

    feats: Dict[str, np.ndarray] = {}
    test_feats: Dict[str, np.ndarray] = {}
    snrs = dict(zip(mods, spec.snr))
    for m in mods:
        shape = tuple(shapes[m])
        protos = _smooth(rng.standard_normal((C,) + shape).astype(np.float32))
        x = (protos[labels] * np.float32(snrs[m])
             + rng.standard_normal((K, n) + shape).astype(np.float32))
        if spec.split == "natural" and spec.group_sigma:
            offs = rng.standard_normal(
                (spec.n_groups,) + shape).astype(np.float32)
            x = x + np.float32(spec.group_sigma) * offs[groups][:, None]
        if spec.noise_sigma:
            x = x + np.float32(spec.noise_sigma) * rng.standard_normal(
                x.shape).astype(np.float32)
        if spec.erasure_rate:
            erased = rng.random((K, n)) < spec.erasure_rate
            x = np.where(erased[(...,) + (None,) * len(shape)], 0.0, x)
        own = has[m].reshape((K,) + (1,) * (len(shape) + 1))
        feats[m] = (x * own).astype(np.float32)
        # held-out split: clean draws from the same prototypes (corruption
        # models the *clients'* sensors), except a deployment-time missing
        # modality, which zeroes the whole test block
        tx = (protos[test_labels] * np.float32(snrs[m])
              + rng.standard_normal((nt,) + shape).astype(np.float32))
        if spec.test_missing == m:
            tx = np.zeros_like(tx)
        test_feats[m] = tx.astype(np.float32)

    cost = population_costs(has, mods, np.full(K, float(n)),
                            MODALITY_PROFILES[spec.dataset], params)
    store = ClientStore(
        feats, labels, np.ones((K, n), np.float32), has,
        np.full(K, float(n), np.float32),
        cost.gamma_bits.astype(np.float32),
        cost.tau_cmp.astype(np.float32),
        cost.e_cmp.astype(np.float32), mods)
    return store, test_feats, test_labels


def scenario_overrides(store: ClientStore, params, V: float) -> dict:
    """The per-scenario solver-data row ``scan_scenario_grid`` consumes:
    every template entry that depends on the scenario's population —
    ownership, Eq. 12 weight denominators, Eqs. 15-18 costs — plus its V."""
    mods = store.modalities
    has = np.stack([np.asarray(store.has_modality[m], bool) for m in mods])
    sizes = np.asarray(store.sizes, np.float64)
    wbar = agg.stacked_weights(sizes, {m: has[i] for i, m in
                                       enumerate(mods)})
    tau_cmp = np.asarray(store.tau_cmp, np.float64)
    return {"V": np.float64(V),
            "gamma": np.asarray(store.gamma_bits, np.float64),
            "tau_rem": params.tau_max - tau_cmp,
            "tau_cmp": tau_cmp,
            "e_cmp": np.asarray(store.e_cmp, np.float64),
            "has": has, "D": sizes,
            "wbar": np.stack([wbar[m] for m in mods])}


class ScenarioGrid(NamedTuple):
    """Stacked zoo: leaves carry a leading [S] scenario axis."""
    overrides: dict                 # solver-data rows (scan_scenario_grid)
    stores: ClientStore             # [S]-leading ClientStore leaves
    test_features: Dict[str, np.ndarray]
    test_labels: np.ndarray         # [S, n_test]
    specs: Tuple[ScenarioSpec, ...]

    @property
    def n(self) -> int:
        return len(self.specs)

    def store_row(self, s: int) -> ClientStore:
        """Scenario ``s``'s un-stacked store (e.g. to seed an engine)."""
        return self.stores.row(s)


def stack_scenarios(specs: Sequence[ScenarioSpec], params) -> ScenarioGrid:
    """Build + stack a zoo.  All specs must agree on dataset geometry
    (K, n_per_client, n_test, modality set) — one captured round replays
    every row of the grid; the heterogeneity axes vary per row."""
    specs = tuple(specs)
    if not specs:
        raise ValueError("empty scenario grid")
    s0 = specs[0]
    for s in specs[1:]:
        same = (s.dataset == s0.dataset and s.K == s0.K
                and s.n_per_client == s0.n_per_client
                and s.n_test == s0.n_test and s.arch == s0.arch)
        if not same:
            raise ValueError(
                f"grid rows must share dataset/K/n_per_client/n_test/arch; "
                f"{s.label()!r} differs from {s0.label()!r}")
    built = [build_scenario(s, params) for s in specs]
    stores = ClientStore.stack([b[0] for b in built])
    test_feats = {m: np.stack([b[1][m] for b in built])
                  for m in s0.modalities}
    test_labels = np.stack([b[2] for b in built])
    rows = [scenario_overrides(b[0], params, s.V)
            for b, s in zip(built, specs)]
    overrides = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    return ScenarioGrid(overrides, stores, test_feats, test_labels, specs)
