# Frozen copy of the numpy functions of src/repro/data/partition.py that
# split the data among the clients, kept verbatim so the reference derives
# the same partition from the seed without importing the program.
"""Client partitioning with modality heterogeneity (§VI "Datasets")."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from .synthetic import MultimodalDataset


@dataclasses.dataclass
class ClientData:
    dataset: MultimodalDataset          # only this client's modalities
    modalities: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.dataset)


def normalize_omegas(omega, modalities: Sequence[str]) -> Tuple[float, ...]:
    """Broadcast a scalar ω / per-modality mapping / sequence to one ω_m per
    modality, in ``sorted(modalities)`` order."""
    mods = tuple(sorted(modalities))
    if isinstance(omega, Mapping):
        unknown = set(omega) - set(mods)
        if unknown:
            raise ValueError(f"omega names unknown modalities {sorted(unknown)}")
        return tuple(float(omega.get(m, 0.0)) for m in mods)
    if np.ndim(omega) == 0:
        return (float(omega),) * len(mods)
    omegas = tuple(float(w) for w in omega)
    if len(omegas) != len(mods):
        raise ValueError(
            f"got {len(omegas)} omega values for {len(mods)} modalities")
    return omegas


def missing_counts(K: int, omegas: Sequence[float]) -> np.ndarray:
    """Realized per-modality missing-set sizes.

    Targets are ⌊ω_m·K⌋.  Keeping every client ≥1 modality bounds the total
    at K·(M-1) (each client absorbs at most M-1 marks); oversubscribed
    targets are shaved largest-first (water-fill) to that capacity, ties
    broken toward lower modality index.  Raises ``ValueError`` for ω_m
    outside [0, 1) or when removal is infeasible outright (M = 1)."""
    omegas = np.asarray(omegas, float)
    M = omegas.size
    if np.any((omegas < 0.0) | (omegas >= 1.0)):
        raise ValueError(
            f"omega must lie in [0, 1) per modality (got {omegas.tolist()}): "
            "omega_m >= 1 strips modality m from every client")
    counts = np.floor(omegas * K).astype(int)
    cap = K * (M - 1)
    if counts.sum() > cap and cap == 0:
        raise ValueError(
            "cannot remove the only modality: with M=1 any omega*M >= 1/K "
            "leaves clients with zero modalities")
    if counts.sum() <= cap:
        return counts
    # water-fill: largest level t with sum(min(counts, t)) <= cap, then hand
    # the remainder to the largest-target modalities (stable tie-break)
    lo, hi = 0, int(counts.max())
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if int(np.minimum(counts, mid).sum()) <= cap:
            lo = mid
        else:
            hi = mid - 1
    out = np.minimum(counts, lo)
    eligible = np.flatnonzero(counts > out)
    order = eligible[np.argsort(-counts[eligible], kind="stable")]
    out[order[:cap - int(out.sum())]] += 1
    return out


def missing_masks(K: int, omegas: Sequence[float], rng) -> np.ndarray:
    """Bool [M, K]: ``mask[m, k]`` ⇔ client k is missing modality m.

    One permutation of the clients, per-modality windows of ``missing_counts``
    lengths laid end to end modulo K — every client keeps ≥1 modality and
    no modality loses every owner (n_m ≤ K-1)."""
    counts = missing_counts(K, omegas)
    order = rng.permutation(K)
    miss = np.zeros((counts.size, K), bool)
    c = 0
    for m, n in enumerate(counts):
        miss[m, order[(c + np.arange(n)) % K]] = True
        c += int(n)
    assert not miss.all(axis=0).any(), "internal: client lost every modality"
    return miss


def _dirichlet_shards(ds: MultimodalDataset, K: int, alpha: float,
                      rng) -> List[np.ndarray]:
    """Label-skewed shards: per-class proportions ~ Dirichlet(alpha).
    Small alpha = strong non-IID (the data-heterogeneity regime of the
    paper's companion line of work [15])."""
    shards: List[list] = [[] for _ in range(K)]
    for c in range(ds.n_classes):
        idx_c = np.flatnonzero(ds.labels == c)
        rng.shuffle(idx_c)
        p = rng.dirichlet([alpha] * K)
        cuts = (np.cumsum(p) * len(idx_c)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx_c, cuts)):
            shards[k].extend(part.tolist())
    # rebalance BEFORE materialising so donated samples move, not duplicate.
    # Donors must keep >= 1 sample themselves, or a large-K / small-N split
    # can pop a shard straight back to empty (the shard it just filled, even).
    for k in range(K):
        if not shards[k]:                     # guarantee non-empty clients
            sizes = [len(x) for x in shards]
            donor = int(np.argmax(sizes))
            if sizes[donor] < 2:
                raise ValueError(
                    f"cannot rebalance Dirichlet shards: only {len(ds)} "
                    f"samples for K={K} clients")
            shards[k].append(shards[donor].pop())
    return [np.asarray(s, int) for s in shards]


def partition(ds: MultimodalDataset, K: int, omega,
              seed: int = 0,
              dirichlet_alpha: float = 0.0) -> List[ClientData]:
    """``dirichlet_alpha > 0`` adds label skew on top of the modality
    heterogeneity (0 = IID equal shards, the paper's §VI setting).
    ``omega`` is a scalar ratio, a per-modality mapping, or a sequence in
    sorted-modality order (see ``normalize_omegas``/``missing_masks``)."""
    rng = np.random.default_rng(seed)
    if dirichlet_alpha > 0:
        shards = _dirichlet_shards(ds, K, dirichlet_alpha, rng)
    else:
        idx = rng.permutation(len(ds))
        shards = np.array_split(idx, K)
    all_mods = sorted(ds.features.keys())
    miss = missing_masks(K, normalize_omegas(omega, all_mods), rng)
    missing: Dict[str, set] = {
        m: set(np.flatnonzero(miss[i])) for i, m in enumerate(all_mods)}

    clients = []
    for k in range(K):
        mods = tuple(m for m in all_mods if k not in missing[m])
        assert mods, "client lost every modality — lower omega"
        sub = ds.subset(shards[k])
        sub = MultimodalDataset(
            ds.name, {m: sub.features[m] for m in mods}, sub.labels,
            ds.n_classes)
        clients.append(ClientData(sub, mods))
    return clients


def train_test_split(ds: MultimodalDataset, test_frac: float = 0.2,
                     seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    n_test = int(test_frac * len(ds))
    return ds.subset(idx[n_test:]), ds.subset(idx[:n_test])
