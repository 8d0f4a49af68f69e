"""Client partitioning with modality heterogeneity (§VI "Datasets").

The paper quantifies modality heterogeneity by a missing-modality ratio ω:
ω_m = 0.3 means 30% of clients lack modality m.  We split the dataset into K
equal-ish client shards and remove each modality from a ⌊ω_m·K⌋-sized client
subset chosen so that every client keeps at least one modality (matching
Fig. 1 where client 1 lacks image but keeps audio).

Construction (``missing_counts`` / ``missing_masks``, used by ``partition``):
lay the per-modality missing windows end to
end around one random permutation of the K clients, wrapping modulo K.  Each
window has length n_m = ⌊ω_m·K⌋ ≤ K-1, so no modality is removed from the
same client twice, and as long as the total Σ_m n_m ≤ K·(M-1) no client can
collect marks from all M modalities (max per-client load is ⌈Σn_m / K⌉).
When Σ_m n_m exceeds that capacity — e.g. M=2, ω=0.6, where exact targets
are combinatorially impossible under keep-≥1 — the targets are shaved
largest-first (water-fill) down to capacity instead of silently overlapping;
``missing_counts`` exposes the realized counts.  Genuinely infeasible specs
(ω_m ≥ 1, which would strip a modality of every owner, or removing the only
modality when M=1) raise ``ValueError``.

For Σ_m n_m ≤ K the windows never wrap and this reproduces the historical
disjoint-block assignment bit-for-bit (same rng stream); seeds only differ
in the previously-broken ω > 1/M regime.

A numpy copy of the JAX package's module, so both packages partition the
same cohort bit for bit, plus the fused round's population store
(``ClientStore``): built as numpy, moved to the device once
(``ClientStore.to``), and gathered a cohort at a time (``take``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .synthetic import MultimodalDataset


@dataclasses.dataclass
class ClientData:
    dataset: MultimodalDataset          # only this client's modalities
    modalities: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.dataset)


@dataclasses.dataclass
class StackedClients:
    """Dense client-major stack of an entire cohort, for the batched round
    engine (fl/runtime.py).

    Every modality is materialised for every client at a fixed ``max_batch``
    (the largest client shard), so one jitted ``vmap`` can sweep the whole
    cohort without ragged shapes:

    * ``features[m]`` — [K, max_batch, ...] float32, zero-padded; a client
      that lacks modality m gets an all-zero block (masked out of the loss
      by ``has_modality``).
    * ``labels`` / ``sample_mask`` — [K, max_batch]; ``sample_mask[k, i]`` is
      1.0 for the ``sizes[k]`` real samples and 0.0 for padding.
    * ``has_modality[m]`` — bool [K], client-owns-modality mask.

    Built once per cohort (experiment init); the runtime keeps a device copy.
    """
    features: Dict[str, np.ndarray]
    labels: np.ndarray
    sample_mask: np.ndarray
    has_modality: Dict[str, np.ndarray]
    sizes: np.ndarray
    modalities: Tuple[str, ...]

    @property
    def K(self) -> int:
        return len(self.sizes)

    @property
    def max_batch(self) -> int:
        return self.labels.shape[1]


def stack_clients(clients: Sequence[ClientData],
                  all_modalities: Sequence[str]) -> StackedClients:
    """Pad + stack a list of per-client shards into a StackedClients."""
    K = len(clients)
    N = max(c.size for c in clients)
    labels = np.zeros((K, N), np.int32)
    smask = np.zeros((K, N), np.float32)
    has = {m: np.array([m in c.modalities for c in clients])
           for m in all_modalities}
    feats: Dict[str, np.ndarray] = {}
    for m in all_modalities:
        owners = np.flatnonzero(has[m])
        assert owners.size, f"no client owns modality {m!r}"
        shape = clients[owners[0]].dataset.features[m].shape[1:]
        feats[m] = np.zeros((K, N) + shape, np.float32)
    for k, c in enumerate(clients):
        n = c.size
        labels[k, :n] = c.dataset.labels
        smask[k, :n] = 1.0
        for m in c.modalities:
            feats[m][k, :n] = c.dataset.features[m]
    sizes = np.array([c.size for c in clients], np.int64)
    return StackedClients(feats, labels, smask, has, sizes,
                          tuple(all_modalities))


# ---------------------------------------------------------------------------
# ClientStore — the population store the fused round gathers its cohort from
# ---------------------------------------------------------------------------
_STORE_FIELDS = ("features", "labels", "sample_mask", "has_modality",
                 "sizes", "gamma_bits", "tau_cmp", "e_cmp")


@dataclasses.dataclass(frozen=True)
class ClientStore:
    """Per-client population data, one leading client axis on every leaf.

    * ``features[m]`` [K, N, ...] f32 (zero blocks for non-owners/padding)
    * ``labels`` [K, N] i32 / ``sample_mask`` [K, N] f32
    * ``has_modality[m]`` [K] bool
    * ``sizes`` [K] f32 — D_k, the Eq. 12 weight numerators
    * ``gamma_bits`` / ``tau_cmp`` / ``e_cmp`` [K] f32 — the wireless cost
      vectors (Eqs. 15-18), gathered per cohort alongside the data

    Leaves are numpy as built; ``to(device)`` gives the tensor store the
    fused round reads, and ``take(idx)`` gathers cohort rows from it.
    """
    features: Dict[str, object]
    labels: object
    sample_mask: object
    has_modality: Dict[str, object]
    sizes: object
    gamma_bits: object
    tau_cmp: object
    e_cmp: object
    modalities: Tuple[str, ...]

    @property
    def K(self) -> int:
        return int(self.labels.shape[0])

    def _map(self, fn) -> "ClientStore":
        vals = {f: getattr(self, f) for f in _STORE_FIELDS}
        return ClientStore(**{f: ({m: fn(x) for m, x in v.items()}
                                  if isinstance(v, dict) else fn(v))
                              for f, v in vals.items()},
                           modalities=self.modalities)

    @staticmethod
    def stack(stores: Sequence["ClientStore"]) -> "ClientStore":
        """Numpy stores of one geometry stacked leafwise: every leaf gains
        a leading [S] axis (a scenario grid's stores)."""
        s0 = stores[0]
        vals = {}
        for f in _STORE_FIELDS:
            v0 = getattr(s0, f)
            vals[f] = ({m: np.stack([getattr(s, f)[m] for s in stores])
                        for m in v0} if isinstance(v0, dict) else
                       np.stack([getattr(s, f) for s in stores]))
        return ClientStore(**vals, modalities=s0.modalities)

    def row(self, s: int) -> "ClientStore":
        """Row ``s`` of a stacked store (``stack``'s inverse)."""
        return self._map(lambda x: x[s])

    def leaves(self) -> list:
        """Every leaf: fields in order, modalities sorted — so the leaves
        of two stores of one geometry pair up."""
        out = []
        for f in _STORE_FIELDS:
            v = getattr(self, f)
            out += [v[m] for m in sorted(v)] if isinstance(v, dict) else [v]
        return out

    def to(self, device) -> "ClientStore":
        """The same store as tensors on ``device`` (one copy a leaf)."""
        return self._map(lambda x: torch.as_tensor(np.asarray(x),
                                                   device=device))

    def take(self, idx) -> "ClientStore":
        """Cohort gather: ``index_select`` over the client axis of every
        leaf of a tensor store (``idx`` [J] on the store's device)."""
        idx = idx.to(torch.long)
        return self._map(lambda x: x.index_select(0, idx))


def build_client_store(stacked: StackedClients, gamma_bits, tau_cmp,
                       e_cmp) -> ClientStore:
    """A numpy ClientStore from a staged StackedClients plus the cohort's
    wireless cost vectors (``wireless.cost.ClientCost`` arrays)."""
    return ClientStore(
        {m: np.asarray(v, np.float32) for m, v in stacked.features.items()},
        np.asarray(stacked.labels, np.int32),
        np.asarray(stacked.sample_mask, np.float32),
        {m: np.asarray(v, bool) for m, v in stacked.has_modality.items()},
        np.asarray(stacked.sizes, np.float32),
        np.asarray(gamma_bits, np.float32),
        np.asarray(tau_cmp, np.float32),
        np.asarray(e_cmp, np.float32),
        tuple(stacked.modalities))


# ---------------------------------------------------------------------------
# Missing-modality assignment
# ---------------------------------------------------------------------------
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


def synthetic_population(K: int, n_per_client: int,
                         feature_shapes: Mapping[str, Sequence[int]],
                         n_classes: int, omega,
                         seed: int = 0, snr=1.0) -> ClientStore:
    """A numpy ClientStore for O(10⁴–10⁶) clients without per-client Python
    loops: the ``missing_masks`` modality heterogeneity, class-conditional
    features (per-class prototype × snr_m plus unit noise, as
    data/synthetic.py) and zero cost vectors for the caller to fill
    (``dataclasses.replace``).  ``omega`` and ``snr`` broadcast as in
    ``partition``."""
    rng = np.random.default_rng(seed)
    mods = tuple(sorted(feature_shapes))
    omegas = normalize_omegas(omega, mods)
    snrs = normalize_omegas(snr, mods)      # same broadcast rules, no bound
    miss = missing_masks(K, omegas, rng)
    has = {m: ~miss[i] for i, m in enumerate(mods)}
    for m in mods:
        assert has[m].any(), f"no client owns modality {m!r}"
    labels = rng.integers(0, n_classes, (K, n_per_client)).astype(np.int32)
    feats: Dict[str, np.ndarray] = {}
    for i, m in enumerate(mods):
        shape = tuple(feature_shapes[m])
        protos = rng.standard_normal((n_classes,) + shape).astype(np.float32)
        noise = rng.standard_normal(
            (K, n_per_client) + shape).astype(np.float32)
        own = has[m].reshape((K,) + (1,) * (len(shape) + 1))
        feats[m] = (protos[labels] * np.float32(snrs[i]) + noise) * own
    zeros = np.zeros(K, np.float32)
    return ClientStore(feats, labels, np.ones((K, n_per_client), np.float32),
                       has, np.full(K, float(n_per_client), np.float32),
                       zeros, zeros.copy(), zeros.copy(), mods)


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
