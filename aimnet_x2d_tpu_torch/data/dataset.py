"""Featurized datasets and the binned batch loader (counterpart of
aimnet_x2d_tpu/data/dataset.py).

The port trains and serves on the binned, fixed-shape, single-device layout
only: every batch is collated, then packed whole-molecule into
``bin_ab``-atom bins (data/binning.py).  A training loader shuffles with
``np.random.default_rng(seed + epoch)`` and packs size-descending, as the
JAX loader does; evaluation and serving loaders keep input order.  A
molecule larger than a bin raises :class:`~.binning.BinningError`; the flat
layout that would take it is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..chem.featurize import compute_features
from .batching import MolBatch, MolFeatures, bucket_size, collate
from .binning import (
    DEFAULT_AB,
    DEFAULT_MB,
    BinningError,
    adaptive_mb_cap,
    bin_pack_batch,
    plan_bin_counts,
)


def featurize_many(
    smiles: Sequence[str], targets: np.ndarray, max_hops: int
) -> Tuple[List[str], np.ndarray, List[MolFeatures]]:
    """Featurize SMILES with the pure-Python featurizer; drop failures and
    their targets.  Kept molecules carry the processed SMILES."""
    targets = np.asarray(targets, np.float32)
    if targets.ndim == 1:
        targets = targets[:, None]
    keep_smiles, keep_targets, feats = [], [], []
    for s, t in zip(smiles, targets):
        r = compute_features(s, max_hops)
        if r is not None:
            keep_smiles.append(r.smiles)
            keep_targets.append(t)
            feats.append(r)
    return keep_smiles, np.asarray(keep_targets, np.float32).reshape(-1, targets.shape[1]), feats


@dataclasses.dataclass
class MoleculeDataset:
    """Featurized molecules + targets, ready to batch."""

    smiles: List[str]
    targets: np.ndarray  # (N, T) float32
    features: List[MolFeatures]
    max_hops: int

    def __len__(self) -> int:
        return len(self.features)

    @property
    def num_tasks(self) -> int:
        return int(self.targets.shape[1])

    def atomic_numbers(self) -> List[np.ndarray]:
        return [f.atomic_numbers for f in self.features]

    def with_targets(self, targets: np.ndarray) -> "MoleculeDataset":
        t = np.asarray(targets, np.float32)
        if t.ndim == 1:
            t = t[:, None]
        if len(t) != len(self.features):
            raise ValueError(f"{len(t)} target rows for {len(self.features)} molecules")
        return dataclasses.replace(self, targets=t)

    @classmethod
    def from_smiles(
        cls, smiles: Sequence[str], targets: np.ndarray, max_hops: int
    ) -> "MoleculeDataset":
        s, t, f = featurize_many(smiles, targets, max_hops)
        return cls(smiles=s, targets=t, features=f, max_hops=max_hops)


class BatchLoader:
    """Yields binned, fixed-shape :class:`MolBatch` objects.

    Without ``shuffle``, batches come in input order, and graph-level
    outputs of a batch are in input order after masking with ``graph_mask``.
    With it, the order of epoch ``e`` (``set_epoch``) is a permutation from
    ``np.random.default_rng(seed + e)`` and each batch is packed
    size-descending.  ``warm_bin_pins`` and ``pin_slots`` keep one batch
    shape across batches and loaders, so the device sees few distinct
    shapes (fewer allocator sizes; the same contract as the JAX loader,
    whose compiled step needs it).
    """

    def __init__(
        self,
        dataset: MoleculeDataset,
        batch_size: int,
        bin_ab: int = DEFAULT_AB,
        bin_mb: int = DEFAULT_MB,
        shuffle: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.size_sort = shuffle
        self.seed = seed
        self._epoch = 0
        self.bin_ab = bin_ab
        self.bin_mb = bin_mb
        self._bin_pins: dict = {}
        feats = dataset.features
        atoms = np.array([f.num_atoms for f in feats], np.int64)
        if atoms.size and int(atoms.max()) > bin_ab:
            big = int(np.argmax(atoms))
            raise BinningError(
                f"molecule {big} ({dataset.smiles[big]!r}) has {int(atoms[big])} "
                f"atoms, more than the {bin_ab}-atom bin; the flat layout that "
                "serves such molecules is not ported yet"
            )
        edges = np.array([f.num_edges for f in feats], np.int64)
        tets = np.array([f.tet_nbrs.shape[0] for f in feats], np.int64)
        pairs = np.array(
            [2 * max(f.cis_pairs.shape[0], f.trans_pairs.shape[0]) for f in feats],
            np.int64,
        )
        # Static caps: batch_size molecules of the dataset's largest sizes.
        k = min(batch_size, len(atoms))
        self.atom_slots = bucket_size(int(np.sort(atoms)[-k:].sum()) if len(atoms) else 8)
        self.edge_slots = bucket_size(int(np.sort(edges)[-k:].sum()) if len(edges) else 8)
        self.tet_slots = bucket_size(int(np.sort(tets)[-k:].sum()) + 1 if len(tets) else 8)
        self.pair_slots = bucket_size(int(np.sort(pairs)[-k:].sum()) + 1 if len(pairs) else 8)

    def pin_slots(self, slots: dict) -> dict:
        """Grow this loader's slot caps to at least ``slots`` and update
        ``slots`` in place to the running maximum."""
        for name in ("atom_slots", "edge_slots", "tet_slots", "pair_slots"):
            merged = max(slots.get(name, 0), getattr(self, name))
            slots[name] = merged
            setattr(self, name, merged)
        for name in ("bins", "mb", "tetb"):  # tetb: the tet_bin table's width
            merged = max(slots.get(name, 0), self._bin_pins.get(name, 0))
            if merged:
                slots[name] = merged
                self._bin_pins[name] = merged
        return slots

    def warm_bin_pins(self) -> None:
        """Plan every batch's bin grid and seed the pins with the largest,
        before the first batch is built, so all batches share one shape."""
        sizes_all = np.array([f.num_atoms for f in self.dataset.features], np.int64)
        tets_all = np.array(
            [f.tet_nbrs.shape[0] for f in self.dataset.features], np.int64
        )
        bins = self._bin_pins.get("bins", 0)
        mb = self._bin_pins.get("mb", 0)
        for idx in self._batch_indices():
            sizes = sizes_all[idx]
            cap = adaptive_mb_cap(sizes, self.bin_ab, self.bin_mb)
            if self.size_sort:  # the packer plans size-descending
                sizes = -np.sort(-sizes)
            nb, mbeff = plan_bin_counts(sizes, self.bin_ab, cap)
            bins = max(bins, bucket_size(nb, align=8))
            mb = max(mb, bucket_size(mbeff, align=8))
        self._bin_pins["bins"] = bins
        self._bin_pins["mb"] = mb
        max_tet = int(tets_all.max()) if tets_all.size else 0
        tetb = bucket_size(min(self.bin_ab, mb * max_tet) if max_tet else 1, align=8)
        self._bin_pins["tetb"] = max(tetb, self._bin_pins.get("tetb", 0))

    def __len__(self) -> int:
        return math.ceil(len(self.dataset) / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        return [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]

    def _collate(self, idx: np.ndarray) -> MolBatch:
        batch = collate(
            [self.dataset.features[i] for i in idx],
            self.dataset.targets[idx],
            num_hops=self.dataset.max_hops,
            graph_slots=self.batch_size,
            atom_slots=self.atom_slots,
            edge_slots=self.edge_slots,
            tet_slots=self.tet_slots,
            pair_slots=self.pair_slots,
        )
        return bin_pack_batch(batch, ab=self.bin_ab, mb=self.bin_mb, pins=self._bin_pins,
                              size_sort=self.size_sort)

    def __iter__(self) -> Iterator[MolBatch]:
        for idx in self._batch_indices():
            yield self._collate(idx)
