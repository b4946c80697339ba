"""Featurized datasets and the batch loader (counterpart of
aimnet_x2d_tpu/data/dataset.py).

A loader serves one layout, decided once when it is built, by the JAX
rule: binned (every batch collated, then packed whole-molecule into
``bin_ab``-atom bins, data/binning.py) when every molecule fits a bin, and
flat otherwise (collated with fixed slot caps, with the edge layouts of the
aggregation kernel attached, ``attach_flat_layouts``).  Streaming serving
builds one loader per chunk, so there the layout is decided per chunk.  A
training loader shuffles with ``np.random.default_rng(seed + epoch)`` and
packs size-descending, as the JAX loader does; evaluation and serving
loaders keep input order.  Over a rank grid a loader yields each data
shard's halo partition (``halo_shards``) or its edge shards
(``edge_shards``, always flat, as in JAX).

Featurization and binned batches are native by default: one call of the
C++ featurizer fills a columnar cache, and the C++ builder packs each
binned batch from it (chem/native.py, data/native_batch.py, both equal
array for array to the Python code).  ``AIMNET_NO_NATIVE=1`` selects the
pure-Python featurizer and the Python collate + bin-pack.  Flat batches
and halo shards are always collated in Python.  On the card the train loop
has the native builder recycle its output buffers through rotating sets of
pinned scratch (``BatchLoader.rotate_scratch``); elsewhere every batch owns
fresh arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..chem import native
from ..chem.featurize import compute_features
from ..parallel.halo import partition_halo_stack
from .batching import (
    MolBatch,
    MolFeatures,
    attach_flat_layouts,
    bucket_size,
    collate,
    index_batch,
    shard_edges,
    stack_batches,
)
from .binning import (
    DEFAULT_AB,
    DEFAULT_MB,
    adaptive_mb_cap,
    bin_pack_batch,
    plan_bin_counts,
)
from .native_batch import SCRATCH_SETS, ColumnarCache, LazyFeatures, build_binned_batch


def featurize_many(
    smiles: Sequence[str], targets: np.ndarray, max_hops: int, num_workers: int = 1
) -> Tuple[List[str], np.ndarray, List[MolFeatures]]:
    """Featurize SMILES, natively on ``num_workers`` C++ threads
    (chem/native.py), or with the pure-Python featurizer when
    ``AIMNET_NO_NATIVE`` is set; drop failures and their targets.  Kept
    molecules carry the processed SMILES."""
    targets = np.asarray(targets, np.float32)
    if targets.ndim == 1:
        targets = targets[:, None]
    if native.native_enabled():
        results = native.compute_features_batch(list(smiles), max_hops, max(num_workers, 1))
    else:
        results = [compute_features(s, max_hops) for s in smiles]
    keep_smiles, keep_targets, feats = [], [], []
    for t, r in zip(targets, results):
        if r is not None:
            keep_smiles.append(r.smiles)
            keep_targets.append(t)
            feats.append(r)
    return keep_smiles, np.asarray(keep_targets, np.float32).reshape(-1, targets.shape[1]), feats


@dataclasses.dataclass
class MoleculeDataset:
    """Featurized molecules + targets, ready to batch.

    Built natively (``from_smiles`` without ``AIMNET_NO_NATIVE``),
    ``features`` is a :class:`LazyFeatures` view of the dataset-wide
    ``columnar`` cache (data/native_batch.py), made by one native call with
    no per-molecule objects; otherwise a list of ``MolFeatures`` and
    ``columnar`` None.  A dataset made from a ``LazyFeatures`` takes its
    cache as ``columnar``.
    """

    smiles: List[str]
    targets: np.ndarray  # (N, T) float32
    features: Sequence[MolFeatures]  # a list or a LazyFeatures
    max_hops: int
    columnar: Optional[ColumnarCache] = None

    def __post_init__(self):
        if self.columnar is None and isinstance(self.features, LazyFeatures):
            self.columnar = self.features.cache

    def __len__(self) -> int:
        return len(self.features)

    @property
    def num_tasks(self) -> int:
        return int(self.targets.shape[1])

    def sizes(self) -> Dict[str, np.ndarray]:
        """Per-molecule counts the loaders size their slots by: ``atoms``,
        ``edges``, ``tets`` (4-neighbour centres) and ``pairs`` (cis/trans
        rows after the reversed copies), from the columnar offsets when
        there is a cache."""
        c = self.columnar
        if c is not None:
            return {"atoms": np.diff(c.mol_atom_off), "edges": np.diff(c.mol_edge_off),
                    "tets": np.diff(c.mol_tet_off),
                    "pairs": 2 * np.maximum(np.diff(c.mol_cis_off), np.diff(c.mol_trans_off))}
        f = self.features
        return {"atoms": np.array([m.num_atoms for m in f], np.int64),
                "edges": np.array([m.num_edges for m in f], np.int64),
                "tets": np.array([m.tet_nbrs.shape[0] for m in f], np.int64),
                "pairs": np.array([2 * max(m.cis_pairs.shape[0], m.trans_pairs.shape[0])
                                   for m in f], np.int64)}

    def atomic_numbers(self) -> List[np.ndarray]:
        c = self.columnar
        if c is not None:
            off = c.mol_atom_off
            return [c.atomic_numbers[off[i]: off[i + 1]] for i in range(len(self))]
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
        cls, smiles: Sequence[str], targets: np.ndarray, max_hops: int, num_workers: int = 1
    ) -> "MoleculeDataset":
        """Featurize ``smiles`` (natively on ``num_workers`` C++ threads
        into a columnar cache, or with the pure-Python featurizer under
        ``AIMNET_NO_NATIVE``); invalid SMILES are dropped with their
        targets, and kept ones carry the processed SMILES."""
        if not native.native_enabled():
            s, t, f = featurize_many(smiles, targets, max_hops)
            return cls(smiles=s, targets=t, features=f, max_hops=max_hops)
        targets = np.asarray(targets, np.float32)
        if targets.ndim == 1:
            targets = targets[:, None]
        cache, keep = ColumnarCache.from_smiles(list(smiles), max_hops, max(num_workers, 1))
        return cls(smiles=list(cache.processed_smiles), targets=targets[keep],
                   features=LazyFeatures(cache, max_hops), max_hops=max_hops, columnar=cache)


class BatchLoader:
    """Yields fixed-shape :class:`MolBatch` objects, binned or flat (the
    module docstring says which; ``self.binned``).

    Without ``shuffle``, batches come in input order, and graph-level
    outputs of a batch are in input order after masking with ``graph_mask``.
    With it, the order of epoch ``e`` (``set_epoch``) is a permutation from
    ``np.random.default_rng(seed + e)`` and each batch is packed
    size-descending.  ``warm_bin_pins`` and ``pin_slots`` keep one batch
    shape across batches and loaders, so the device sees few distinct
    shapes (fewer allocator sizes; the same contract as the JAX loader,
    whose compiled step needs it); on a flat loader only the slot caps
    carry over.
    """

    def __init__(
        self,
        dataset: MoleculeDataset,
        batch_size: int,
        bin_ab: int = DEFAULT_AB,
        bin_mb: int = DEFAULT_MB,
        shuffle: bool = False,
        seed: int = 0,
        stack_devices: int = 0,
        halo_shards: int = 1,
        rank: Optional[Tuple[int, int]] = None,
        edge_shards: int = 1,
    ):
        if edge_shards > 1 and halo_shards > 1:
            raise ValueError("edge_shards and halo_shards are exclusive graph-axis modes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.size_sort = shuffle
        self.seed = seed
        self._epoch = 0
        self.bin_ab = bin_ab
        self.bin_mb = bin_mb
        self._bin_pins: dict = {}
        self.stack_devices = stack_devices
        self.halo_shards = halo_shards
        self.edge_shards = edge_shards
        self.rank = rank
        self._halo_slots: dict = {}
        if (halo_shards > 1 or edge_shards > 1 or rank is not None) and stack_devices < 1:
            raise ValueError("graph shards and a rank's shard need stack_devices >= 1")
        sizes = dataset.sizes()
        atoms, edges, tets, pairs = (sizes[k] for k in ("atoms", "edges", "tets", "pairs"))
        # halo shards bin-pack per graph rank inside partition_halo, which
        # chunks larger fragments, so the bin size binds only one device;
        # edge shards are flat
        self.binned = halo_shards > 1 or (edge_shards == 1 and (
            not atoms.size or int(atoms.max()) <= bin_ab))
        # Static caps: batch_size molecules of the dataset's largest sizes.
        k = min(batch_size, len(atoms))
        self.atom_slots = bucket_size(int(np.sort(atoms)[-k:].sum()) if len(atoms) else 8)
        self.edge_slots = bucket_size(int(np.sort(edges)[-k:].sum()) if len(edges) else 8)
        self.tet_slots = bucket_size(int(np.sort(tets)[-k:].sum()) + 1 if len(tets) else 8)
        self.pair_slots = bucket_size(int(np.sort(pairs)[-k:].sum()) + 1 if len(pairs) else 8)
        self._columnar: Optional[ColumnarCache] = None
        # the native builder's rotating scratch sets (rotate_scratch); None:
        # every batch owns fresh arrays
        self._scratches: Optional[List[dict]] = None
        self._scratch_i = 0

    def rotate_scratch(self) -> None:
        """Recycle the native builder's output buffers through
        ``SCRATCH_SETS x max(1, stack_devices)`` scratch sets (the JAX
        loader's rotation on its accelerator), in pinned host memory where
        there is a card.  Only for a consumer that copies each batch off the
        host before that many more are built, as the train loop's prefetch
        does on the card (data/native_batch.py, ``SCRATCH_SETS``)."""
        import torch

        n_sets = SCRATCH_SETS * max(1, self.stack_devices)
        self._scratches = [{"pinned": torch.cuda.is_available()} for _ in range(n_sets)]
        self._scratch_i = 0

    def pin_slots(self, slots: dict) -> dict:
        """Grow this loader's slot caps to at least ``slots`` and update
        ``slots`` in place to the running maximum."""
        for name in ("atom_slots", "edge_slots", "tet_slots", "pair_slots"):
            merged = max(slots.get(name, 0), getattr(self, name))
            slots[name] = merged
            setattr(self, name, merged)
        if not self.binned:
            return slots
        for name in ("bins", "mb", "tetb"):  # tetb: the tet_bin table's width
            merged = max(slots.get(name, 0), self._bin_pins.get(name, 0))
            if merged:
                slots[name] = merged
                self._bin_pins[name] = merged
        return slots

    def warm_bin_pins(self) -> None:
        """Plan every batch's bin grid and seed the pins with the largest,
        before the first batch is built, so all batches share one shape.
        Nothing to do on a flat loader or for halo shards (partition_halo
        pins its own slots)."""
        if not self.binned or self.halo_shards > 1:
            return
        sizes = self.dataset.sizes()
        sizes_all, tets_all = sizes["atoms"], sizes["tets"]
        bins = self._bin_pins.get("bins", 0)
        mb = self._bin_pins.get("mb", 0)
        per = self.batch_size
        shards = [c[d * per : (d + 1) * per] for c in self._batch_indices()
                  for d in range(max(1, self.stack_devices))]
        for idx in shards:
            if not idx.size:
                continue
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
        return math.ceil(len(self.dataset) / (self.batch_size * max(1, self.stack_devices)))

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        b = self.batch_size * max(1, self.stack_devices)
        return [order[i : i + b] for i in range(0, n, b)]

    def _partition_halo_shards(self, collated: List[MolBatch]) -> List[MolBatch]:
        """Halo-partition each data shard with shared, monotonically growing
        slot pins (JAX ``BatchLoader._partition_halo_shards``)."""
        parts, self._halo_slots = partition_halo_stack(
            collated, self.halo_shards, binned=True, ab=self.bin_ab, slots=self._halo_slots)
        return parts

    def _native_cache(self) -> ColumnarCache:
        """The columnar cache the native builder reads: the dataset's own,
        or one built once from its ``MolFeatures`` list."""
        if self._columnar is None:
            self._columnar = self.dataset.columnar or ColumnarCache.from_features(
                self.dataset.features, self.dataset.max_hops)
        return self._columnar

    def _collate(self, idx: np.ndarray) -> MolBatch:
        """One batch of molecules ``idx``: binned batches from the native
        builder (data/native_batch.py; the Python collate + bin-pack under
        ``AIMNET_NO_NATIVE``), flat batches and halo shards' batches from
        the Python collate."""
        native_binned = (self.binned and self.halo_shards == 1 and native.native_enabled()
                         and len(self.dataset))
        if native_binned:
            scratch = None
            if self._scratches is not None:
                scratch = self._scratches[self._scratch_i]
                self._scratch_i = (self._scratch_i + 1) % len(self._scratches)
            return build_binned_batch(
                self._native_cache(), idx, self.dataset.targets[idx], ab=self.bin_ab,
                mb_cap=self.bin_mb, edge_slots=self.edge_slots, tet_slots=self.tet_slots,
                pair_slots=self.pair_slots, pins=self._bin_pins, scratch=scratch,
                size_sort=self.size_sort)
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
        if self.halo_shards > 1 or self.edge_shards > 1:
            # partition_halo bin-packs each graph rank's atoms; edge shards
            # carry no kernel-7 layouts (shard_edges)
            return batch
        if not self.binned:
            return attach_flat_layouts(batch)
        return bin_pack_batch(batch, ab=self.bin_ab, mb=self.bin_mb, pins=self._bin_pins,
                              size_sort=self.size_sort)

    def __iter__(self) -> Iterator[MolBatch]:
        """Batches; with ``stack_devices`` N each step's molecules are split
        into N data shards of ``batch_size`` (a short last step leaves later
        shards empty), with ``halo_shards`` G each data shard is
        halo-partitioned into G graph shards, with ``edge_shards`` G its
        edges are cut into G contiguous slices, every atom, graph and stereo
        array replicated (``shard_edges``), and the loader yields the
        stacked (N[, G], ...) batch, or with ``rank=(d, g)`` only that
        rank's shard (data shard d alone is collated and partitioned; its G
        graph ranks compute the same partition)."""
        for idx in self._batch_indices():
            yield self._step(idx)

    def _step(self, idx: np.ndarray) -> MolBatch:
        """The batch of one step's molecules ``idx`` (``__iter__``)."""
        if not self.stack_devices:
            return self._collate(idx)
        per = self.batch_size
        ds = range(self.stack_devices) if self.rank is None else [self.rank[0]]
        shards = [self._collate(idx[d * per : (d + 1) * per]) for d in ds]
        if self.halo_shards > 1:
            shards = self._partition_halo_shards(shards)
        elif self.edge_shards > 1:
            shards = [stack_batches(shard_edges(s, self.edge_shards)) for s in shards]
        if self.rank is None:
            return stack_batches(shards)
        if self.halo_shards > 1 or self.edge_shards > 1:
            return index_batch(shards[0], self.rank[1])
        return shards[0]
