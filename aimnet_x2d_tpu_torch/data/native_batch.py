"""The native binned-batch builder and the columnar dataset cache it reads
(counterpart of aimnet_x2d_tpu/data/native_batch.py).

The Python path (``batching.collate`` then ``binning.bin_pack_batch``) is
the specification: :func:`build_binned_batch` builds the same binned
``MolBatch``, array for array, in one pass of ``native/batch_builder.cpp``
over a :class:`ColumnarCache` (the per-molecule loops: atom copy, edge
remap with its stable destination sort, adjacency, pool matrix), with the
graph-level and stereo arrays in vectorized numpy.  The library is the one
``chem/native.py`` builds.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..chem import native
from .batching import MolBatch, MolFeatures, bucket_size
from .binning import BinningError, adaptive_mb_cap, tet_bin_tables


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


@dataclasses.dataclass
class ColumnarCache:
    """Dataset-wide columnar arrays: per-molecule ranges of atoms, edges
    (local indices, hop-major per molecule, dst first), 4-neighbour
    tetrahedral centres and cis/trans pairs, given by offset arrays."""

    atom_type: np.ndarray  # (ΣN,) int32
    hydrogen_count: np.ndarray
    degree: np.ndarray
    hybridization: np.ndarray
    mol_atom_off: np.ndarray  # (B+1,) int64
    edge_dst: np.ndarray  # (ΣE,) int32
    edge_src: np.ndarray
    edge_hop: np.ndarray  # 1..K
    mol_edge_off: np.ndarray
    tet: np.ndarray  # (ΣC, 4) int32
    mol_tet_off: np.ndarray
    cis: np.ndarray  # (ΣP, 2) int32, before the reversed copies (quirk Q7)
    mol_cis_off: np.ndarray
    trans: np.ndarray
    mol_trans_off: np.ndarray
    total_charge: np.ndarray  # (B,) float32
    atomic_numbers: np.ndarray  # (ΣN,) int32
    processed_smiles: List[str]

    def __len__(self) -> int:
        return len(self.mol_atom_off) - 1

    @staticmethod
    def from_smiles(smiles: Sequence[str], num_hops: int,
                    num_threads: int = 0) -> "tuple[ColumnarCache, np.ndarray]":
        """Featurize straight into the columnar layout, in one native call
        on ``num_threads`` C++ threads, with no per-molecule objects.
        Returns (the cache over the valid molecules, the (B,) bool mask of
        valid SMILES)."""
        c = native.featurize_columns(list(smiles), num_hops, num_threads)
        valid = c["valid"]

        def compact(off):
            counts = off[1:] - off[:-1]
            return np.concatenate([[0], np.cumsum(counts[valid])]).astype(np.int64)

        afeat = c["afeat"]
        cache = ColumnarCache(
            atom_type=np.ascontiguousarray(afeat[:, 0]),
            hydrogen_count=np.ascontiguousarray(afeat[:, 1]),
            degree=np.ascontiguousarray(afeat[:, 2]),
            hybridization=np.ascontiguousarray(afeat[:, 3]),
            mol_atom_off=compact(c["atom_off"]),
            edge_dst=c["edst"],
            edge_src=c["esrc"],
            edge_hop=c["ehop"].astype(np.int32),
            mol_edge_off=compact(c["edge_off"]),
            tet=c["tet"],
            mol_tet_off=compact(c["tet_off"]),
            cis=c["cis"],
            mol_cis_off=compact(c["cis_off"]),
            trans=c["trans"],
            mol_trans_off=compact(c["trans_off"]),
            total_charge=c["charge"][valid].astype(np.float32),
            atomic_numbers=c["anum"],
            processed_smiles=[s for s, v in zip(c["processed"], valid) if v],
        )
        return cache, valid

    @staticmethod
    def from_features(feats: Sequence[MolFeatures], num_hops: int) -> "ColumnarCache":
        """The cache of a list of per-molecule features (a dataset built by
        the pure-Python featurizer)."""
        B = len(feats)
        offs = {k: np.zeros(B + 1, np.int64) for k in ("a", "e", "t", "c", "r")}
        cols = {k: [] for k in ("at", "hc", "dg", "hy", "ed", "es", "eh", "tet", "cis", "tr", "an")}
        for i, m in enumerate(feats):
            offs["a"][i + 1] = offs["a"][i] + m.num_atoms
            for key, arr in (("at", m.atom_type), ("hc", m.hydrogen_count), ("dg", m.degree),
                             ("hy", m.hybridization), ("an", m.atomic_numbers)):
                cols[key].append(arr)
            ne = 0
            for h in range(num_hops):
                if h < len(m.edge_hops) and m.edge_hops[h].shape[1] > 0:
                    e = m.edge_hops[h]
                    cols["ed"].append(e[0])  # row 0: the origin, the message's destination
                    cols["es"].append(e[1])
                    cols["eh"].append(np.full(e.shape[1], h + 1, np.int32))
                    ne += e.shape[1]
            offs["e"][i + 1] = offs["e"][i] + ne
            t = m.tet_nbrs
            keep = t.size and t.ndim == 2 and t.shape[1] == 4  # 4-neighbour centres only
            if keep:
                cols["tet"].append(t)
            offs["t"][i + 1] = offs["t"][i] + (t.shape[0] if keep else 0)
            for key, o, p in (("cis", "c", m.cis_pairs), ("tr", "r", m.trans_pairs)):
                p = p.reshape(-1, 2) if p.size else np.zeros((0, 2), np.int32)
                cols[key].append(p)
                offs[o][i + 1] = offs[o][i] + p.shape[0]

        def cat(key, shape):
            if cols[key]:
                return np.ascontiguousarray(np.concatenate(cols[key]).astype(np.int32))
            return np.zeros(shape, np.int32)

        return ColumnarCache(
            atom_type=cat("at", 0), hydrogen_count=cat("hc", 0), degree=cat("dg", 0),
            hybridization=cat("hy", 0), mol_atom_off=offs["a"],
            edge_dst=cat("ed", 0), edge_src=cat("es", 0), edge_hop=cat("eh", 0),
            mol_edge_off=offs["e"],
            tet=cat("tet", (0, 4)).reshape(-1, 4), mol_tet_off=offs["t"],
            cis=cat("cis", (0, 2)).reshape(-1, 2), mol_cis_off=offs["c"],
            trans=cat("tr", (0, 2)).reshape(-1, 2), mol_trans_off=offs["r"],
            total_charge=np.array([m.total_charge for m in feats], np.float32),
            atomic_numbers=cat("an", 0),
            processed_smiles=[m.smiles for m in feats],
        )

    def head(self, n: int) -> "ColumnarCache":
        """The cache of the first ``n`` molecules (views, no copy)."""
        a, e, t = self.mol_atom_off[n], self.mol_edge_off[n], self.mol_tet_off[n]
        c, r = self.mol_cis_off[n], self.mol_trans_off[n]
        return ColumnarCache(
            atom_type=self.atom_type[:a], hydrogen_count=self.hydrogen_count[:a],
            degree=self.degree[:a], hybridization=self.hybridization[:a],
            mol_atom_off=self.mol_atom_off[: n + 1],
            edge_dst=self.edge_dst[:e], edge_src=self.edge_src[:e], edge_hop=self.edge_hop[:e],
            mol_edge_off=self.mol_edge_off[: n + 1],
            tet=self.tet[:t], mol_tet_off=self.mol_tet_off[: n + 1],
            cis=self.cis[:c], mol_cis_off=self.mol_cis_off[: n + 1],
            trans=self.trans[:r], mol_trans_off=self.mol_trans_off[: n + 1],
            total_charge=self.total_charge[:n], atomic_numbers=self.atomic_numbers[:a],
            processed_smiles=self.processed_smiles[:n],
        )


class LazyFeatures:
    """A list-like view of a :class:`ColumnarCache` as ``MolFeatures``: the
    loaders read the cache's arrays; ``features[i]`` and iteration build
    one molecule's ``MolFeatures`` at a time (views into the cache), for
    the consumers that want them (the flat collate, halo shards).  A slice
    from the start, ``features[:n]``, is the view of ``cache.head(n)``;
    any other slice is a list."""

    def __init__(self, cache: ColumnarCache, num_hops: int):
        self.cache = cache
        self.num_hops = num_hops

    def __len__(self) -> int:
        return len(self.cache)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if start == 0 and step == 1:
                return LazyFeatures(self.cache.head(stop), self.num_hops)
            return [self[k] for k in range(start, stop, step)]
        c = self.cache
        i = int(i)
        if i < 0:
            i += len(self)
        a0, a1 = c.mol_atom_off[i], c.mol_atom_off[i + 1]
        e0, e1 = c.mol_edge_off[i], c.mol_edge_off[i + 1]
        bounds = np.searchsorted(c.edge_hop[e0:e1], np.arange(1, self.num_hops + 2))
        hops = [np.stack([c.edge_dst[e0 + bounds[k]: e0 + bounds[k + 1]],
                          c.edge_src[e0 + bounds[k]: e0 + bounds[k + 1]]])
                for k in range(self.num_hops)]
        return MolFeatures(
            edge_hops=hops,
            atom_type=c.atom_type[a0:a1],
            hydrogen_count=c.hydrogen_count[a0:a1],
            degree=c.degree[a0:a1],
            hybridization=c.hybridization[a0:a1],
            tet_nbrs=c.tet[c.mol_tet_off[i]: c.mol_tet_off[i + 1]],
            cis_pairs=c.cis[c.mol_cis_off[i]: c.mol_cis_off[i + 1]],
            trans_pairs=c.trans[c.mol_trans_off[i]: c.mol_trans_off[i + 1]],
            total_charge=float(c.total_charge[i]),
            atomic_numbers=c.atomic_numbers[a0:a1],
            smiles=c.processed_smiles[i],
        )


def _gather_ragged(values, offsets, indices, starts):
    """The selection's per-molecule ragged rows, concatenated, their local
    atom indices shifted by each molecule's new atom start."""
    cnt = (offsets[indices + 1] - offsets[indices]).astype(np.int64)
    if cnt.sum() == 0:
        return np.zeros((0,) + values.shape[1:], np.int64)
    rows = np.concatenate([np.arange(offsets[i], offsets[i + 1]) for i, c in zip(indices, cnt) if c])
    shift = np.repeat(starts, cnt)
    out = values[rows].astype(np.int64)
    return out + (shift[:, None] if out.ndim == 2 else shift)


def _check_cache(cache: ColumnarCache) -> None:
    """Raise unless the arrays the builder reads are C-contiguous and of
    the dtypes its C signature takes."""
    for name, dt in (("atom_type", np.int32), ("hydrogen_count", np.int32),
                     ("degree", np.int32), ("hybridization", np.int32),
                     ("mol_atom_off", np.int64), ("edge_dst", np.int32), ("edge_src", np.int32),
                     ("edge_hop", np.int32), ("mol_edge_off", np.int64)):
        a = getattr(cache, name)
        if a.dtype != dt or not a.flags.c_contiguous:
            raise TypeError(f"ColumnarCache.{name}: {a.dtype}, contiguous "
                            f"{a.flags.c_contiguous}; the builder takes contiguous {np.dtype(dt)}")


# Scratch sets a loader that recycles the builder's output buffers must
# rotate through: a batch's host arrays may be rewritten only after its copy
# to the card.  The train loop's two-stage prefetch
# (training/trainer.py::prefetch_batches, size 2) holds 1 batch being built
# + 2 queued for transfer + 1 in transfer + 2 queued on the device + 1 in
# the step, 7 in flight; 8 adds a margin.  Rotating fewer sets than the
# batches in flight lets a later batch overwrite a queued one before its
# copy, so features no longer match their targets (the JAX package's
# round-4 training collapse); prefetch_batches refuses a depth that needs
# more.  The loaders rotate them on the card only (BatchLoader.rotate_scratch,
# which ``train`` calls there), with pinned buffers that the copy stream reads
# directly; on the CPU the model reads the host arrays themselves, so every
# batch owns fresh ones.
SCRATCH_SETS = 8


def _scratch_buffer(shape, dt, fill, pinned: bool) -> np.ndarray:
    """One of the builder's output buffers, filled with ``fill``: a numpy
    array, or with ``pinned`` a view of a pinned (page-locked) torch host
    tensor, which a non-blocking copy to the card reads with no staging
    copy (the array keeps its tensor alive)."""
    if not pinned:
        return np.full(shape, fill, dt)
    import torch

    a = torch.empty(shape, dtype=torch.from_numpy(np.zeros(0, dt)).dtype, pin_memory=True).numpy()
    a.fill(fill)
    return a


def build_binned_batch(
    cache: ColumnarCache,
    indices: np.ndarray,
    targets: np.ndarray,
    *,
    ab: int,
    mb_cap: int,
    edge_slots: int,
    tet_slots: int,
    pair_slots: int,
    pins: Optional[dict] = None,
    scratch: Optional[dict] = None,
    size_sort: bool = False,
) -> MolBatch:
    """The binned ``MolBatch`` of molecules ``indices`` of ``cache`` (with
    their ``targets``), equal to ``bin_pack_batch(collate(...))`` with the
    same slots, pins and ``size_sort``.  Raises :class:`BinningError` when
    a molecule exceeds ``ab`` atoms.

    ``scratch`` (a dict the caller owns) recycles the large output buffers
    across calls of the same shape: the returned batch then aliases them,
    which is safe only when each batch is copied off the host before the
    same scratch dict builds another (see ``SCRATCH_SETS``).  With
    ``scratch["pinned"]`` true the buffers are pinned host memory.  Without
    it every batch owns fresh arrays.
    """
    lib = native.load_library()
    _check_cache(cache)
    idx = np.ascontiguousarray(np.asarray(indices, np.int32))
    n = idx.shape[0]
    if n and (idx.min() < 0 or idx.max() >= len(cache)):
        raise IndexError(f"molecule indices outside 0..{len(cache) - 1}")
    sizes = (cache.mol_atom_off[idx + 1] - cache.mol_atom_off[idx]).astype(np.int64)
    mb_cap = adaptive_mb_cap(sizes, ab, mb_cap)
    if size_sort:
        # the packer's size-descending plan (binning.plan_bins_sorted)
        perm = np.argsort(-sizes, kind="stable")
        idx = np.ascontiguousarray(idx[perm])
        targets = np.asarray(targets)[perm]

    bin_of = np.zeros(n, np.int32)
    local_of = np.zeros(n, np.int32)
    start_of = np.zeros(n, np.int64)
    nbins = np.zeros(1, np.int32)
    mb_eff = np.zeros(1, np.int32)
    rc = lib.aimnet_bin_plan(
        _p(cache.mol_atom_off, ctypes.c_int64), _p(idx, ctypes.c_int32), n, ab, mb_cap,
        _p(bin_of, ctypes.c_int32), _p(local_of, ctypes.c_int32), _p(start_of, ctypes.c_int64),
        _p(nbins, ctypes.c_int32), _p(mb_eff, ctypes.c_int32),
    )
    if rc != 0:
        raise BinningError(f"a molecule exceeds bin size {ab}")

    nbins_p = bucket_size(int(nbins[0]), align=8)
    mb = bucket_size(int(mb_eff[0]), align=8)
    if pins is not None:
        nbins_p = max(nbins_p, pins.get("bins", 0))
        pins["bins"] = nbins_p
        mb = max(mb, pins.get("mb", 0))
        pins["mb"] = mb
    A2 = nbins_p * ab
    B2 = nbins_p * mb

    key = (A2, B2, edge_slots, nbins_p, ab, mb)
    if scratch is not None and scratch.get("key") == key:
        bufs = scratch["bufs"]
        clear = 1  # the C side resets the reused buffers
    else:
        pinned = scratch is not None and bool(scratch.get("pinned"))
        bufs = tuple(_scratch_buffer(shape, dt, fill, pinned) for shape, dt, fill in (
            (A2, np.int32, 0), (A2, np.int32, 0), (A2, np.int32, 0), (A2, np.int32, 0),
            (A2, np.int32, B2), (A2, np.uint8, 0),
            (edge_slots, np.int32, 0), (edge_slots, np.int32, A2), (edge_slots, np.int32, 0),
            (edge_slots, np.uint8, 0), ((nbins_p, ab, ab), np.int8, 0),
            ((nbins_p, mb, ab), np.int8, 0)))
        clear = 0
        if scratch is not None:
            scratch["key"], scratch["bufs"] = key, bufs
    o_at, o_hc, o_dg, o_hy, o_am, o_mask, o_es, o_ed, o_eh, o_em, adj, pool = bufs

    total_e = int((cache.mol_edge_off[idx + 1] - cache.mol_edge_off[idx]).sum())
    if total_e > edge_slots:
        raise ValueError(f"edge_slots={edge_slots} < total edges {total_e}")
    i32, i64, u8, i8 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint8, ctypes.c_int8
    E = lib.aimnet_bin_fill(
        _p(cache.atom_type, i32), _p(cache.hydrogen_count, i32),
        _p(cache.degree, i32), _p(cache.hybridization, i32), _p(cache.mol_atom_off, i64),
        _p(cache.edge_dst, i32), _p(cache.edge_src, i32), _p(cache.edge_hop, i32),
        _p(cache.mol_edge_off, i64),
        _p(idx, i32), n, _p(bin_of, i32), _p(local_of, i32), _p(start_of, i64),
        nbins_p, ab, mb,
        _p(o_at, i32), _p(o_hc, i32), _p(o_dg, i32), _p(o_hy, i32), _p(o_am, i32),
        _p(o_mask, u8), _p(o_es, i32), _p(o_ed, i32), _p(o_eh, i32), _p(o_em, u8),
        _p(adj, i8), _p(pool, i8),
        edge_slots, clear,
    )
    if E < 0:
        raise BinningError("edge multiplicity exceeds int8")

    # graph-level arrays
    mol_slot = bin_of.astype(np.int64) * mb + local_of
    t = np.asarray(targets, np.float32)
    if t.ndim == 1:
        t = t[:, None]
    tgt = np.zeros((B2, t.shape[1]), np.float32)
    tgt[mol_slot] = t
    charge = np.zeros(B2, np.float32)
    charge[mol_slot] = cache.total_charge[idx]
    gmask = np.zeros(B2, bool)
    gmask[mol_slot] = True

    # stereochemistry
    tet = _gather_ragged(cache.tet, cache.mol_tet_off, idx, start_of)
    tet_nbrs = np.full((tet_slots, 4), A2, np.int32)
    tet_mask = np.zeros(tet_slots, bool)
    tet_nbrs[: tet.shape[0]] = tet
    tet_mask[: tet.shape[0]] = True
    tet_bin = tet_bin_tables(tet_nbrs, tet_mask, nbins_p, ab, pins=pins)

    def pairs(values, offsets):
        arr = _gather_ragged(values, offsets, idx, start_of)
        if arr.shape[0]:  # quirk Q7: the reversed copies appended again
            arr = np.concatenate([arr, arr[:, ::-1]])
        out = np.full((pair_slots, 2), A2, np.int32)
        msk = np.zeros(pair_slots, bool)
        out[: arr.shape[0]] = arr
        msk[: arr.shape[0]] = True
        return out, msk

    cis_pairs, cis_mask = pairs(cache.cis, cache.mol_cis_off)
    trans_pairs, trans_mask = pairs(cache.trans, cache.mol_trans_off)

    return MolBatch(
        atom_type=o_at, hydrogen_count=o_hc, degree=o_dg, hybridization=o_hy,
        atom_mol=o_am, atom_mask=o_mask.astype(bool),
        edge_src=o_es, edge_dst=o_ed, edge_hop=o_eh, edge_mask=o_em.astype(bool),
        total_charge=charge, targets=tgt, graph_mask=gmask,
        tet_nbrs=tet_nbrs, tet_mask=tet_mask,
        cis_pairs=cis_pairs, cis_mask=cis_mask, trans_pairs=trans_pairs, trans_mask=trans_mask,
        edges_dst_sorted=True, bin_adj=adj, pool_mat=pool, tet_bin=tet_bin,
    )
