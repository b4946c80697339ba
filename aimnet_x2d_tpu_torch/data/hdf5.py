"""Columnar HDF5 datasets for streaming training and serving (counterpart
of aimnet_x2d_tpu/data/hdf5.py; the files are interchangeable: every
dataset, dtype, chunking choice and metadata attribute is the JAX
package's, so either package reads what the other writes).

Layout (the per-atom and per-edge arrays concatenated over molecules, with
offsets; the bulk columns gzip level 1):
  atoms/{atom_type,hydrogen_count,degree,hybridization,atomic_numbers}  int16/int8
  atoms/offsets          int64 (N+1,)
  edges/{dst,src,hop}    int32 / int8, hop-major per molecule
  edges/offsets          int64 (N+1,)
  stereo/tet             int32 (sum C, 4) + stereo/tet_offsets
  stereo/{cis,trans}     int32 (sum P, 2) + offsets
  graphs/{targets,total_charge}
  graphs/smiles          vlen str
  metadata attrs: num_molecules, max_hops, num_tasks, target_columns (JSON),
                  preprocessing (JSON state dict), per-molecule maxima

Writers: :func:`write_hdf5` (a featurized dataset at once),
:class:`HDF5AppendWriter` and :func:`write_hdf5_streaming` (featurized
and appended a chunk at a time, so memory holds one chunk).  The
preprocessing of a streamed dataset is fit in one chunked pass
(:func:`fit_pipeline_streaming`: the SAE least squares from accumulated
normal equations, the scaler's moments of the SAE-shifted targets from the
same sums) and applied in place (:func:`transform_targets_streaming`).

:class:`HDF5MoleculeDataset` reads contiguous blocks of molecules, one
slice per column, into the columnar cache of the native builder
(``read_block_cache``) or per-molecule features (``read_block``), and
:class:`HDF5BatchLoader` streams the port's batches from those blocks.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import h5py
import numpy as np

from .batching import MolBatch, MolFeatures
from .binning import DEFAULT_AB, DEFAULT_MB
from .dataset import BatchLoader, MoleculeDataset, featurize_many
from .native_batch import ColumnarCache, LazyFeatures
from .preprocessing import (
    MAX_ATOMIC_NUM,
    PreprocessingConfig,
    PreprocessingPipeline,
    SAENormalizer,
    StandardScaler,
)

_GZIP = dict(compression="gzip", compression_opts=1)
_ATOM_COLS = (
    ("atom_type", np.int16),
    ("hydrogen_count", np.int8),
    ("degree", np.int8),
    ("hybridization", np.int8),
    ("atomic_numbers", np.int16),
)


def _decode(s) -> str:
    """h5py returns vlen strings as bytes; ``str`` would give "b'..'"."""
    return s.decode() if isinstance(s, bytes) else str(s)


def _str_dtype():
    return h5py.special_dtype(vlen=str)


def _write_metadata(f: h5py.File, n: int, max_hops: int, num_tasks: int, counts: dict,
                    target_columns, preprocessing_state) -> None:
    meta = f.create_group("metadata")
    meta.attrs["num_molecules"] = n
    meta.attrs["max_hops"] = max_hops
    meta.attrs["num_tasks"] = num_tasks
    meta.attrs["max_atoms_per_mol"] = int(counts["atoms"].max()) if n else 0
    meta.attrs["max_edges_per_mol"] = int(counts["edges"].max()) if n else 0
    meta.attrs["max_tet_per_mol"] = int(counts["tet"].max()) if n else 0
    meta.attrs["max_pairs_per_mol"] = int(
        max(counts["cis"].max() if n else 0, counts["trans"].max() if n else 0))
    if target_columns is not None:
        meta.attrs["target_columns"] = json.dumps(list(target_columns))
    if preprocessing_state is not None:
        meta.attrs["preprocessing"] = json.dumps(preprocessing_state)


def _edge_columns(feats: Sequence[MolFeatures]):
    """The hop-major (dst, src, hop) columns of ``feats`` and each
    molecule's edge count."""
    dsts, srcs, hops, counts = [], [], [], []
    for m in feats:
        cnt = 0
        for h, e in enumerate(m.edge_hops):
            if e.shape[1]:
                dsts.append(e[0])
                srcs.append(e[1])
                hops.append(np.full(e.shape[1], h + 1, np.int8))
                cnt += e.shape[1]
        counts.append(cnt)
    cat = (lambda parts, dt: np.concatenate(parts).astype(dt) if parts else np.zeros(0, dt))
    return cat(dsts, np.int32), cat(srcs, np.int32), cat(hops, np.int8), np.asarray(counts,
                                                                                  np.int64)


def _stereo_rows(feats: Sequence[MolFeatures], key: str, width: int):
    rows = [np.asarray(getattr(m, key)).reshape(-1, width) for m in feats]
    counts = np.array([r.shape[0] for r in rows], np.int64)
    cat = (np.concatenate(rows).astype(np.int32) if counts.sum()
           else np.zeros((0, width), np.int32))
    return cat, counts


def write_hdf5(
    path: str,
    dataset: MoleculeDataset,
    *,
    target_columns: Optional[Sequence[str]] = None,
    preprocessing_state: Optional[dict] = None,
) -> None:
    """Write a featurized dataset (its columnar cache when it has one,
    else its per-molecule features) to ``path``."""
    cache = dataset.columnar
    n = len(dataset)
    if cache is not None:
        atom_off, edge_off = cache.mol_atom_off, cache.mol_edge_off
        cols = {key: (cache.atomic_numbers if key == "atomic_numbers"
                      else getattr(cache, key)).astype(dt) for key, dt in _ATOM_COLS}
        dst = cache.edge_dst.astype(np.int32)
        src = cache.edge_src.astype(np.int32)
        hop = cache.edge_hop.astype(np.int8)
        tet, cis, trans = cache.tet, cache.cis, cache.trans
        offs = {"tet": cache.mol_tet_off, "cis": cache.mol_cis_off, "trans": cache.mol_trans_off}
        total_charges = cache.total_charge
    else:
        feats = dataset.features
        atom_off = np.concatenate([[0], np.cumsum([f.num_atoms for f in feats])]).astype(np.int64)
        cols = {key: (np.concatenate([getattr(f, key) for f in feats]).astype(dt) if n
                      else np.zeros(0, dt)) for key, dt in _ATOM_COLS}
        dst, src, hop, ecounts = _edge_columns(feats)
        edge_off = np.concatenate([[0], np.cumsum(ecounts)]).astype(np.int64)
        tet, tc = _stereo_rows(feats, "tet_nbrs", 4)
        cis, cc = _stereo_rows(feats, "cis_pairs", 2)
        trans, rc = _stereo_rows(feats, "trans_pairs", 2)
        offs = {k: np.concatenate([[0], np.cumsum(c)]).astype(np.int64)
                for k, c in (("tet", tc), ("cis", cc), ("trans", rc))}
        total_charges = np.array([f.total_charge for f in feats], np.float32)

    with h5py.File(path, "w") as f:
        g = f.create_group("atoms")
        g.create_dataset("offsets", data=atom_off)
        for key, _ in _ATOM_COLS:
            g.create_dataset(key, data=cols[key], **_GZIP)
        g = f.create_group("edges")
        g.create_dataset("offsets", data=edge_off)
        g.create_dataset("dst", data=dst, **_GZIP)
        g.create_dataset("src", data=src, **_GZIP)
        g.create_dataset("hop", data=hop, **_GZIP)
        g = f.create_group("stereo")
        g.create_dataset("tet_offsets", data=offs["tet"])
        g.create_dataset("tet", data=tet.astype(np.int32).reshape(-1, 4))
        g.create_dataset("cis_offsets", data=offs["cis"])
        g.create_dataset("cis", data=cis.astype(np.int32).reshape(-1, 2))
        g.create_dataset("trans_offsets", data=offs["trans"])
        g.create_dataset("trans", data=trans.astype(np.int32).reshape(-1, 2))
        g = f.create_group("graphs")
        g.create_dataset("targets", data=dataset.targets, **_GZIP)
        g.create_dataset("total_charge", data=total_charges)
        g.create_dataset("smiles", data=np.array(dataset.smiles, dtype=_str_dtype()))
        counts = {"atoms": np.diff(atom_off), "edges": np.diff(edge_off),
                  **{k: np.diff(o) for k, o in offs.items()}}
        _write_metadata(f, n, dataset.max_hops, dataset.targets.shape[1], counts,
                        target_columns, preprocessing_state)


def write_hdf5_from_smiles(
    path: str,
    smiles: Sequence[str],
    targets: np.ndarray,
    max_hops: int,
    *,
    num_workers: int = 1,
    target_columns: Optional[Sequence[str]] = None,
    preprocessing_state: Optional[dict] = None,
) -> int:
    """Featurize and write; returns the number of valid molecules kept."""
    ds = MoleculeDataset.from_smiles(smiles, targets, max_hops, num_workers)
    write_hdf5(path, ds, target_columns=target_columns, preprocessing_state=preprocessing_state)
    return len(ds)


class HDF5AppendWriter:
    """Chunk-appendable writer of the schema: ``append(feats, targets,
    smiles)`` per chunk, then ``finalize``; memory holds one chunk, never
    the dataset.  Every column is resizable, in chunks of 65,536 rows."""

    def __init__(self, path: str, max_hops: int, num_tasks: int):
        self.path = path
        self.max_hops = max_hops
        self.num_tasks = num_tasks
        self._file = h5py.File(path, "w")
        self._n = 0
        self._counts: Dict[str, List[np.ndarray]] = {k: [] for k in
                                                      ("atoms", "edges", "tet", "cis", "trans")}
        f = self._file

        def make(group, name, dtype, inner=(), compress=True):
            group.create_dataset(name, shape=(0,) + inner, maxshape=(None,) + inner, dtype=dtype,
                                 chunks=(65536,) + inner, **(_GZIP if compress else {}))

        ga = f.create_group("atoms")
        for key, dt in _ATOM_COLS:
            make(ga, key, dt)
        ge = f.create_group("edges")
        make(ge, "dst", np.int32)
        make(ge, "src", np.int32)
        make(ge, "hop", np.int8)
        gs = f.create_group("stereo")
        make(gs, "tet", np.int32, (4,), compress=False)
        make(gs, "cis", np.int32, (2,), compress=False)
        make(gs, "trans", np.int32, (2,), compress=False)
        gg = f.create_group("graphs")
        make(gg, "targets", np.float32, (num_tasks,))
        make(gg, "total_charge", np.float32, compress=False)
        gg.create_dataset("smiles", shape=(0,), maxshape=(None,), dtype=_str_dtype(),
                          chunks=(65536,))

    @staticmethod
    def _extend(ds, data) -> None:
        n0 = ds.shape[0]
        ds.resize(n0 + len(data), axis=0)
        ds[n0:] = data

    def append(self, feats: Sequence[MolFeatures], targets: np.ndarray,
               smiles: Sequence[str]) -> None:
        if not len(feats):
            return
        f = self._file
        targets = np.asarray(targets, np.float32)
        if targets.ndim == 1:
            targets = targets[:, None]
        for key, dt in _ATOM_COLS:
            self._extend(f["atoms"][key], np.concatenate([getattr(m, key) for m in feats]).astype(dt))
        self._counts["atoms"].append(np.array([m.num_atoms for m in feats], np.int64))
        dst, src, hop, ecounts = _edge_columns(feats)
        if len(dst):
            self._extend(f["edges/dst"], dst)
            self._extend(f["edges/src"], src)
            self._extend(f["edges/hop"], hop)
        self._counts["edges"].append(ecounts)
        for name, key, width in (("tet", "tet_nbrs", 4), ("cis", "cis_pairs", 2),
                                 ("trans", "trans_pairs", 2)):
            rows, counts = _stereo_rows(feats, key, width)
            self._counts[name].append(counts)
            if rows.size:
                self._extend(f[f"stereo/{name}"], rows)
        self._extend(f["graphs/targets"], targets)
        self._extend(f["graphs/total_charge"], np.array([m.total_charge for m in feats], np.float32))
        self._extend(f["graphs/smiles"], np.array(list(smiles), dtype=_str_dtype()))
        self._n += len(feats)

    def finalize(self, *, target_columns: Optional[Sequence[str]] = None,
                 preprocessing_state: Optional[dict] = None) -> int:
        """Write the offsets and the metadata, close the file; returns the
        number of molecules written."""
        f = self._file
        counts = {k: (np.concatenate(c) if c else np.zeros(0, np.int64))
                  for k, c in self._counts.items()}
        offs = {k: np.concatenate([[0], np.cumsum(c)]).astype(np.int64) for k, c in counts.items()}
        f["atoms"].create_dataset("offsets", data=offs["atoms"])
        f["edges"].create_dataset("offsets", data=offs["edges"])
        for name in ("tet", "cis", "trans"):
            f["stereo"].create_dataset(f"{name}_offsets", data=offs[name])
        _write_metadata(f, self._n, self.max_hops, self.num_tasks, counts, target_columns,
                        preprocessing_state)
        f.close()
        return self._n


def write_hdf5_streaming(
    path: str,
    smiles: Sequence[str],
    targets: np.ndarray,
    max_hops: int,
    *,
    chunk_size: int = 8192,
    num_workers: int = 1,
    target_columns: Optional[Sequence[str]] = None,
    preprocessing_state: Optional[dict] = None,
) -> int:
    """Featurize (the native featurizer on ``num_workers`` threads) and
    append ``chunk_size`` molecules at a time; invalid SMILES are dropped
    with their targets.  Returns the number kept."""
    targets = np.asarray(targets, np.float32)
    if targets.ndim == 1:
        targets = targets[:, None]
    writer = HDF5AppendWriter(path, max_hops, targets.shape[1])
    for i in range(0, len(smiles), chunk_size):
        s, t, feats = featurize_many(list(smiles[i: i + chunk_size]), targets[i: i + chunk_size],
                                     max_hops, num_workers)
        writer.append(feats, t, s)
    return writer.finalize(target_columns=target_columns, preprocessing_state=preprocessing_state)


def _chunk_count_matrix(nums_flat: np.ndarray, splits: np.ndarray, n: int) -> np.ndarray:
    """(n, 119) per-molecule element counts of a chunk."""
    C = np.zeros((n, MAX_ATOMIC_NUM), np.float64)
    mol_id = np.repeat(np.arange(n), np.diff(splits))
    z = np.clip(nums_flat.astype(np.int64), 0, MAX_ATOMIC_NUM - 1)
    np.add.at(C, (mol_id, z), 1.0)
    return C


def fit_pipeline_streaming(path: str, config: PreprocessingConfig,
                           chunk_size: int = 65536) -> PreprocessingPipeline:
    """Fit the SAE and the scaler over an HDF5 dataset in one chunked pass
    of its atomic numbers (the JAX ``fit_pipeline_streaming``): the SAE
    least squares from the accumulated normal equations over the
    percentile-filtered rows, and the scaler's moments of the SAE-shifted
    targets from the same sums.  The (N, T) targets are read whole."""
    pipe = PreprocessingPipeline(config)
    with h5py.File(path, "r") as f:
        targets = np.asarray(f["graphs/targets"][:], np.float64)
        N, T = targets.shape
        atom_off = f["atoms/offsets"][:]
        sae_tasks: List[Tuple] = []  # (key, column)
        if config.apply_sae:
            if config.task_type == "regression":
                sae_tasks = [("regression", 0)]
            elif config.sae_subtasks is None:
                raise ValueError("multitask SAE requires sae_subtasks")
            else:
                for st in config.sae_subtasks:
                    if st >= T:
                        raise ValueError(f"Subtask index {st} >= number of targets {T}")
                sae_tasks = [(st, st) for st in config.sae_subtasks]
        pc = config.sae_percentile_cutoff
        masks = {}
        for key, col in sae_tasks:
            b = targets[:, col]
            lo, hi = np.percentile(b, [pc, 100.0 - pc])
            masks[key] = (b >= lo) & (b <= hi)
        AtA = {k: np.zeros((MAX_ATOMIC_NUM, MAX_ATOMIC_NUM)) for k, _ in sae_tasks}
        Atb = {k: np.zeros(MAX_ATOMIC_NUM) for k, _ in sae_tasks}
        Scc = np.zeros((MAX_ATOMIC_NUM, MAX_ATOMIC_NUM))  # unfiltered, for the scaler
        Sc = np.zeros(MAX_ATOMIC_NUM)
        Sct = {k: np.zeros(MAX_ATOMIC_NUM) for k, _ in sae_tasks}
        if sae_tasks:
            for c0 in range(0, N, chunk_size):
                c1 = min(c0 + chunk_size, N)
                nums = f["atoms/atomic_numbers"][atom_off[c0]: atom_off[c1]]
                C = _chunk_count_matrix(nums, atom_off[c0: c1 + 1] - atom_off[c0], c1 - c0)
                Scc += C.T @ C
                Sc += C.sum(axis=0)
                for key, col in sae_tasks:
                    m = masks[key][c0:c1]
                    Cm = C[m]
                    AtA[key] += Cm.T @ Cm
                    Atb[key] += Cm.T @ targets[c0:c1, col][m]
                    Sct[key] += C.T @ targets[c0:c1, col]
            stats, sols = {}, {}
            for key, _ in sae_tasks:
                sol, *_ = np.linalg.lstsq(AtA[key], Atb[key], rcond=None)
                sols[key] = sol
                stats[key] = {z: float(v) for z, v in enumerate(sol) if not np.isnan(v)}
            norm = SAENormalizer(config.task_type, pc)
            norm.sae_statistics = stats
            norm.is_fitted = True
            pipe.sae_normalizer = norm
        if config.apply_standard_scaling:
            # sum x = sum t - Sc.s;  sum x^2 = sum t^2 - 2 s.Sct + s^T Scc s
            S1 = targets.sum(axis=0)
            S2 = (targets ** 2).sum(axis=0)
            means, variances = np.empty(T), np.empty(T)
            sae_cols = {col: key for key, col in sae_tasks}
            for j in range(T):
                if j in sae_cols:
                    s = sols[sae_cols[j]]
                    sx = S1[j] - Sc @ s
                    sx2 = S2[j] - 2.0 * (s @ Sct[sae_cols[j]]) + s @ Scc @ s
                else:
                    sx, sx2 = S1[j], S2[j]
                means[j] = sx / N
                variances[j] = max((sx2 - sx * sx / N) / max(N - 1, 1), 0.0)
            scaler = StandardScaler()
            scaler.means = means.astype(np.float32)
            scaler.stds = np.sqrt(variances).astype(np.float32)
            scaler.stds[scaler.stds < 1e-12] = 1.0
            scaler.is_fitted = True
            pipe.standard_scaler = scaler
    pipe.is_fitted = True
    return pipe


def transform_targets_streaming(path: str, pipe: PreprocessingPipeline,
                                chunk_size: int = 65536) -> None:
    """Apply a fitted pipeline to ``graphs/targets`` in place, a chunk at a
    time, and record its state in the metadata."""
    with h5py.File(path, "r+") as f:
        N = int(f["metadata"].attrs["num_molecules"])
        atom_off = f["atoms/offsets"][:]
        for c0 in range(0, N, chunk_size):
            c1 = min(c0 + chunk_size, N)
            raw = np.asarray(f["graphs/targets"][c0:c1], np.float64)
            nums = f["atoms/atomic_numbers"][atom_off[c0]: atom_off[c1]]
            splits = atom_off[c0: c1 + 1] - atom_off[c0]
            f["graphs/targets"][c0:c1] = pipe.transform(
                np.split(nums.astype(np.int32), splits[1:-1]), raw)
        f["metadata"].attrs["preprocessing"] = json.dumps(pipe.state_dict())


class HDF5MoleculeDataset:
    """Reader of the schema: metadata at open, the offsets read once, and
    contiguous blocks of molecules read with one slice per column."""

    def __init__(self, path: str):
        self.path = path
        self._file: Optional[h5py.File] = None
        self._off: Optional[dict] = None
        with h5py.File(path, "r") as f:
            meta = f["metadata"].attrs
            self.num_molecules = int(meta["num_molecules"])
            self.max_hops = int(meta["max_hops"])
            self.num_tasks = int(meta["num_tasks"])
            self.max_atoms_per_mol = int(meta["max_atoms_per_mol"])
            self.max_edges_per_mol = int(meta["max_edges_per_mol"])
            self.max_tet_per_mol = int(meta.get("max_tet_per_mol", 0))
            self.max_pairs_per_mol = int(meta.get("max_pairs_per_mol", 0))
            self.target_columns = (json.loads(meta["target_columns"])
                                   if "target_columns" in meta else None)
            self.preprocessing_state = (json.loads(meta["preprocessing"])
                                        if "preprocessing" in meta else None)

    def __len__(self) -> int:
        return self.num_molecules

    @property
    def file(self) -> h5py.File:
        if self._file is None:
            self._file = h5py.File(self.path, "r")
        return self._file

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def offsets(self) -> dict:
        """The offset arrays, read once."""
        if self._off is None:
            f = self.file
            self._off = {"atoms": f["atoms/offsets"][:], "edges": f["edges/offsets"][:],
                         "tet": f["stereo/tet_offsets"][:], "cis": f["stereo/cis_offsets"][:],
                         "trans": f["stereo/trans_offsets"][:]}
        return self._off

    def per_mol_counts(self) -> Optional[dict]:
        """Per-molecule atom, edge, centre and pair counts (the larger of
        cis and trans rows) from the offsets; None for a file without them."""
        try:
            off = self.offsets()
        except KeyError:
            return None
        return {"atoms": np.diff(off["atoms"]), "edges": np.diff(off["edges"]),
                "tets": np.diff(off["tet"]),
                "pairs": np.maximum(np.diff(off["cis"]), np.diff(off["trans"]))}

    def sizes(self) -> Dict[str, np.ndarray]:
        """The counts ``MoleculeDataset.sizes`` gives for the same molecules
        (pairs after the reversed copies), which the loaders size slots by."""
        c = self.per_mol_counts()
        return {"atoms": c["atoms"], "edges": c["edges"], "tets": c["tets"],
                "pairs": 2 * c["pairs"]}

    def read_block_cache(self, start: int, end: int) -> Tuple[ColumnarCache, np.ndarray]:
        """Molecules ``[start, end)`` as a :class:`ColumnarCache` (the
        schema maps onto it column for column: local atom indices, hop-major
        edges) and their (n, T) targets."""
        f = self.file
        off = self.offsets()
        ao, eo = off["atoms"], off["edges"]
        to, co, ro = off["tet"], off["cis"], off["trans"]
        a0, a1, e0, e1 = ao[start], ao[end], eo[start], eo[end]

        def local(o):
            return np.ascontiguousarray((o[start: end + 1] - o[start]).astype(np.int64))

        def i32(x):
            return np.ascontiguousarray(np.asarray(x, np.int32))

        cache = ColumnarCache(
            atom_type=i32(f["atoms/atom_type"][a0:a1]),
            hydrogen_count=i32(f["atoms/hydrogen_count"][a0:a1]),
            degree=i32(f["atoms/degree"][a0:a1]),
            hybridization=i32(f["atoms/hybridization"][a0:a1]),
            mol_atom_off=local(ao),
            edge_dst=i32(f["edges/dst"][e0:e1]),
            edge_src=i32(f["edges/src"][e0:e1]),
            edge_hop=i32(f["edges/hop"][e0:e1]),
            mol_edge_off=local(eo),
            tet=i32(f["stereo/tet"][to[start]: to[end]]).reshape(-1, 4),
            mol_tet_off=local(to),
            cis=i32(f["stereo/cis"][co[start]: co[end]]).reshape(-1, 2),
            mol_cis_off=local(co),
            trans=i32(f["stereo/trans"][ro[start]: ro[end]]).reshape(-1, 2),
            mol_trans_off=local(ro),
            total_charge=np.asarray(f["graphs/total_charge"][start:end], np.float32),
            atomic_numbers=i32(f["atoms/atomic_numbers"][a0:a1]),
            processed_smiles=[_decode(s) for s in f["graphs/smiles"][start:end]],
        )
        return cache, np.asarray(f["graphs/targets"][start:end], np.float32)

    def block_dataset(self, start: int, end: int) -> MoleculeDataset:
        """Molecules ``[start, end)`` as a :class:`MoleculeDataset` over
        their columnar cache (the form the port's loaders batch)."""
        cache, targets = self.read_block_cache(start, end)
        return MoleculeDataset(smiles=list(cache.processed_smiles), targets=targets,
                               features=LazyFeatures(cache, self.max_hops),
                               max_hops=self.max_hops, columnar=cache)

    def read_block(self, start: int, end: int) -> Tuple[List[MolFeatures], np.ndarray]:
        """Molecules ``[start, end)`` as per-molecule features (views of one
        block read) and their targets."""
        ds = self.block_dataset(start, end)
        return list(ds.features), ds.targets

    def get_features(self, i: int) -> MolFeatures:
        return self.read_block(i, i + 1)[0][0]

    def load_all(self) -> MoleculeDataset:
        return self.block_dataset(0, self.num_molecules)


class HDF5BatchLoader(BatchLoader):
    """Streams the batches the port's :class:`BatchLoader` makes (binned
    from the native builder, with its scratch rotation; flat with the
    aggregation kernel's layouts when a molecule exceeds ``bin_ab``; halo
    shards with ``halo_shards`` and ``rank``), reading the HDF5 file a
    block of ``block_batches`` steps at a time (the JAX ``HDF5BatchLoader``):

    - this host's molecules are the contiguous chunk ``host_id`` of
      ``num_hosts`` (``ceil(N / num_hosts)`` each);
    - with ``shuffle`` the order of epoch ``e`` (``set_epoch``) is
      two-level, from ``np.random.default_rng(seed + e)``: the block order,
      then each block's molecules, as the JAX loader draws them; without it
      the file's order;
    - a step's molecules come from one block, so the block that ends the
      host's chunk ends in a short step wherever it falls in the epoch
      (dropped with ``drop_last``), as the JAX native path does;
    - slot caps are top-k sums of the per-molecule counts, so a step of
      the file's molecules has the shapes the in-memory loader gives them.
    """

    def __init__(
        self,
        dataset: HDF5MoleculeDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        host_id: int = 0,
        num_hosts: int = 1,
        stack_devices: int = 0,
        block_batches: int = 16,
        bin_ab: int = DEFAULT_AB,
        bin_mb: int = DEFAULT_MB,
        halo_shards: int = 1,
        rank: Optional[Tuple[int, int]] = None,
    ):
        if (halo_shards > 1 or rank is not None) and stack_devices == 0:
            stack_devices = 1  # halo shards carry a leading data axis
        self.ds = dataset
        self.drop_last = drop_last
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.block_batches = block_batches
        super().__init__(dataset, batch_size, bin_ab=bin_ab, bin_mb=bin_mb, shuffle=shuffle,
                         seed=seed, stack_devices=stack_devices, halo_shards=halo_shards,
                         rank=rank)

    def __len__(self) -> int:
        n = math.ceil(len(self.ds) / self.num_hosts)
        b = self.batch_size * max(1, self.stack_devices)
        return n // b if self.drop_last else math.ceil(n / b)

    def _blocks(self) -> List[Tuple[int, int, np.ndarray]]:
        """This epoch's blocks in order: (start, end, the block's molecule
        order, local)."""
        n = len(self.ds)
        per_host = math.ceil(n / self.num_hosts)
        h0 = self.host_id * per_host
        h1 = min(h0 + per_host, n)
        group = self.batch_size * max(1, self.stack_devices)
        block = max(self.block_batches * group, 1)
        starts = list(range(h0, h1, block))
        rng = np.random.default_rng(self.seed + self._epoch) if self.shuffle else None
        if rng is not None:
            rng.shuffle(starts)
        out = []
        for s in starts:
            e = min(s + block, h1)
            order = np.arange(e - s)
            if rng is not None:
                rng.shuffle(order)
            out.append((s, e, order))
        return out

    def _groups(self, order: np.ndarray) -> List[np.ndarray]:
        group = self.batch_size * max(1, self.stack_devices)
        return [order[lo: lo + group] for lo in range(0, len(order), group)
                if not (self.drop_last and len(order) - lo < group)]

    def _batch_indices(self) -> List[np.ndarray]:
        """Every step's molecules (file indices) in this epoch's order."""
        return [s + idx for s, _, order in self._blocks() for idx in self._groups(order)]

    def __iter__(self) -> Iterator[MolBatch]:
        try:
            for s, e, order in self._blocks():
                # the block's molecules are the engine's dataset meanwhile
                self.dataset = self.ds.block_dataset(s, e)
                self._columnar = None
                for idx in self._groups(order):
                    yield self._step(idx)
        finally:
            self.dataset = self.ds
            self._columnar = None
