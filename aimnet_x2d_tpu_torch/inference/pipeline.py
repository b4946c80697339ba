"""Streaming CSV inference (counterpart of
aimnet_x2d_tpu/inference/pipeline.py).

Chunked pandas reads -> featurization in a background thread, one chunk
ahead (natively on ``num_workers`` C++ threads, which release the GIL, so
it overlaps the device) -> fixed-shape batches, binned or flat as each
chunk's loader picks (flat when a molecule exceeds a bin) -> the model on
the chosen device, deterministic, MC-dropout (``mc_samples`` stochastic
forwards, mean and std) or evidential (gamma with aleatoric, epistemic and
total uncertainty) -> inverse transform -> append to the output CSV.  The
artifact is self-describing: model config, weights and preprocessing come
from one file.

Over several ranks (one process each, ``torchrun``; parallel/multihost.py)
``run_csv`` shards the CSV into contiguous line ranges, one per rank, each
rank writes ``<out>.rank<r>``, and after a barrier rank 0 merges the rank
files in rank order and removes them (the JAX ``run_csv``).

``run_hdf5`` serves a columnar HDF5 file (data/hdf5.py) a chunk of
``chunk_size`` molecules at a time, each chunk one block read, through the
same loop.  With ``save_embeddings`` deterministic serving also writes each
molecule's embedding and SMILES (and with ``include_atom_embeddings`` its
atoms' embeddings and offsets) to an HDF5 file as it goes
(:class:`StreamingEmbeddingWriter`); over ranks each rank writes
``<emb>.rank<r>`` and rank 0 merges them after the barrier.  MC-dropout and
evidential serving write none, as in the JAX package.  Only the HDF5 parts
import ``h5py``.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from ..checkpoint import Artifact, load_artifact, params_from_flax
from ..chem import native
from ..data.dataset import BatchLoader, MoleculeDataset
from ..models.gnn import GNN
from ..parallel import multihost
from ..training.predictor import predict, predict_evidential, predict_mc_dropout
from ..utils.device import resolve_device


class StreamingEmbeddingWriter:
    """Embeddings appended to an HDF5 file a chunk at a time, flushed every
    ``flush_every`` appends (the JAX ``StreamingEmbeddingWriter``, same
    schema): ``mol_embeddings`` (N, D) float32 and ``smiles`` in resizable
    datasets (gzip level 1, chunks of 4096 rows), and with
    ``include_atoms`` ``atom_embeddings`` (sum A, D) (chunks of 16384 rows)
    with ``atom_offsets`` (N+1,) written at ``close``."""

    def __init__(self, path: str, include_atoms: bool = False, flush_every: int = 100):
        import h5py

        self._h5py = h5py
        self.file = h5py.File(path, "w")
        self.include_atoms = include_atoms
        self.flush_every = flush_every
        self._appends = 0
        self._made = False
        self._atom_counts: List[np.ndarray] = []

    def _ensure(self, mol_dim: int, atom_dim: Optional[int]) -> None:
        if self._made:
            return
        f, h5py = self.file, self._h5py
        opts = dict(compression="gzip", compression_opts=1)
        f.create_dataset("mol_embeddings", shape=(0, mol_dim), maxshape=(None, mol_dim),
                         dtype=np.float32, chunks=(4096, mol_dim), **opts)
        f.create_dataset("smiles", shape=(0,), maxshape=(None,),
                         dtype=h5py.special_dtype(vlen=str), chunks=(4096,))
        if self.include_atoms and atom_dim is not None:
            f.create_dataset("atom_embeddings", shape=(0, atom_dim), maxshape=(None, atom_dim),
                             dtype=np.float32, chunks=(16384, atom_dim), **opts)
        self._made = True

    @staticmethod
    def _extend(ds, data) -> None:
        n0 = ds.shape[0]
        ds.resize(n0 + len(data), axis=0)
        ds[n0:] = data

    def append(self, mol_embeddings: np.ndarray, smiles: Sequence[str],
               atom_embeddings: Optional[np.ndarray] = None,
               atom_mol_index: Optional[np.ndarray] = None) -> None:
        self._ensure(mol_embeddings.shape[1],
                     atom_embeddings.shape[1] if atom_embeddings is not None else None)
        f = self.file
        self._extend(f["mol_embeddings"], np.asarray(mol_embeddings, np.float32))
        self._extend(f["smiles"], np.array(list(smiles), dtype=self._h5py.special_dtype(vlen=str)))
        if self.include_atoms and atom_embeddings is not None:
            self._extend(f["atom_embeddings"], np.asarray(atom_embeddings, np.float32))
            self._atom_counts.append(np.bincount(np.asarray(atom_mol_index),
                                                 minlength=len(mol_embeddings)).astype(np.int64))
        self._appends += 1
        if self._appends % self.flush_every == 0:
            f.flush()

    def close(self) -> None:
        if self.include_atoms and self._atom_counts:
            counts = np.concatenate(self._atom_counts)
            self.file.create_dataset("atom_offsets", data=np.concatenate([[0], np.cumsum(counts)]))
        self.file.close()


class StreamingInferencePipeline:
    def __init__(
        self,
        artifact_path: str,
        chunk_size: int = 1000,
        batch_size: int = 64,
        device: "str | torch.device" = "cuda",
        inference_mode: str = "deterministic",
        mc_samples: int = 0,
        num_workers: int = 1,
        save_embeddings: bool = False,
        embeddings_output_path: Optional[str] = None,
        include_atom_embeddings: bool = False,
    ):
        if inference_mode not in ("deterministic", "mc_dropout", "evidential"):
            raise ValueError(f"unknown inference mode {inference_mode!r}")
        if inference_mode == "mc_dropout" and mc_samples <= 0:
            raise ValueError("mc_dropout needs mc_samples > 0")
        self.mode = inference_mode
        self.mc_samples = mc_samples
        self.num_workers = max(num_workers, 1)
        self.save_embeddings = save_embeddings
        self.embeddings_output_path = embeddings_output_path
        self.include_atom_embeddings = include_atom_embeddings
        self.device = resolve_device(device)
        self.artifact: Artifact = load_artifact(artifact_path)
        self.model = GNN(self.artifact.model_config)
        self.model.load_state_dict(params_from_flax(self.artifact.params))
        self.model.to(self.device).eval()
        self.pipeline = self.artifact.pipeline
        self.chunk_size = chunk_size
        self.batch_size = batch_size
        self.max_hops = int(
            self.artifact.extra.get("max_hops", self.artifact.model_config.num_shells)
        )
        self.target_columns: List[str] = self.artifact.extra.get("target_columns") or ["prediction"]
        # running slot caps so every chunk shares one batch shape
        self._slots: Dict[str, int] = {}
        self.featurize_seconds = 0.0
        if self.mode == "evidential" and self.artifact.model_config.loss_function != "evidential":
            raise ValueError("evidential inference needs a model trained with the evidential loss")

    def _predict_dataset(self, ds: MoleculeDataset) -> Dict[str, np.ndarray]:
        loader = BatchLoader(ds, self.batch_size)
        loader.warm_bin_pins()
        loader.pin_slots(self._slots)
        if self.mode == "mc_dropout":
            res = predict_mc_dropout(self.model, loader, self.device, self.mc_samples,
                                     pipeline=self.pipeline)
        elif self.mode == "evidential":
            res = predict_evidential(self.model, loader, self.device, len(self.target_columns),
                                     pipeline=self.pipeline)
        else:
            res = predict(self.model, loader, self.device, pipeline=self.pipeline,
                          return_embeddings=self.save_embeddings)
        loader.pin_slots(self._slots)
        return res

    def _result_frame(self, ds: MoleculeDataset, res: Dict[str, np.ndarray]) -> pd.DataFrame:
        out = {"smiles": ds.smiles}
        preds = res["predictions"]
        T = len(self.target_columns)
        if preds.shape[1] == 4 * T:
            # evidential model run in deterministic mode: report the gamma head
            preds = preds.reshape(len(preds), T, 4)[:, :, 0]
        for t, col in enumerate(self.target_columns):
            out[col] = preds[:, t]
        for key, suffix in (
            ("uncertainty", "_uncertainty"),
            ("aleatoric_uncertainty", "_aleatoric"),
            ("epistemic_uncertainty", "_epistemic"),
            ("total_uncertainty", "_total_uncertainty"),
        ):
            if key in res:
                for t, col in enumerate(self.target_columns):
                    out[col + suffix] = res[key][:, t]
        return pd.DataFrame(out)

    def _featurize_ahead(
        self, chunks: Iterable[Tuple[List[str], Optional[MoleculeDataset]]], depth: int = 2
    ) -> Iterator[Tuple[List[str], MoleculeDataset]]:
        """Featurize chunk N+1 in a background thread while the device
        predicts chunk N: each ``(smiles, dataset)`` item whose dataset is
        None is featurized there (a chunk read from an HDF5 file comes
        featurized, its read made there).  Adds that time to
        ``featurize_seconds``; re-raises a worker error in the caller."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        done = object()
        stop = threading.Event()
        errors: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                t0 = time.perf_counter()
                for smiles, ds in chunks:
                    if ds is None:
                        ds = MoleculeDataset.from_smiles(
                            smiles, np.zeros((len(smiles), 1), np.float32), self.max_hops,
                            self.num_workers)
                    self.featurize_seconds += time.perf_counter() - t0
                    if not put((smiles, ds)):
                        return
                    t0 = time.perf_counter()
            except Exception as e:  # surfaced in the consumer thread
                errors.append(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=60)
        if errors:
            raise errors[0]

    def _run_chunks(self, chunks: Iterable[Tuple[List[str], Optional[MoleculeDataset]]],
                    output_path: str, embeddings_path: Optional[str] = None) -> Tuple[int, int]:
        """Predict every chunk, append its rows to ``output_path`` and, with
        ``save_embeddings`` in deterministic mode, its embeddings to a
        :class:`StreamingEmbeddingWriter` on ``embeddings_path``.  Returns
        (molecules read, molecules predicted)."""
        n_total = n_valid = 0
        first = True
        writer = None
        if self.save_embeddings and embeddings_path:
            writer = StreamingEmbeddingWriter(embeddings_path,
                                              include_atoms=self.include_atom_embeddings)
        try:
            for smiles, ds in self._featurize_ahead(chunks):
                n_total += len(smiles)
                if len(ds) == 0:
                    continue
                n_valid += len(ds)
                res = self._predict_dataset(ds)
                frame = self._result_frame(ds, res)
                frame.to_csv(output_path, mode="w" if first else "a", header=first, index=False)
                first = False
                if writer is not None and "mol_embeddings" in res:
                    writer.append(res["mol_embeddings"], ds.smiles, res.get("atom_embeddings"),
                                  res.get("atom_mol_index"))
        finally:
            if writer is not None:
                writer.close()
        if first:  # no valid molecules: still write an (empty) output file
            pd.DataFrame(columns=["smiles"] + list(self.target_columns)).to_csv(
                output_path, index=False
            )
        return n_total, n_valid

    @staticmethod
    def _csv_data_rows(csv_path: str) -> int:
        """Data lines of a CSV: its lines less the header."""
        with open(csv_path, "rb") as fh:
            n = sum(1 for _ in fh)
        return max(n - 1, 0)

    @staticmethod
    def _merge_rank_files(output_path: str, num_hosts: int) -> None:
        """Concatenate ``<out>.rank0 .. rank<n-1>`` into ``output_path`` in
        rank order (their rows are the CSV's line ranges in order), then
        remove them."""
        frames = []
        for h in range(num_hosts):
            shard = f"{output_path}.rank{h}"
            if os.path.exists(shard):
                df = pd.read_csv(shard)
                if len(df):
                    frames.append(df)
        merged = pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()
        merged.to_csv(output_path, index=False)
        for h in range(num_hosts):
            shard = f"{output_path}.rank{h}"
            if os.path.exists(shard):
                os.remove(shard)

    @staticmethod
    def _merge_rank_embeddings(path: str, num_hosts: int) -> None:
        """Concatenate the rank files ``<path>.rank<r>`` of the embedding
        writer into ``path`` in rank order (atom offsets rebuilt from each
        rank's counts), then remove them (the JAX ``_merge_rank_embeddings``)."""
        import h5py

        shards = [s for s in (f"{path}.rank{h}" for h in range(num_hosts)) if os.path.exists(s)]
        with h5py.File(path, "w") as out:
            mols, smiles, atoms, counts = [], [], [], []
            for s in shards:
                with h5py.File(s, "r") as f:
                    if "mol_embeddings" not in f:
                        continue
                    mols.append(f["mol_embeddings"][:])
                    smiles.append(f["smiles"][:])
                    if "atom_embeddings" in f:
                        atoms.append(f["atom_embeddings"][:])
                        counts.append(np.diff(f["atom_offsets"][:]))
            if mols:
                out.create_dataset("mol_embeddings", data=np.concatenate(mols))
                out.create_dataset("smiles", data=np.concatenate(smiles))
            if atoms:
                out.create_dataset("atom_embeddings", data=np.concatenate(atoms))
                c = np.concatenate(counts)
                out.create_dataset("atom_offsets", data=np.concatenate([[0], np.cumsum(c)]))
        for s in shards:
            os.remove(s)

    def run_csv(
        self,
        csv_path: str,
        output_path: str,
        smiles_column: str = "smiles",
        host_id: Optional[int] = None,
        num_hosts: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Predict every SMILES of ``csv_path`` into ``output_path``;
        return counts and timings (featurization time shown apart).

        Over several ranks (``num_hosts`` > 1; by default the process
        group's size and this process's rank) rank ``host_id`` predicts the
        contiguous line range ``[host_id * per, (host_id + 1) * per)`` of the
        CSV's ``n`` data lines, ``per = ceil(n / num_hosts)``, into
        ``<output_path>.rank<host_id>`` (and its embeddings into
        ``<embeddings_output_path>.rank<host_id>``); the counts are
        all-gathered, and after a barrier rank 0 merges the rank files in
        rank order and removes them, then every rank waits for the merge."""

        def chunks(start, end):
            kw = {} if start is None else dict(skiprows=range(1, 1 + start),
                                               nrows=max(end - start, 0))
            for chunk in pd.read_csv(csv_path, chunksize=self.chunk_size, **kw):
                yield chunk[smiles_column].astype(str).tolist(), None

        return self._run_ranked(chunks, lambda: self._csv_data_rows(csv_path), output_path,
                                host_id, num_hosts)

    def run_hdf5(self, hdf5_path: str, output_path: str, host_id: Optional[int] = None,
                 num_hosts: Optional[int] = None) -> Dict[str, Any]:
        """Predict every molecule of a columnar HDF5 file (data/hdf5.py)
        into ``output_path`` (and its embeddings, with ``save_embeddings``),
        a block read of ``chunk_size`` molecules at a time (the JAX
        ``run_hdf5``; ``featurize_seconds`` holds the reads); over ranks as
        ``run_csv``, each rank a contiguous range of the file's molecules."""
        from ..data.hdf5 import HDF5MoleculeDataset

        h5 = HDF5MoleculeDataset(hdf5_path)

        def chunks(start, end):
            start, end = (0, len(h5)) if start is None else (start, end)
            for s in range(start, end, self.chunk_size):
                ds = h5.block_dataset(s, min(s + self.chunk_size, end))
                yield ds.smiles, ds

        try:
            return self._run_ranked(chunks, lambda: len(h5), output_path, host_id, num_hosts)
        finally:
            h5.close()

    def _run_ranked(self, chunks, count, output_path: str, host_id: Optional[int],
                    num_hosts: Optional[int]) -> Dict[str, Any]:
        """``_run_chunks`` over this rank's range of ``count()`` inputs
        (``chunks(start, end)``; all of them, ``chunks(None, None)``, on one
        rank), then the rank files' merge (``run_csv``)."""
        if num_hosts is None:
            num_hosts = multihost.process_count()
            host_id = multihost.process_index()
        t0 = time.perf_counter()
        self.featurize_seconds = 0.0
        emb = self.embeddings_output_path if self.save_embeddings else None
        if num_hosts <= 1:
            my_out, my_emb, items = output_path, emb, chunks(None, None)
        else:
            n = count()
            per = -(-n // num_hosts)
            my_out = f"{output_path}.rank{host_id}"
            my_emb = f"{emb}.rank{host_id}" if emb else None
            items = chunks(host_id * per, min((host_id + 1) * per, n))
        n_total, n_valid = self._run_chunks(items, my_out, my_emb)
        if num_hosts > 1:
            counts = multihost.allgather_numpy(np.array([[n_total, n_valid]], np.int64))
            multihost.sync()  # every rank file is complete past this point
            n_total, n_valid = (int(x) for x in counts.sum(axis=0))
            if host_id == 0:
                self._merge_rank_files(output_path, num_hosts)
                if emb:
                    self._merge_rank_embeddings(emb, num_hosts)
            multihost.sync()  # hold the rank files until the merge is done
        return self._summary(output_path, t0, n_total, n_valid, num_hosts, host_id)

    def _summary(self, output_path: str, t0: float, n_total: int, n_valid: int,
                 num_hosts: int = 1, host_id: Optional[int] = 0) -> Dict[str, Any]:
        dt = time.perf_counter() - t0
        summary = {
            "total_molecules": n_total,
            "valid_molecules": n_valid,
            "output_path": output_path,
            "device": str(self.device),
            "seconds": dt,
            "featurize_seconds": self.featurize_seconds,
            "featurizer": native.describe(self.num_workers),
            "inference_mode": self.mode,
            "molecules_per_second": n_valid / dt if dt > 0 else 0.0,
            "ranks": num_hosts,
        }
        print(
            f"[inference] {n_valid}/{n_total} molecules -> {output_path} on {self.device}"
            + (f" (rank {host_id} of {num_hosts})" if num_hosts > 1 else "") + ", "
            f"{self.mode} ({summary['molecules_per_second']:.0f} mol/s; featurization "
            f"{self.featurize_seconds:.2f} s of {dt:.2f} s, {summary['featurizer']})"
        )
        return summary
