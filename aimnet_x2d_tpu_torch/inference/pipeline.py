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
files in rank order and removes them (the JAX ``run_csv``).  Embedding
output and HDF5 input are later slices of the port.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

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
    ):
        if inference_mode not in ("deterministic", "mc_dropout", "evidential"):
            raise ValueError(f"unknown inference mode {inference_mode!r}")
        if inference_mode == "mc_dropout" and mc_samples <= 0:
            raise ValueError("mc_dropout needs mc_samples > 0")
        self.mode = inference_mode
        self.mc_samples = mc_samples
        self.num_workers = max(num_workers, 1)
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
            res = predict(self.model, loader, self.device, pipeline=self.pipeline)
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
        self, chunks: Iterable[List[str]], depth: int = 2
    ) -> Iterator[Tuple[List[str], MoleculeDataset]]:
        """Featurize chunk N+1 in a background thread while the device
        predicts chunk N.  Adds the featurization time to
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
                for smiles in chunks:
                    t0 = time.perf_counter()
                    ds = MoleculeDataset.from_smiles(
                        smiles, np.zeros((len(smiles), 1), np.float32), self.max_hops,
                        self.num_workers)
                    self.featurize_seconds += time.perf_counter() - t0
                    if not put((smiles, ds)):
                        return
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

    def _run_chunks(self, chunks: Iterable[List[str]], output_path: str) -> Tuple[int, int]:
        n_total = n_valid = 0
        first = True
        for smiles, ds in self._featurize_ahead(chunks):
            n_total += len(smiles)
            if len(ds) == 0:
                continue
            n_valid += len(ds)
            frame = self._result_frame(ds, self._predict_dataset(ds))
            frame.to_csv(output_path, mode="w" if first else "a", header=first, index=False)
            first = False
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
        ``<output_path>.rank<host_id>``; the counts are all-gathered, and
        after a barrier rank 0 merges the rank files in rank order and
        removes them, then every rank waits for the merge."""
        if num_hosts is None:
            num_hosts = multihost.process_count()
            host_id = multihost.process_index()
        t0 = time.perf_counter()
        self.featurize_seconds = 0.0
        if num_hosts <= 1:
            my_out = output_path
            reader = pd.read_csv(csv_path, chunksize=self.chunk_size)
        else:
            n_rows = self._csv_data_rows(csv_path)
            per = -(-n_rows // num_hosts)
            start, end = host_id * per, min((host_id + 1) * per, n_rows)
            my_out = f"{output_path}.rank{host_id}"
            reader = pd.read_csv(csv_path, skiprows=range(1, 1 + start),
                                 nrows=max(end - start, 0), chunksize=self.chunk_size)

        def chunks():
            for chunk in reader:
                yield chunk[smiles_column].astype(str).tolist()

        n_total, n_valid = self._run_chunks(chunks(), my_out)
        if num_hosts > 1:
            counts = multihost.allgather_numpy(np.array([[n_total, n_valid]], np.int64))
            multihost.sync()  # every rank file is complete past this point
            n_total, n_valid = (int(x) for x in counts.sum(axis=0))
            if host_id == 0:
                self._merge_rank_files(output_path, num_hosts)
            multihost.sync()  # hold the rank files until the merge is done
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
