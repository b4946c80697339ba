"""Deterministic prediction (counterpart of
aimnet_x2d_tpu/training/predictor.py::predict).

MC-dropout and evidential uncertainty are later slices of the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.gnn import GNN


def predict(
    model: GNN,
    loader,
    device: "str | torch.device",
    pipeline=None,
    return_embeddings: bool = False,
) -> Dict[str, np.ndarray]:
    """Run ``model`` over every batch of ``loader`` on ``device`` under
    ``torch.inference_mode()``; return the real molecules' predictions in
    loader order, inverse-transformed by ``pipeline`` when given."""
    preds, mols, atoms, atom_mols = [], [], [], []
    with torch.inference_mode():
        for batch in loader:
            out = model(batch.to(device), atom_embeddings=return_embeddings)
            gm = batch.graph_mask
            preds.append(out.predictions.cpu().numpy()[gm])
            if return_embeddings:
                am = batch.atom_mask
                mols.append(out.mol_embeddings.cpu().numpy()[gm])
                atoms.append(out.atom_embeddings.cpu().numpy()[am])
                # graph slots -> dense molecule order (binned layouts
                # intersperse padding slots)
                local = _dense_mol_rank(gm, batch.atom_mol[am])
                offset = sum(int(x.shape[0]) for x in mols[:-1])
                atom_mols.append(local + offset)
    result: Dict[str, np.ndarray] = {"predictions": np.concatenate(preds)}
    if pipeline is not None:
        result["predictions"] = _inverse(result["predictions"], pipeline)
    if return_embeddings:
        result["mol_embeddings"] = np.concatenate(mols)
        result["atom_embeddings"] = np.concatenate(atoms)
        result["atom_mol_index"] = np.concatenate(atom_mols)
    return result


def _inverse(preds: np.ndarray, pipeline) -> np.ndarray:
    if pipeline is None:
        return preds
    scaler = pipeline.standard_scaler
    if scaler is not None and scaler.is_fitted:
        T = scaler.stds.shape[0]
        if preds.shape[1] == 4 * T:
            # evidential raw outputs: inverse-transform the gamma head only
            out = preds.reshape(len(preds), T, 4).copy()
            out[:, :, 0] = scaler.inverse_transform(out[:, :, 0])
            return out.reshape(len(preds), 4 * T)
    return pipeline.inverse_transform(preds)


def _dense_mol_rank(graph_mask: np.ndarray, slot_ids: np.ndarray) -> np.ndarray:
    """Map graph-slot ids of real atoms to their molecule's rank
    0..n_real-1 (collapses the binned layout's padding slots)."""
    real = np.flatnonzero(graph_mask)
    return np.searchsorted(real, slot_ids).astype(np.int64)
