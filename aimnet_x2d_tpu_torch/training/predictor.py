"""Prediction: deterministic, MC-dropout and evidential, and partial-charge
extraction (counterpart of aimnet_x2d_tpu/training/predictor.py).

MC-dropout runs the model's training forward (dropout on) S times a batch
under ``torch.inference_mode()``: nothing is kept for a backward, and on
binned batches the training-form kernels serve.  Evidential prediction is
one serving forward whose (B, 4T) outputs are split into the
normal-inverse-gamma parameters.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.gnn import GNN
from ..models.losses import evidential_params


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


def predict_mc_dropout(
    model: GNN,
    loader,
    device: "str | torch.device",
    num_samples: int,
    generator: Optional[torch.Generator] = None,
    pipeline=None,
) -> Dict[str, np.ndarray]:
    """MC-dropout: ``num_samples`` stochastic forwards of every batch (the
    training forward, dropout on, masks from ``generator``: one generator
    on ``device`` seeded 0 when none is given, as JAX's ``PRNGKey(0)``).
    Returns the mean over the samples as ``predictions`` and their
    population std as ``uncertainty``, the mean inverse-transformed and the
    std scaled by the scaler's stds when ``pipeline`` is given."""
    device = torch.device(device)
    gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    means, stds = [], []
    with torch.inference_mode():
        for batch in loader:
            dev_batch = batch.to(device)
            gm = batch.graph_mask
            samples = np.stack([
                model(dev_batch, train=True, generator=gen).predictions.cpu().numpy()[gm]
                for _ in range(num_samples)])  # (S, B, T)
            means.append(samples.mean(axis=0))
            stds.append(samples.std(axis=0))
    mean, std = np.concatenate(means), np.concatenate(stds)
    if pipeline is not None and pipeline.standard_scaler is not None:
        mean = pipeline.inverse_transform(mean)
        std = std * pipeline.standard_scaler.stds  # a spread scales, it does not shift
    return {"predictions": mean, "uncertainty": std}


def predict_evidential(
    model: GNN,
    loader,
    device: "str | torch.device",
    num_tasks: int,
    pipeline=None,
) -> Dict[str, np.ndarray]:
    """Evidential prediction: the mean gamma and its aleatoric
    (beta / (alpha - 1)) and epistemic (beta / (nu (alpha - 1)))
    uncertainties and their sum, in target units when ``pipeline`` is
    given (variances scale by the scaler's stds squared, in float64)."""
    gammas, aleas, epis = [], [], []
    with torch.inference_mode():
        for batch in loader:
            raw = model(batch.to(device)).predictions
            gamma, nu, alpha, beta = evidential_params(raw, num_tasks)
            gm = batch.graph_mask
            gammas.append(gamma.cpu().numpy()[gm])
            aleas.append((beta / (alpha - 1.0)).cpu().numpy()[gm])
            epis.append((beta / (nu * (alpha - 1.0))).cpu().numpy()[gm])
    gamma, alea, epi = np.concatenate(gammas), np.concatenate(aleas), np.concatenate(epis)
    if pipeline is not None and pipeline.standard_scaler is not None:
        gamma = pipeline.inverse_transform(gamma)
        scale2 = pipeline.standard_scaler.stds.astype(np.float64) ** 2
        alea = alea * scale2
        epi = epi * scale2
    return {
        "predictions": gamma,
        "aleatoric_uncertainty": alea,
        "epistemic_uncertainty": epi,
        "total_uncertainty": alea + epi,
    }


def extract_partial_charges(
    model: GNN, loader, device: "str | torch.device"
) -> Tuple[np.ndarray, np.ndarray]:
    """Every real atom's partial charge, in loader order, and the dense
    index of its molecule (0.. over the loader's real molecules), as the
    CLI's ``--output_partial_charges`` writes them.  Raises when the model
    has no partial charges."""
    charges, mol_idx = [], []
    offset = 0
    with torch.inference_mode():
        for batch in loader:
            out = model(batch.to(device))
            if out.partial_charges is None:
                raise ValueError("Model was not built with use_partial_charges=True")
            am, gm = batch.atom_mask, batch.graph_mask
            charges.append(out.partial_charges.cpu().numpy()[am])
            mol_idx.append(_dense_mol_rank(gm, batch.atom_mol[am]) + offset)
            offset += int(gm.sum())
    return np.concatenate(charges), np.concatenate(mol_idx)


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
