"""Target preprocessing for serving (counterpart of
aimnet_x2d_tpu/data/preprocessing.py).

A model artifact stores the fitted statistics of its preprocessing
pipeline; serving rebuilds the pipeline with
:meth:`PreprocessingPipeline.from_state_dict` and maps predictions back to
target units with :meth:`PreprocessingPipeline.inverse_transform`.  As in the
JAX package, the inverse undoes the standard scaling only: the SAE shift is
size-extensive and is not reversed.  Fitting SAE statistics belongs to
training and comes with it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class PreprocessingConfig:
    apply_sae: bool = False
    sae_subtasks: Optional[List[int]] = None
    apply_standard_scaling: bool = True
    task_type: str = "regression"
    sae_percentile_cutoff: float = 2.0


class SAENormalizer:
    """Per-element additive offsets, as restored from an artifact."""

    def __init__(self, task_type: str = "regression", percentile_cutoff: float = 2.0):
        self.task_type = task_type
        self.percentile_cutoff = percentile_cutoff
        self.sae_statistics: Optional[Dict] = None
        self.is_fitted = False


class StandardScaler:
    """Mean/std scaling: float32 mean, std with ddof=1, stds < 1e-12 -> 1."""

    def __init__(self, means: Optional[np.ndarray] = None, stds: Optional[np.ndarray] = None):
        self.means = None if means is None else np.asarray(means, np.float32)
        self.stds = None if stds is None else np.asarray(stds, np.float32)
        self.is_fitted = means is not None and stds is not None

    def fit(self, targets: np.ndarray) -> None:
        t = np.asarray(targets, np.float32)
        if t.ndim == 1:
            t = t.reshape(-1, 1)
        self.means = t.mean(axis=0)
        self.stds = t.std(axis=0, ddof=1)
        self.stds[self.stds < 1e-12] = 1.0
        self.is_fitted = True

    def inverse_transform(self, scaled: np.ndarray) -> np.ndarray:
        if not self.is_fitted:
            raise ValueError("inverse_transform() requires a fitted scaler — call fit() first")
        return np.asarray(scaled) * self.stds + self.means


class PreprocessingPipeline:
    """SAE -> scaling; serving only needs the inverse of the scaling."""

    def __init__(self, config: PreprocessingConfig):
        self.config = config
        self.sae_normalizer: Optional[SAENormalizer] = None
        self.standard_scaler: Optional[StandardScaler] = None
        self.is_fitted = False

    def inverse_transform(self, transformed: np.ndarray) -> np.ndarray:
        if self.standard_scaler is not None:
            return self.standard_scaler.inverse_transform(transformed)
        return transformed

    def state_dict(self) -> Dict:
        d: Dict = {"config": dataclasses.asdict(self.config)}
        if self.standard_scaler is not None and self.standard_scaler.is_fitted:
            d["scaler_means"] = self.standard_scaler.means.tolist()
            d["scaler_stds"] = self.standard_scaler.stds.tolist()
        if self.sae_normalizer is not None and self.sae_normalizer.is_fitted:
            stats = self.sae_normalizer.sae_statistics
            d["sae_statistics"] = {
                str(k): {str(z): v for z, v in sub.items()} for k, sub in stats.items()
            }
        return d

    @staticmethod
    def from_state_dict(d: Dict) -> "PreprocessingPipeline":
        cfg = PreprocessingConfig(**d["config"])
        pipe = PreprocessingPipeline(cfg)
        if "sae_statistics" in d:
            norm = SAENormalizer(cfg.task_type, cfg.sae_percentile_cutoff)
            stats = {}
            for k, sub in d["sae_statistics"].items():
                key = k if k == "regression" else int(k)
                stats[key] = {int(z): float(v) for z, v in sub.items()}
            norm.sae_statistics = stats
            norm.is_fitted = True
            pipe.sae_normalizer = norm
        if "scaler_means" in d:
            pipe.standard_scaler = StandardScaler(
                means=np.asarray(d["scaler_means"], np.float32),
                stds=np.asarray(d["scaler_stds"], np.float32),
            )
        pipe.is_fitted = True
        return pipe
