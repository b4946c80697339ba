"""Target preprocessing: SAE normalization + standard scaling (counterpart
of aimnet_x2d_tpu/data/preprocessing.py; numpy only).

Training fits the pipeline on the train split and transforms every split;
the fitted statistics go into the model artifact, and serving rebuilds the
pipeline with :meth:`PreprocessingPipeline.from_state_dict` to map
predictions back to target units.

- SAE: N x 119 atom-count design matrix, 2-98 percentile outlier filter on
  the targets, ``np.linalg.lstsq(rcond=None)``, NaN coefficients dropped.
- StandardScaler: float32 mean, std with ddof=1, stds < 1e-12 -> 1.0.
- Order: SAE first, then scaling; the inverse undoes the scaling only (the
  SAE shift is size-extensive).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

MAX_ATOMIC_NUM = 119


@dataclasses.dataclass
class PreprocessingConfig:
    apply_sae: bool = False
    sae_subtasks: Optional[List[int]] = None
    apply_standard_scaling: bool = True
    task_type: str = "regression"
    sae_percentile_cutoff: float = 2.0


def compute_sae_dict(
    atomic_numbers_list: Sequence[np.ndarray],
    target_values: Sequence[float],
    percentile_cutoff: float = 2.0,
) -> Dict[int, float]:
    """Least-squares per-element additive offsets."""
    b = np.asarray(target_values, np.float64)
    N = len(atomic_numbers_list)
    A = np.zeros((N, MAX_ATOMIC_NUM), np.float64)
    for i, nums in enumerate(atomic_numbers_list):
        unique, counts = np.unique(nums, return_counts=True)
        sel = (unique >= 1) & (unique < MAX_ATOMIC_NUM)
        A[i, unique[sel]] = counts[sel]

    lo, hi = np.percentile(b, [percentile_cutoff, 100.0 - percentile_cutoff])
    mask = (b >= lo) & (b <= hi)
    sae_values, *_ = np.linalg.lstsq(A[mask], b[mask], rcond=None)

    return {
        z: float(v)
        for z, v in enumerate(sae_values)
        if not np.isnan(v)
    }


def _sae_shifts(atomic_numbers_list: Sequence[np.ndarray], sae_dict: Dict[int, float]) -> np.ndarray:
    table = np.zeros(MAX_ATOMIC_NUM, np.float64)
    for z, v in sae_dict.items():
        z = int(z)
        if 0 <= z < MAX_ATOMIC_NUM:
            table[z] = v
    return np.array(
        [table[np.clip(nums, 0, MAX_ATOMIC_NUM - 1)].sum() if nums is not None else 0.0
         for nums in atomic_numbers_list]
    )


class SAENormalizer:
    """Size-extensive additive normalization, fit on train only."""

    def __init__(self, task_type: str = "regression", percentile_cutoff: float = 2.0):
        self.task_type = task_type
        self.percentile_cutoff = percentile_cutoff
        self.sae_statistics: Optional[Dict] = None
        self.is_fitted = False

    def fit(
        self,
        atomic_numbers_list: Sequence[Optional[np.ndarray]],
        targets: np.ndarray,
        subtasks: Optional[List[int]] = None,
    ) -> Dict:
        targets = np.asarray(targets, np.float64)
        valid = [i for i, n in enumerate(atomic_numbers_list) if n is not None]
        if not valid:
            raise ValueError("SAE fit needs at least one parsed molecule")
        nums = [atomic_numbers_list[i] for i in valid]

        if self.task_type == "regression":
            t = targets[valid].reshape(len(valid), -1)[:, 0]
            self.sae_statistics = {
                "regression": compute_sae_dict(nums, t, self.percentile_cutoff)
            }
        elif self.task_type == "multitask":
            if subtasks is None:
                raise ValueError("multitask SAE requires sae_subtasks (which target columns to shift)")
            stats: Dict[int, Dict[int, float]] = {}
            for st in subtasks:
                if st >= targets.shape[1]:
                    raise ValueError(
                        f"Subtask index {st} >= number of targets {targets.shape[1]}"
                    )
                stats[st] = compute_sae_dict(
                    nums, targets[valid, st], self.percentile_cutoff
                )
            self.sae_statistics = stats
        else:
            raise ValueError(f"Unknown task_type: {self.task_type}")

        self.is_fitted = True
        return self.sae_statistics

    def transform(
        self,
        atomic_numbers_list: Sequence[Optional[np.ndarray]],
        targets: np.ndarray,
    ) -> np.ndarray:
        if not self.is_fitted:
            raise ValueError("transform() requires a fitted normalizer — call fit() first")
        targets = np.array(targets, np.float64, copy=True)
        if self.task_type == "regression":
            shifts = _sae_shifts(atomic_numbers_list, self.sae_statistics["regression"])
            if targets.ndim == 1:
                targets -= shifts
            else:
                targets[:, 0] -= shifts
        else:
            for st, sae_dict in self.sae_statistics.items():
                st = int(st)
                if st >= targets.shape[1]:
                    continue
                targets[:, st] -= _sae_shifts(atomic_numbers_list, sae_dict)
        return targets

    def fit_transform(self, atomic_numbers_list, targets, subtasks=None) -> np.ndarray:
        self.fit(atomic_numbers_list, targets, subtasks)
        return self.transform(atomic_numbers_list, targets)


class StandardScaler:
    """Train-only mean/std scaling."""

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

    def transform(self, targets: np.ndarray) -> np.ndarray:
        if not self.is_fitted:
            raise ValueError("transform() requires a fitted normalizer — call fit() first")
        t = np.asarray(targets, np.float32)
        if t.ndim == 1:
            t = t.reshape(-1, 1)
        return (t - self.means) / self.stds

    def inverse_transform(self, scaled: np.ndarray) -> np.ndarray:
        if not self.is_fitted:
            raise ValueError("inverse_transform() requires a fitted scaler — call fit() first")
        return np.asarray(scaled) * self.stds + self.means

    def fit_transform(self, targets: np.ndarray) -> np.ndarray:
        self.fit(targets)
        return self.transform(targets)


class PreprocessingPipeline:
    """SAE -> scaling, fit on train only."""

    def __init__(self, config: PreprocessingConfig):
        self.config = config
        self.sae_normalizer: Optional[SAENormalizer] = None
        self.standard_scaler: Optional[StandardScaler] = None
        self.is_fitted = False

    def fit(self, atomic_numbers_list, targets) -> None:
        current = np.asarray(targets, np.float64)
        if self.config.apply_sae:
            self.sae_normalizer = SAENormalizer(
                task_type=self.config.task_type,
                percentile_cutoff=self.config.sae_percentile_cutoff,
            )
            current = self.sae_normalizer.fit_transform(
                atomic_numbers_list, current, self.config.sae_subtasks
            )
        if self.config.apply_standard_scaling:
            self.standard_scaler = StandardScaler()
            self.standard_scaler.fit(current)
        self.is_fitted = True

    def transform(self, atomic_numbers_list, targets) -> np.ndarray:
        if not self.is_fitted:
            raise ValueError("transform() requires a fitted normalizer — call fit() first")
        current = np.asarray(targets, np.float64)
        if self.sae_normalizer is not None:
            current = self.sae_normalizer.transform(atomic_numbers_list, current)
        if self.standard_scaler is not None:
            return self.standard_scaler.transform(current)
        out = np.asarray(current, np.float32)
        return out.reshape(-1, 1) if out.ndim == 1 else out

    def inverse_transform(self, transformed: np.ndarray) -> np.ndarray:
        """Undo standard scaling only: the SAE shift is size-extensive and
        not reversible without per-molecule compositions."""
        if self.standard_scaler is not None:
            return self.standard_scaler.inverse_transform(transformed)
        return transformed

    def fit_transform(self, atomic_numbers_list, targets) -> np.ndarray:
        self.fit(atomic_numbers_list, targets)
        return self.transform(atomic_numbers_list, targets)

    # -- serialization (for the self-describing artifact) --------------- #

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
