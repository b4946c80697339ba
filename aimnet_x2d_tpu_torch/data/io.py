"""CSV loading and the seeded train/val/test split (counterpart of
aimnet_x2d_tpu/data/io.py).

``split_dataset`` gives the same two-stage split as the JAX package, which
calls scikit-learn's ``train_test_split(..., random_state=seed)`` twice.
The port keeps no scikit-learn dependency: :func:`_train_test_split`
computes the same indices (a ``RandomState(seed)`` permutation, the first
``ceil(test_size * n)`` entries as the test part, the next ones as train).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd


def load_dataset(
    path: str,
    smiles_column: str = "smiles",
    target_column: str = "target",
    multi_target_columns: Optional[Sequence[str]] = None,
) -> Tuple[List[str], np.ndarray]:
    """Read (smiles, targets) from a CSV; targets are (N, T) float32."""
    df = pd.read_csv(path)
    smiles = df[smiles_column].astype(str).tolist()
    cols = list(multi_target_columns) if multi_target_columns is not None else [target_column]
    return smiles, df[cols].to_numpy(dtype=np.float32)


def _train_test_split(idx: np.ndarray, test_size: float, seed: int):
    """scikit-learn's ``train_test_split(idx, test_size=f, random_state=seed)``
    for a float ``test_size`` and shuffling on."""
    n = len(idx)
    n_test = math.ceil(test_size * n)
    n_train = math.floor((1.0 - test_size) * n)
    if n_train + n_test > n:
        n_train = n - n_test
    perm = np.random.RandomState(seed).permutation(n)
    return idx[perm[n_test : n_test + n_train]], idx[perm[:n_test]]


def split_dataset(
    smiles: Sequence[str],
    targets: np.ndarray,
    train_split: float = 0.8,
    val_split: float = 0.1,
    test_split: float = 0.1,
    seed: int = 42,
):
    """Two-stage shuffled split with a fixed seed: test first, then val out
    of the rest.  Returns ((smiles, targets) x train, val, test)."""
    idx = np.arange(len(smiles))
    idx_trainval, idx_test = _train_test_split(idx, test_split, seed)
    val_frac = val_split / (train_split + val_split)
    idx_train, idx_val = _train_test_split(idx_trainval, val_frac, seed)

    def take(ix):
        return [smiles[i] for i in ix], targets[ix]

    return take(idx_train), take(idx_val), take(idx_test)
