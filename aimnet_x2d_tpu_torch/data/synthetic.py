"""Synthetic molecular batches for benchmarks, dry runs and checks on the
card (counterpart of aimnet_x2d_tpu/data/synthetic.py, numpy only).

Ring-topology "molecules" with QM9-like size statistics (about 18 atoms
with H, exact 1..K-hop edge lists) made without the featurizer, so the
device path can be driven from a seed alone.  The generator draws in the
JAX package's order, so one seed gives both packages equal arrays.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .batching import MolBatch, MolFeatures, collate


def make_synthetic_mol(
    rng: np.random.Generator,
    n_atoms: int,
    num_hops: int,
    with_stereo: bool = False,
) -> MolFeatures:
    """A ring molecule of ``n_atoms`` with exact k-hop edge lists (hop h
    links atom i to i +- h, when 2h < n_atoms).

    ``with_stereo`` adds stereo annotations (one tetrahedral 4-neighbour
    row, one cis and one trans directed pair each way, and a total charge
    in {-1, 0, 1}) to molecules of 6 atoms or more, so config 3 (partial
    charges and stereochemistry) can run on synthetic data."""
    hops: List[np.ndarray] = []
    for h in range(1, num_hops + 1):
        pairs = []
        if 2 * h < n_atoms:
            for i in range(n_atoms):
                pairs.append((i, (i + h) % n_atoms))
                pairs.append((i, (i - h) % n_atoms))
        hops.append(np.array(pairs, np.int32).T if pairs else np.zeros((2, 0), np.int32))
    tet = np.zeros((0, 4), np.int32)
    cis = np.zeros((0, 2), np.int32)
    trans = np.zeros((0, 2), np.int32)
    charge = 0.0
    if with_stereo and n_atoms >= 6:
        c = int(rng.integers(0, n_atoms))
        tet = (c + np.array([[1, 2, 3, 4]], np.int32)) % n_atoms
        a, b = int(rng.integers(0, n_atoms)), int(rng.integers(0, n_atoms))
        cis = np.array([[a, (a + 1) % n_atoms], [(a + 1) % n_atoms, a]], np.int32)
        trans = np.array([[b, (b + 2) % n_atoms], [(b + 2) % n_atoms, b]], np.int32)
        charge = float(rng.integers(-1, 2))
    return MolFeatures(
        edge_hops=hops,
        atom_type=rng.integers(0, 9, n_atoms).astype(np.int32),
        hydrogen_count=rng.integers(0, 4, n_atoms).astype(np.int32),
        degree=rng.integers(1, 5, n_atoms).astype(np.int32),
        hybridization=rng.integers(0, 4, n_atoms).astype(np.int32),
        tet_nbrs=tet,
        cis_pairs=cis,
        trans_pairs=trans,
        total_charge=charge,
        atomic_numbers=rng.integers(1, 9, n_atoms).astype(np.int32),
    )


def make_synthetic_batch(
    num_graphs: int = 64,
    mean_atoms: int = 18,
    num_hops: int = 3,
    num_tasks: int = 12,
    seed: int = 0,
    with_stereo: bool = False,
    **collate_kw,
) -> MolBatch:
    """``num_graphs`` synthetic molecules of ``mean_atoms - 6`` to
    ``mean_atoms + 6`` atoms (at least 4) and normal targets, all drawn
    from ``np.random.default_rng(seed)``, collated flat (``collate_kw``
    go to :func:`collate`; ``attach_flat_layouts`` adds kernel 7's
    layouts)."""
    rng = np.random.default_rng(seed)
    mols = [
        make_synthetic_mol(
            rng,
            int(rng.integers(max(4, mean_atoms - 6), mean_atoms + 7)),
            num_hops,
            with_stereo=with_stereo,
        )
        for _ in range(num_graphs)
    ]
    targets = rng.normal(size=(num_graphs, num_tasks)).astype(np.float32)
    return collate(mols, targets, num_hops=num_hops, **collate_kw)
