"""Host data path of the PyTorch port against the JAX package: the
featurizer, collate and bin_pack_batch give identical arrays on a fixed
SMILES list, and the port's binned loader keeps one batch shape; a
molecule larger than a bin sends the loader flat, as binning refuses it."""

import dataclasses

import numpy as np
import pytest

from aimnet_x2d_tpu.chem import compute_features as jax_features
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.data.binning import bin_pack_batch as jax_bin_pack
from aimnet_x2d_tpu_torch.chem import compute_features
from aimnet_x2d_tpu_torch.data.batching import MolBatch, collate
from aimnet_x2d_tpu_torch.data.binning import BinningError, bin_pack_batch
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset

SMILES = [
    "CCO", "c1ccccc1O", "CC(=O)N", "C1CCC(CC1)OC#N", "F/C=C/F", "F/C=C\\Cl",
    "C[C@H](N)C(=O)O", "C[C@@H](O)CC", "[NH4+]", "CC(=O)[O-]", "c1ccncc1",
    "O=C1CCCCC1", "C#CC#N", "OCC(O)CO", "[13CH4]", "ClC(Cl)(Cl)Cl", "not-a-smiles",
]


def _feats(fn):
    return [fn(s, 3) for s in SMILES]


def test_featurizer_matches_jax():
    for s, got, want in zip(SMILES, _feats(compute_features), _feats(jax_features)):
        assert (got is None) == (want is None), s
        if got is None:
            continue
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "edge_hops":
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y, err_msg=s)
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f"{s} {f.name}")
            else:
                assert a == b, (s, f.name)


@pytest.mark.parametrize("ab,mb", [(64, 16), (32, 8)])
def test_collate_and_bin_pack_match_jax(ab, mb):
    port = [f for f in _feats(compute_features) if f is not None]
    ref = [f for f in _feats(jax_features) if f is not None]
    targets = np.arange(2 * len(port), dtype=np.float32).reshape(-1, 2)
    pins, jpins = {}, {}
    got = bin_pack_batch(collate(port, targets, num_hops=3, graph_slots=20), ab=ab, mb=mb, pins=pins)
    want = jax_bin_pack(jax_collate(ref, targets, num_hops=3, graph_slots=20), ab=ab, mb=mb,
                        pins=jpins)
    assert pins == jpins
    for f in dataclasses.fields(MolBatch):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


def test_loader_shapes_and_order():
    ds = MoleculeDataset.from_smiles(SMILES * 3, np.arange(len(SMILES) * 3), max_hops=3)
    assert len(ds) == 3 * (len(SMILES) - 1)
    loader = BatchLoader(ds, batch_size=10, bin_ab=64, bin_mb=16)
    loader.warm_bin_pins()
    batches = list(loader)
    assert len(batches) == len(loader) == 5
    assert len({(b.bin_adj.shape, b.pool_mat.shape) for b in batches}) == 1
    order = np.concatenate([b.targets[b.graph_mask, 0] for b in batches])
    np.testing.assert_array_equal(order, ds.targets[:, 0])
    slots = {}
    loader.pin_slots(slots)
    assert slots["bins"] == batches[0].bin_adj.shape[0]


def test_loader_refuses_molecules_larger_than_a_bin():
    """A molecule over bin_ab atoms ("C" * 90: 272 with hydrogens) sends the
    loader to the flat layout, where binning would refuse it."""
    ds = MoleculeDataset.from_smiles(["CCO", "C" * 90], np.zeros(2), max_hops=3)
    loader = BatchLoader(ds, batch_size=2)
    assert loader.binned is False
    batch = next(iter(loader))
    assert batch.bin_adj is None and batch.fused_fwd is not None
    assert batch.fused_fwd.num_edges == int(batch.edge_mask.sum())
    raw = collate(ds.features, ds.targets, num_hops=3)
    with pytest.raises(BinningError, match="272 atoms"):
        bin_pack_batch(raw, ab=loader.bin_ab, mb=loader.bin_mb)


def test_size_sorted_bin_pack_refuses_stereo_rows_not_in_halves():
    """Cis/trans rows come as [originals | reversed] (quirk Q7); the
    size-sorted packer regroups each half, so an odd count of real rows
    raises instead of dropping the remainder row; the even count packs."""
    port = [f for f in _feats(compute_features) if f is not None]
    raw = collate(port, np.zeros((len(port), 1), np.float32), num_hops=3, graph_slots=20)
    n = int(raw.trans_mask.sum())
    assert n >= 2 and n % 2 == 0
    bin_pack_batch(raw, ab=64, mb=16, size_sort=True)
    mask = raw.trans_mask.copy()
    mask[n - 1] = False
    with pytest.raises(BinningError, match=f"{n - 1} real stereo rows do not split into 2"):
        bin_pack_batch(dataclasses.replace(raw, trans_mask=mask), ab=64, mb=16, size_sort=True)
