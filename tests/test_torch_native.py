"""The port's native host path against the JAX package, on the CPU:

- the native featurizer (``chem/native.py``, built by g++ from
  ``native/*.cpp`` into ``build/native/``) against JAX's pure-Python
  ``compute_features``: every array equal in the same order, the processed
  SMILES equal, on JAX's 16 hand-picked SMILES and a seeded mix of chain
  molecules with stereo centres and double bonds and 260-600-atom ones;
  invalid SMILES give None; the result does not depend on the threads;
- the columnar cache: ``LazyFeatures`` over ``ColumnarCache.from_smiles``
  equal to the features, and to ``ColumnarCache.from_features``;
- the native binned builder (``data/native_batch.py``) array-exact, field
  by field, against the port's Python collate + ``bin_pack_batch`` and
  against JAX's Python loader (``binned=True``), over several sizes and
  seeds, with ``size_sort`` on and off and with pins; batches own their
  arrays;
- a failed build raises with the compiler's message, and
  ``AIMNET_NO_NATIVE=1`` selects the pure-Python featurizer and collate.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.chem import compute_features as jax_compute_features
from aimnet_x2d_tpu.data.dataset import BatchLoader as JaxLoader
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu_torch.chem import native
from aimnet_x2d_tpu_torch.data import dataset as dataset_mod
from aimnet_x2d_tpu_torch.data.batching import collate
from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.data.native_batch import (
    ColumnarCache,
    LazyFeatures,
    build_binned_batch,
)

torch.set_num_threads(1)

HAND_PICKED = [
    "C", "CCO", "c1ccccc1", "c1ccncc1", "c1cc[nH]c1", "CC(=O)[O-]",
    "[NH4+]", "F/C=C/F", "F/C=C\\F", "N[C@@H](C)C(=O)O", "C(F)(Cl)Br",
    "C#N", "O=C=O", "C1CC1", "c1ccc2ccccc2c1", "CC(C)(C)C",
]
INVALID = ["bad((smiles", "C1CC", "[Xx]"]
FEATURES = ("atom_type", "hydrogen_count", "degree", "hybridization", "atomic_numbers",
            "tet_nbrs", "cis_pairs", "trans_pairs")


def mixed_smiles(n: int, seed: int, large_every: int = 0) -> list:
    """Seeded chain molecules, about half with a tetrahedral centre or a
    cis/trans double bond; with ``large_every``, every such one from index 3
    on is a 260-600-atom alkane, PEG or glycine chain."""
    rng = np.random.default_rng(seed)
    heads = ["C", "O", "N", "F", "Cl", "N#C", "FC(F)(F)", "OC(=O)", "CC", "C=C"]
    units = ["C", "CC", "O", "N", "C(C)", "C(=O)", "C=C", "C#C", "C(O)", "c1ccc(cc1)",
             "C1CCC(CC1)", "C1CC1", "S"]
    chiral = ["[C@H](C)", "[C@@H](C)", "[C@H](O)", "[C@@H](N)", "[C@H](F)"]
    out = []
    for i in range(n):
        if large_every and i >= 3 and (i - 3) % large_every == 0:
            k = int(rng.integers(37, 86))
            out.append(["C" * int(rng.integers(87, 200)), "O" + "CCO" * k,
                        "NCC(=O)" * k + "O"][int(rng.integers(3))])
            continue
        parts = [heads[rng.integers(len(heads))]]
        parts += [units[rng.integers(len(units))] for _ in range(int(rng.integers(1, 5)))]
        parts.append(heads[rng.integers(len(heads))])
        if rng.random() < 0.5:
            kind = int(rng.integers(3))
            if kind != 1:
                parts.insert(int(rng.integers(1, len(parts))), chiral[rng.integers(len(chiral))])
            if kind != 0:
                parts.insert(int(rng.integers(1, len(parts))), ["/C=C/", "/C=C\\"][kind % 2])
        out.append("".join(parts))
    return out


def assert_features_equal(got, ref, what):
    assert (got is None) == (ref is None), what
    if ref is None:
        return
    assert got.smiles == ref.smiles, what
    assert got.total_charge == ref.total_charge, what
    for key in FEATURES:
        assert np.array_equal(getattr(got, key), getattr(ref, key)), (what, key)
        assert getattr(got, key).shape == getattr(ref, key).shape, (what, key)
    assert len(got.edge_hops) == len(ref.edge_hops), what
    for h, (a, b) in enumerate(zip(got.edge_hops, ref.edge_hops)):
        assert a.shape == b.shape and np.array_equal(a, b), (what, h)


def assert_batches_equal(got, ref, what):
    for f in dataclasses.fields(ref):
        if not hasattr(got, f.name):
            continue
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if b is None or isinstance(b, bool):
            assert a == b, (what, f.name)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b), (what, f.name)


@pytest.fixture(scope="module")
def smiles():
    return HAND_PICKED + mixed_smiles(120, 7, large_every=40)


@pytest.fixture(scope="module")
def jax_features(smiles):
    return [jax_compute_features(s, 3) for s in smiles]


def test_single_molecule_matches_jax_python(smiles, jax_features):
    for s, ref in zip(smiles, jax_features):
        assert_features_equal(native.compute_features_native(s, 3), ref, s)
    for s in INVALID:
        assert jax_compute_features(s, 3) is None and native.compute_features_native(s, 3) is None


def test_batch_matches_jax_python_and_threads(smiles, jax_features):
    mixed = smiles + INVALID
    refs = jax_features + [None] * len(INVALID)
    assert max(r.num_atoms for r in jax_features) > 260
    one = native.compute_features_batch(mixed, 3, num_threads=1)
    three = native.compute_features_batch(mixed, 3, num_threads=3)
    for s, a, b, ref in zip(mixed, one, three, refs):
        assert_features_equal(a, ref, s)
        assert_features_equal(b, ref, s)
    assert native.compute_features_batch([], 3) == []


@pytest.mark.parametrize("hops", [1, 3])
def test_columnar_cache_and_lazy_features(smiles, hops):
    mixed = smiles + INVALID
    cache, keep = ColumnarCache.from_smiles(mixed, hops, num_threads=2)
    assert keep.tolist() == [True] * len(smiles) + [False] * len(INVALID)
    lazy = LazyFeatures(cache, hops)
    feats = [f for f in native.compute_features_batch(mixed, hops) if f is not None]
    assert len(lazy) == len(feats)
    for i, (a, b) in enumerate(zip(lazy, feats)):
        assert_features_equal(a, b, i)
    other = ColumnarCache.from_features(feats, hops)
    for f in dataclasses.fields(ColumnarCache):
        a, b = getattr(cache, f.name), getattr(other, f.name)
        assert (a == b) if isinstance(a, list) else np.array_equal(a, b), f.name
    head = lazy[:10]
    assert isinstance(head, LazyFeatures) and len(head) == 10
    assert_features_equal(head[9], feats[9], "head")
    assert_features_equal(lazy[-1], feats[-1], "last")
    assert [f.smiles for f in lazy[3:9:2]] == [f.smiles for f in feats[3:9:2]]


def test_dataset_from_smiles_is_columnar(smiles):
    targets = np.arange(len(smiles) + 1, dtype=np.float32)
    ds = MoleculeDataset.from_smiles(smiles[:5] + ["bad((smiles"] + smiles[5:], targets, 3,
                                     num_workers=2)
    assert isinstance(ds.features, LazyFeatures) and ds.columnar is ds.features.cache
    assert ds.smiles == [f.smiles for f in ds.features]
    assert ds.targets[:, 0].tolist() == [t for i, t in enumerate(targets.tolist()) if i != 5]
    ref = [jax_compute_features(s, 3) for s in smiles]
    for a, b in zip(ds.atomic_numbers(), ref):
        assert np.array_equal(a, b.atomic_numbers)
    sizes = ds.sizes()
    assert sizes["atoms"].tolist() == [r.num_atoms for r in ref]
    assert sizes["edges"].tolist() == [r.num_edges for r in ref]
    sub = MoleculeDataset(ds.smiles[:8], ds.targets[:8], ds.features[:8], ds.max_hops)
    assert sub.columnar is not None and len(sub.columnar) == 8


def test_featurize_many_native_and_python_agree(monkeypatch):
    smi = HAND_PICKED[:8] + INVALID + HAND_PICKED[8:]
    targets = np.arange(len(smi), dtype=np.float32)
    got = dataset_mod.featurize_many(smi, targets, 3, num_workers=2)
    monkeypatch.setenv("AIMNET_NO_NATIVE", "1")
    ref = dataset_mod.featurize_many(smi, targets, 3)
    assert got[0] == ref[0] and np.array_equal(got[1], ref[1]) and got[1].shape == (16, 1)
    for a, b in zip(got[2], ref[2]):
        assert_features_equal(a, b, b.smiles)


def _python_batch(feats, targets, idx, loader):
    b = collate([feats[i] for i in idx], targets[idx], num_hops=3, graph_slots=loader.batch_size,
                atom_slots=loader.atom_slots, edge_slots=loader.edge_slots,
                tet_slots=loader.tet_slots, pair_slots=loader.pair_slots)
    return b


@pytest.mark.parametrize("n,seed,batch", [(37, 0, 16), (150, 1, 64), (300, 2, 300)])
@pytest.mark.parametrize("size_sort", [False, True])
def test_binned_batch_matches_python_and_jax(n, seed, batch, size_sort, monkeypatch):
    smi = mixed_smiles(n, seed)
    targets = np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)
    ds = MoleculeDataset.from_smiles(smi, targets, 3)
    loader = BatchLoader(ds, batch, shuffle=size_sort, seed=seed)
    loader.warm_bin_pins()
    got = list(loader)
    monkeypatch.setenv("AIMNET_NO_NATIVE", "1")
    py_ds = MoleculeDataset.from_smiles(smi, targets, 3)
    assert isinstance(py_ds.features, list) and py_ds.columnar is None
    py_loader = BatchLoader(py_ds, batch, shuffle=size_sort, seed=seed)
    py_loader.warm_bin_pins()
    ref = list(py_loader)
    jax_ds = JaxDataset.from_smiles(smi, targets, 3)
    jax_loader = JaxLoader(jax_ds, batch, shuffle=size_sort, seed=seed, binned=True,
                           fixed_shape=True, size_sort=size_sort)
    jax_loader.warm_bin_pins()
    assert len(got) == len(ref) == len(jax_loader)
    for i, (a, b, c) in enumerate(zip(got, ref, jax_loader)):
        assert_batches_equal(a, b, ("port python", i))
        assert_batches_equal(a, c, ("jax python", i))
        for f in ("atom_type", "atom_mol", "edge_src", "edge_dst", "edge_hop", "tet_nbrs"):
            assert getattr(a, f).dtype == getattr(b, f).dtype, f
    # every batch owns its arrays: none shares memory with another
    for f in ("atom_type", "edge_src", "bin_adj", "pool_mat"):
        for a, b in zip(got, got[1:]):
            assert not np.shares_memory(getattr(a, f), getattr(b, f))


def test_binned_batch_with_pins():
    smi = mixed_smiles(90, 4)
    targets = np.zeros((90, 1), np.float32)
    ds = MoleculeDataset.from_smiles(smi, targets, 3)
    loader = BatchLoader(ds, 90)
    idx = np.arange(10, 70)
    for pins in ({}, {"bins": 16, "mb": 24, "tetb": 16}):
        p_native, p_python = dict(pins), dict(pins)
        got = build_binned_batch(ds.columnar, idx, targets[idx], ab=256, mb_cap=48,
                                 edge_slots=loader.edge_slots, tet_slots=loader.tet_slots,
                                 pair_slots=loader.pair_slots, pins=p_native)
        ref = bin_pack_batch(_python_batch(ds.features, targets, idx, loader), ab=256, mb=48,
                             pins=p_python)
        assert p_native == p_python
        assert_batches_equal(got, ref, pins)
        if pins:
            assert got.bin_adj.shape[0] == 16 and got.pool_mat.shape[1] == 24


def test_scratch_buffers_are_reused_only_when_asked():
    smi = mixed_smiles(40, 5)
    ds = MoleculeDataset.from_smiles(smi, np.zeros((40, 1), np.float32), 3)
    loader = BatchLoader(ds, 40)
    kw = dict(ab=256, mb_cap=48, edge_slots=loader.edge_slots, tet_slots=loader.tet_slots,
              pair_slots=loader.pair_slots, pins={"bins": 8, "mb": 16})
    scratch: dict = {}
    a = build_binned_batch(ds.columnar, np.arange(20), np.zeros(20), scratch=scratch, **kw)
    a_adj = a.bin_adj.copy()
    b = build_binned_batch(ds.columnar, np.arange(20, 40), np.zeros(20), scratch=scratch, **kw)
    assert np.shares_memory(a.bin_adj, b.bin_adj)  # the documented aliasing
    fresh = build_binned_batch(ds.columnar, np.arange(20), np.zeros(20), **kw)
    assert np.array_equal(fresh.bin_adj, a_adj) and not np.shares_memory(fresh.bin_adj, b.bin_adj)
    assert_batches_equal(build_binned_batch(ds.columnar, np.arange(20, 40), np.zeros(20), **kw),
                         b, "scratch")


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "missing")
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "bad_flag")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-fno-such-option-at-all"])
    with pytest.raises(RuntimeError, match="no-such-option"):
        native.build()
    assert not list((tmp_path / "bad_flag").glob("*.so"))


def test_no_native_selects_python(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the native path ran")

    monkeypatch.setenv("AIMNET_NO_NATIVE", "1")
    monkeypatch.setattr(native, "featurize_columns", refuse)
    monkeypatch.setattr(native, "compute_features_batch", refuse)
    monkeypatch.setattr(dataset_mod, "build_binned_batch", refuse)
    assert native.describe(4).startswith("pure-Python")
    ds = MoleculeDataset.from_smiles(HAND_PICKED, np.zeros(len(HAND_PICKED)), 3)
    assert isinstance(ds.features, list) and ds.columnar is None
    batches = list(BatchLoader(ds, 8))
    assert batches[0].bin_adj is not None
    monkeypatch.delenv("AIMNET_NO_NATIVE")
    assert native.describe(4) == "native C++ (4 threads)"
    with pytest.raises(AssertionError, match="native path ran"):
        MoleculeDataset.from_smiles(HAND_PICKED, np.zeros(len(HAND_PICKED)), 3)
