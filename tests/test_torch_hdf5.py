"""The port's columnar HDF5 module (aimnet_x2d_tpu_torch/data/hdf5.py)
against the JAX package's, on the CPU:

- the files are interchangeable: the port's ``write_hdf5`` and
  ``write_hdf5_streaming`` write, for the same SMILES and targets, the JAX
  writers' datasets (values, dtypes, chunking, compression) and metadata;
  each package's reader reads the other's file to equal features, SMILES
  as ``str``;
- the streaming fit equals JAX's for each task type and SAE subtasks, and
  the in-place transform writes JAX's targets;
- the loader: JAX's molecule order for a seed and epoch (two-level shuffle,
  host chunks), and batches array-equal to the port's in-memory
  ``BatchLoader`` over the same molecules on each layout (native binned,
  flat with a molecule past a bin, halo shards of a rank, a host's chunk,
  the short final step), with the scratch rotation forced on.
"""

import dataclasses

import h5py
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.data import hdf5 as jh
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.data.preprocessing import PreprocessingConfig as JaxPrepConfig
from aimnet_x2d_tpu_torch.data import hdf5 as ph
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.data.native_batch import SCRATCH_SETS
from aimnet_x2d_tpu_torch.data.preprocessing import PreprocessingConfig

torch.set_num_threads(1)

SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C[C@H](N)C(=O)O", "F/C=C/F", "F/C=C\\Cl",
          "CC(C)C", "C#N", "O[C@H]1CC[C@@H](N)CC1", "OCC(O)CO", "c1ccncc1", "NC(=O)N", "ClCCl",
          "C1CCCCC1", "CCCCCC"] * 3 + ["not a smiles"]
BIG = "C" * 30  # 92 atoms with hydrogens: past a 64-atom bin
FEATURES = ("atom_type", "hydrogen_count", "degree", "hybridization", "tet_nbrs", "cis_pairs",
            "trans_pairs", "atomic_numbers")


def _targets(n, t=3):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, t)) * [1.0, 10.0, 0.1] + [0.0, -30.0, 5.0]).astype(np.float32)


def _dump(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[...], obj.dtype, obj.chunks, obj.compression,
                             obj.compression_opts, obj.maxshape)
        f.visititems(visit)
        out["metadata"] = {k: str(v) for k, v in f["metadata"].attrs.items()}
    return out


def _assert_files_equal(a, b):
    da, db = _dump(a), _dump(b)
    assert da.keys() == db.keys()
    assert da.pop("metadata") == db.pop("metadata")
    for k, (x, *meta) in da.items():
        y, *meta_b = db[k]
        assert meta == meta_b, k
        assert x.shape == y.shape and np.array_equal(x, y), k


def _assert_features_equal(a, b):
    for key in FEATURES:
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), key
    assert len(a.edge_hops) == len(b.edge_hops)
    for x, y in zip(a.edge_hops, b.edge_hops):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert a.total_charge == b.total_charge
    assert a.smiles == b.smiles and type(a.smiles) is str and type(b.smiles) is str


@pytest.mark.parametrize("writer", ["write_hdf5", "write_hdf5_streaming"])
def test_files_are_interchangeable_with_jax(tmp_path, writer):
    t = _targets(len(SMILES))
    mine, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    state = {"note": "kept as written"}
    if writer == "write_hdf5":
        kept = len(MoleculeDataset.from_smiles(SMILES, t, 3))
        ph.write_hdf5(mine, MoleculeDataset.from_smiles(SMILES, t, 3),
                      target_columns=["a", "b", "c"], preprocessing_state=state)
        jh.write_hdf5(theirs, JaxDataset.from_smiles(SMILES, t, 3),
                      target_columns=["a", "b", "c"], preprocessing_state=state)
    else:
        kept = ph.write_hdf5_streaming(mine, SMILES, t, 3, chunk_size=7,
                                       target_columns=["a", "b", "c"], preprocessing_state=state)
        assert kept == jh.write_hdf5_streaming(theirs, SMILES, t, 3, chunk_size=7,
                                               target_columns=["a", "b", "c"],
                                               preprocessing_state=state)
    assert kept == len(SMILES) - 1
    _assert_files_equal(mine, theirs)
    for path in (mine, theirs):
        p, j = ph.HDF5MoleculeDataset(path), jh.HDF5MoleculeDataset(path)
        assert (p.num_molecules, p.max_hops, p.num_tasks, p.max_atoms_per_mol,
                p.max_edges_per_mol, p.max_tet_per_mol, p.max_pairs_per_mol, p.target_columns,
                p.preprocessing_state) == (
            j.num_molecules, j.max_hops, j.num_tasks, j.max_atoms_per_mol, j.max_edges_per_mol,
            j.max_tet_per_mol, j.max_pairs_per_mol, j.target_columns, j.preprocessing_state)
        pf, pt = p.read_block(3, 20)
        jf, jt = j.read_block(3, 20)
        np.testing.assert_array_equal(pt, jt)
        for a, b in zip(pf, jf):
            _assert_features_equal(a, b)
        _assert_features_equal(p.get_features(4), j.get_features(4))
        for k, v in p.per_mol_counts().items():
            np.testing.assert_array_equal(v, j.per_mol_counts()[k])
        assert p.load_all().smiles == j.load_all().smiles
        p.close()
        j.close()


def test_smiles_roundtrip_as_str(tmp_path):
    """Twin of the JAX package's ``test_hdf5_smiles_roundtrip_str``."""
    ds = MoleculeDataset.from_smiles(["CCO", "c1ccccc1", "CC(=O)O"], np.zeros((3, 1)), 2)
    ds.smiles[:] = ["CCO", "c1ccccc1", "CC(=O)O"]
    path = str(tmp_path / "s.h5")
    ph.write_hdf5(path, ds)
    h5 = ph.HDF5MoleculeDataset(path)
    assert h5.load_all().smiles == ["CCO", "c1ccccc1", "CC(=O)O"]
    assert h5.get_features(0).smiles == "CCO"
    h5.close()


@pytest.mark.parametrize("task_type,subtasks,sae", [("regression", None, True),
                                                     ("multitask", [1, 2], True),
                                                     ("multitask", None, False)])
def test_streaming_fit_and_transform_match_jax(tmp_path, task_type, subtasks, sae):
    t = _targets(len(SMILES))
    if task_type == "regression":
        t = t[:, :1]
    path, jpath = str(tmp_path / "p.h5"), str(tmp_path / "j.h5")
    ph.write_hdf5_streaming(path, SMILES, t, 3, chunk_size=11)
    jh.write_hdf5_streaming(jpath, SMILES, t, 3, chunk_size=11)
    kw = dict(apply_sae=sae, sae_subtasks=subtasks, apply_standard_scaling=True,
              task_type=task_type)
    pipe = ph.fit_pipeline_streaming(path, PreprocessingConfig(**kw), chunk_size=13)
    ref = jh.fit_pipeline_streaming(jpath, JaxPrepConfig(**kw), chunk_size=13)
    assert pipe.state_dict() == ref.state_dict()
    ph.transform_targets_streaming(path, pipe, chunk_size=17)
    jh.transform_targets_streaming(jpath, ref, chunk_size=17)
    _assert_files_equal(path, jpath)


# ---- the loader ------------------------------------------------------------ #


def _field_equal(a, b, what):
    if dataclasses.is_dataclass(b):
        for f in dataclasses.fields(b):
            _field_equal(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif b is None or isinstance(b, (bool, int, float)):
        assert a == b, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _field_equal(g, w, f"batch {i}")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Molecule i has target (i, ...): the order of a batch's molecules is
    read off its targets.  One file fits a 64-atom bin, one holds BIG; both
    hold whole steps of 4 and of 8 molecules, so no block ends in a short
    step (the in-memory loader has short steps only at the end)."""
    d = tmp_path_factory.mktemp("h5")
    out = {}
    for name, smiles in (("small", SMILES[:-1] + SMILES[:16]), ("big", SMILES[:23] + [BIG])):
        t = np.stack([np.arange(len(smiles)), np.ones(len(smiles))], 1).astype(np.float32)
        path = str(d / f"{name}.h5")
        ph.write_hdf5_streaming(path, smiles, t, 3, chunk_size=16)
        out[name] = path
    return out


@pytest.mark.parametrize("hosts", [1, 3])
def test_loader_gives_jax_molecule_order(files, hosts):
    h5 = ph.HDF5MoleculeDataset(files["small"])
    jds = jh.HDF5MoleculeDataset(files["small"])
    for host in range(hosts):
        kw = dict(shuffle=True, seed=5, block_batches=1, host_id=host, num_hosts=hosts)
        mine = ph.HDF5BatchLoader(h5, 4, **kw)
        theirs = jh.HDF5BatchLoader(jds, 4, binned=False, fused_edges=False, **kw)
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            order = np.concatenate(mine._batch_indices())
            want = np.array([t[0] for _, t in theirs._mol_stream()], np.int64)
            np.testing.assert_array_equal(order, want)
        assert len(mine) == len(theirs)
    h5.close()
    jds.close()


def _in_memory(path, order=None):
    ds = ph.HDF5MoleculeDataset(path).load_all()
    if order is None:
        return ds
    return MoleculeDataset(smiles=[ds.smiles[i] for i in order], targets=ds.targets[order],
                           features=[ds.features[i] for i in order], max_hops=ds.max_hops)


LAYOUTS = {
    "binned": ("small", dict(), dict()),
    "flat": ("big", dict(), dict()),
    "halo-rank": ("big", dict(stack_devices=2, halo_shards=2, rank=(1, 0)), dict()),
    "stacked": ("small", dict(stack_devices=2), dict()),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loader_batches_equal_the_in_memory_loader(files, layout):
    name, kw, _ = LAYOUTS[layout]
    h5 = ph.HDF5MoleculeDataset(files[name])
    loader = ph.HDF5BatchLoader(h5, 4, bin_ab=64, bin_mb=16, block_batches=1, **kw)
    assert loader.binned == (name == "small" or "halo_shards" in kw)
    ref = BatchLoader(_in_memory(files[name]), 4, bin_ab=64, bin_mb=16, **kw)
    _assert_batches_equal(list(loader), list(ref))
    # a shuffled epoch: the in-memory loader over the same molecules in the
    # same order, packed size-descending as a training loader packs
    loader = ph.HDF5BatchLoader(h5, 4, shuffle=True, seed=3, bin_ab=64, bin_mb=16,
                                block_batches=1, **kw)
    loader.set_epoch(2)
    order = np.concatenate(loader._batch_indices())
    assert sorted(order) == list(range(len(h5)))
    ref = BatchLoader(_in_memory(files[name], order), 4, bin_ab=64, bin_mb=16, **kw)
    ref.size_sort = True
    _assert_batches_equal(list(loader), list(ref))
    h5.close()


def test_loader_host_chunk_and_short_final_step(files, tmp_path):
    """Each of 3 hosts streams its contiguous chunk (22, 22, 20 molecules)
    in steps of 5, the chunk's last step short."""
    h5 = ph.HDF5MoleculeDataset(files["small"])
    n = len(h5)
    per = -(-n // 3)
    total = 0
    for host in range(3):
        loader = ph.HDF5BatchLoader(h5, 5, host_id=host, num_hosts=3, block_batches=2,
                                    bin_ab=64, bin_mb=16)
        lo, hi = host * per, min((host + 1) * per, n)
        ref = BatchLoader(_in_memory(files["small"], np.arange(lo, hi)), 5, bin_ab=64,
                          bin_mb=16)
        # every host's slots are the file's (one shape over the hosts)
        ref.pin_slots({k: getattr(loader, k)
                       for k in ("atom_slots", "edge_slots", "tet_slots", "pair_slots")})
        got = list(loader)
        _assert_batches_equal(got, list(ref))
        total += sum(int(b.graph_mask.sum()) for b in got)
        assert int(got[-1].graph_mask.sum()) == ((hi - lo) % 5 or 5)
    assert total == n
    dropped = ph.HDF5BatchLoader(h5, 5, drop_last=True, block_batches=100)
    assert [int(b.graph_mask.sum()) for b in dropped] == [5] * (n // 5) == [5] * len(dropped)
    # the JAX twin (tests/test_review_fixes.py): 5 molecules over 2 data
    # shards of 2, the last step's second shard empty
    five = str(tmp_path / "five.h5")
    ph.write_hdf5(five, h5.block_dataset(0, 5))
    h5.close()
    h5 = ph.HDF5MoleculeDataset(five)
    got = list(ph.HDF5BatchLoader(h5, 2, stack_devices=2))
    assert sum(int(b.graph_mask.sum()) for b in got) == 5
    assert got[-1].graph_mask[0].sum() == 1 and not got[-1].graph_mask[1].any()
    h5.close()


def test_scratch_rotation_survives_scratch_sets_minus_one_builds(files):
    h5 = ph.HDF5MoleculeDataset(files["small"])
    plain = list(ph.HDF5BatchLoader(h5, 2, bin_ab=64, bin_mb=16, block_batches=3))
    assert len(plain) > SCRATCH_SETS
    loader = ph.HDF5BatchLoader(h5, 2, bin_ab=64, bin_mb=16, block_batches=3)
    loader.rotate_scratch()
    held = []
    for i, b in enumerate(loader):
        held.append(b)
        if i >= SCRATCH_SETS - 1:
            # the batch built SCRATCH_SETS - 1 builds ago is still intact
            _field_equal(held[i - SCRATCH_SETS + 1], plain[i - SCRATCH_SETS + 1], f"batch {i}")
    _field_equal(held[-1], plain[-1], "last")
    h5.close()
