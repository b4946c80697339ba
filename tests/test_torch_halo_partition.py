"""The port's halo partitioner (aimnet_x2d_tpu_torch/parallel/halo.py) against
the JAX package's: every array of ``partition_halo`` and
``partition_halo_stack`` bit-equal on the same collated batches, flat and
binned, G = 2 and 4, with a split molecule, a stereo row that makes the cut
slide, the degenerate cut of an unsplittable stereo molecule, growing slot
pins, and the stereo cut that raises; plus the loader's halo mode."""

import dataclasses

import numpy as np
import pytest

from aimnet_x2d_tpu.data.batching import MolBatch as JaxBatch
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.parallel import halo as jax_halo
from aimnet_x2d_tpu_torch.data import batching as port_batching
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.parallel import halo as port_halo

from test_model import _random_mol


def _port_feats(f):
    return port_batching.MolFeatures(**{k.name: getattr(f, k.name)
                                        for k in dataclasses.fields(port_batching.MolFeatures)})


def _batches(rng, n=10, big=None, with_stereo=False):
    sizes = [int(rng.integers(5, 10)) for _ in range(n)]
    if big:
        sizes[0] = big
    mols = [_random_mol(rng, n_atoms=s, num_hops=2, with_stereo=with_stereo and s >= 5)
            for s in sizes]
    targets = rng.normal(size=(n, 2)).astype(np.float32)
    return (port_batching.collate([_port_feats(m) for m in mols], targets, num_hops=2),
            jax_collate(mols, targets, num_hops=2))


def _assert_same(got, want):
    for f in dataclasses.fields(JaxBatch):
        b = getattr(want, f.name)
        if not hasattr(port_batching.MolBatch, f.name) and f.name not in {
                x.name for x in dataclasses.fields(port_batching.MolBatch)}:
            assert b is None or not isinstance(b, np.ndarray) or b.size == 0, f.name
            continue
        a = getattr(got, f.name)
        if isinstance(b, np.ndarray) or hasattr(b, "shape"):
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


def _stats_same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


CASES = [
    # (name, G, kwargs of partition_halo, batch maker kwargs)
    ("whole", 2, {}, {}),
    ("split", 4, {}, {"big": 60}),
    ("binned", 2, {"binned": True}, {}),
    ("binned-split-ab16", 4, {"binned": True, "ab": 16}, {"big": 60}),
    ("binned-stereo", 2, {"binned": True, "ab": 32}, {"big": 40, "with_stereo": True}),
    ("flat-stereo", 4, {}, {"with_stereo": True}),
]


@pytest.mark.parametrize("name,G,kw,mk", CASES, ids=[c[0] for c in CASES])
def test_partition_halo_bit_equal(rng, name, G, kw, mk):
    port_b, jax_b = _batches(rng, **mk)
    got, gs = port_halo.partition_halo(port_b, G, return_stats=True, **kw)
    want, ws = jax_halo.partition_halo(jax_b, G, return_stats=True, **kw)
    _assert_same(got, want)
    _stats_same(gs, ws)
    if "split" in name:
        assert gs.split_molecules >= 1 and gs.cut_edges > 0


def _stereo_big(rng, rows, n_atoms):
    big = _random_mol(rng, n_atoms=n_atoms, num_hops=2)
    big.tet_nbrs = np.array(rows, np.int32)
    big.cis_pairs = np.zeros((0, 2), np.int32)
    big.trans_pairs = np.zeros((0, 2), np.int32)
    t = rng.normal(size=(1, 2)).astype(np.float32)
    return (port_batching.collate([_port_feats(big)], t, num_hops=2),
            jax_collate([big], t, num_hops=2))


@pytest.mark.parametrize("binned", [False, True])
def test_stereo_cut_slides_and_degenerates_as_jax(rng, binned):
    kw = {"binned": True, "ab": 16} if binned else {}
    # a centre across the midpoint: the cut slides off it
    pb, jb = _stereo_big(rng, [[30, 31, 32, 33]], 64)
    got, gs = port_halo.partition_halo(pb, 4, return_stats=True, **kw)
    want, ws = jax_halo.partition_halo(jb, 4, return_stats=True, **kw)
    _assert_same(got, want)
    _stats_same(gs, ws)
    assert gs.split_molecules == 1
    # every interior cut severs a row: one rank holds the molecule whole
    pb, jb = _stereo_big(rng, [[i, i + 1, i + 2, i + 3] for i in range(29)], 32)
    got, gs = port_halo.partition_halo(pb, 4, return_stats=True, **kw)
    want, ws = jax_halo.partition_halo(jb, 4, return_stats=True, **kw)
    _assert_same(got, want)
    assert gs.split_molecules == 0
    assert got.atom_mask.sum(axis=1).tolist()[0] == 32


def test_unsplittable_stereo_row_raises_as_jax():
    """``_device_cuts``'s ValueError: a stereo row spans the only cut and no
    safe position exists in the rank's range (both packages raise)."""
    mol_of = np.zeros(8, np.int64)
    cut_ok = np.zeros(9, bool)
    cut_ok[0] = True  # not even the end is a legal cut
    for mod in (port_halo, jax_halo):
        with pytest.raises(ValueError, match="no safe cut"):
            mod._device_cuts(mol_of, 8, 2, cut_ok)
    ok = np.ones(9, bool)
    ok[3:6] = False
    assert port_halo._device_cuts(mol_of, 8, 2, ok) == jax_halo._device_cuts(mol_of, 8, 2, ok)


@pytest.mark.parametrize("binned", [False, True])
def test_partition_halo_stack_grows_pins_as_jax(rng, binned):
    pairs = [_batches(rng, n=8), _batches(rng, n=8, big=40), _batches(rng, n=6)]
    kw = {"binned": True, "ab": 32} if binned else {}
    got, gslots = port_halo.partition_halo_stack([p for p, _ in pairs], 2, **kw)
    want, wslots = jax_halo.partition_halo_stack([j for _, j in pairs], 2, **kw)
    assert gslots == wslots
    for a, b in zip(got, want):
        _assert_same(a, b)
    # every part re-partitioned to the final pins: one shape
    assert len({p.atom_type.shape + p.edge_src.shape + p.halo_send_idx.shape for p in got}) == 1
    # fed back, the pins only grow
    got2, gslots2 = port_halo.partition_halo_stack([pairs[0][0]], 2, slots=gslots, **kw)
    want2, wslots2 = jax_halo.partition_halo_stack([pairs[0][1]], 2, slots=wslots, **kw)
    assert gslots2 == wslots2 == gslots
    _assert_same(got2[0], want2[0])


def test_loader_halo_shards_one_shape_per_rank(rng):
    mols = [_port_feats(_random_mol(rng, n_atoms=int(rng.integers(5, 10)), num_hops=2))
            for _ in range(32)]
    ds = MoleculeDataset(smiles=["x"] * 32, targets=rng.normal(size=(32, 2)).astype(np.float32),
                         features=mols, max_hops=2)
    stacked = BatchLoader(ds, 8, shuffle=True, seed=3, stack_devices=2, halo_shards=2, bin_ab=32)
    ranks = {(d, g): BatchLoader(ds, 8, shuffle=True, seed=3, stack_devices=2, halo_shards=2,
                                 bin_ab=32, rank=(d, g)) for d in range(2) for g in range(2)}
    for loader in (stacked, *ranks.values()):
        assert loader.binned and len(loader) == 2
        loader.set_epoch(1)
    steps = list(stacked)
    assert len(steps) == 2
    for s, st in enumerate(steps):
        assert st.atom_type.shape[:2] == (2, 2) and st.pool_mat is None
        assert int(st.atom_mask.sum()) == sum(
            int(ds.features[i].num_atoms) for i in stacked._batch_indices()[s])
    for (d, g), loader in ranks.items():
        for s, b in enumerate(loader):
            # a rank partitions its data shard alone, with its own pins:
            # the same arrays as the stacked shard when the pins agree
            assert b.bin_adj.shape[1] == 32 and b.halo_send_idx.shape[0] == 2
            assert b.halo_adj.shape == (2 * b.halo_send_idx.shape[1], b.atom_type.shape[0])
            ref = steps[s]
            if ref.atom_type.shape[2:] == (b.atom_type.shape[0],) and \
                    ref.halo_send_idx.shape[3] == b.halo_send_idx.shape[1]:
                np.testing.assert_array_equal(b.atom_type, ref.atom_type[d, g])
                np.testing.assert_array_equal(b.halo_adj, ref.halo_adj[d, g])
            assert int(b.atom_mask.sum()) == int(ref.atom_mask[d, g].sum())
