"""Full serving forward of the PyTorch port against the JAX package's
``GNN.apply(deterministic=True)`` on the binned fast path, whose Pallas
kernels run here in interpret mode (as tests/test_bin_mp.py runs them).

Same weights (``init_params``, loaded into both), same binned batch.
Tolerances: fp32 rtol 5e-4 / atol 5e-5, the repo's bar for the JAX package
against its torch oracle (tests/test_parity.py), since both sides compute
in fp32 and differ only in summation order; bf16 max|d|/max|ref| < 5e-2
(benchmarks/tpu_kernel_parity.py), since the two frameworks round bf16
activations at the same points but sum in other orders.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.chem import compute_features as jax_features
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.data.binning import bin_pack_batch as jax_bin_pack
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax
from aimnet_x2d_tpu_torch.chem import compute_features
from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts, collate
from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.parallel import mesh

torch.set_num_threads(1)

SMILES = ["CCO", "c1ccccc1O", "CC(=O)N", "C1CCC(CC1)OC#N", "CC(C)(F)F", "N#CC=CC",
          "OCC(O)CO", "C[C@H](N)C(=O)O", "F/C=C/F", "c1ccncc1C"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    monkeypatch.setenv("AIMNET_WPOOL_KERNEL", "interpret")


def _tree(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _check(got, ref, dtype, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    print(f"{what} {dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / np.abs(ref).max():.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5)
    else:
        assert err / np.abs(ref).max() < 5e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooling", ["attention", "mean", "sum"])
def test_forward_matches_jax(pooling, dtype):
    kw = dict(hidden_dim=48, embedding_dim=8, num_message_passing_layers=2, output_dim=3,
              num_shells=3, ffn_num_layers=3, pooling_type=pooling, compute_dtype=dtype,
              task_type="multitask")
    targets = np.zeros((len(SMILES), 3), np.float32)
    jb = jax_bin_pack(jax_collate([jax_features(s, 3) for s in SMILES], targets, num_hops=3),
                      ab=64, mb=16)
    pb = bin_pack_batch(collate([compute_features(s, 3) for s in SMILES], targets, num_hops=3),
                        ab=64, mb=16)
    flat = init_params(GNNConfig(**kw), seed=7)
    ref = JaxGNN(JaxConfig(**kw)).apply(_tree(flat), jb, deterministic=True)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        out = model.eval()(pb.to("cpu"), atom_embeddings=True)
    gm, am = pb.graph_mask, pb.atom_mask
    _check(out.predictions.numpy()[gm], np.asarray(ref.predictions)[gm], dtype, "predictions")
    _check(out.mol_embeddings.numpy()[gm], np.asarray(ref.mol_embeddings)[gm], dtype, "mol emb")
    _check(out.atom_embeddings.numpy()[am], np.asarray(ref.atom_embeddings)[am], dtype, "atom emb")
    if pooling == "attention":
        _check(out.attention_weights.numpy(), np.asarray(ref.attention_weights), dtype, "attention")
    else:
        assert out.attention_weights is None and ref.attention_weights is None


def test_atom_embeddings_only_on_request():
    cfg = GNNConfig(hidden_dim=32, embedding_dim=4, num_message_passing_layers=2)
    pb = bin_pack_batch(collate([compute_features(s, 3) for s in SMILES[:3]],
                                np.zeros((3, 1)), num_hops=3), ab=64, mb=16)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed=0)))
    with torch.inference_mode():
        assert model(pb.to("cpu")).atom_embeddings is None


@pytest.mark.parametrize("kw", [
    dict(graph_axis="g"), dict(graph_axis="g", use_partial_charges=True, use_stereochemistry=True),
    dict(graph_axis="g", parity_mode=False),
])
def test_unported_paths_raise(kw, monkeypatch):
    """A model with a graph axis on a batch that is no halo shard runs the
    edge-replicated mode, alone, with config 3 and with true per-hop
    aggregation: outside a rank grid it raises (it never runs quietly as
    one device); on a one-rank graph axis (the whole batch its one edge
    shard) it equals the model without the axis.  The ranks' own tests are
    tests/test_torch_edge_shards.py."""
    cfg = GNNConfig(hidden_dim=32, embedding_dim=4, **kw)
    flat = attach_flat_layouts(collate([compute_features(s, 3) for s in SMILES[:3]],
                                       np.zeros((3, 1)), num_hops=3)).to("cpu")
    weights = params_from_flax(init_params(cfg, seed=0))
    model = GNN(cfg)
    model.load_state_dict(weights)
    with pytest.raises(RuntimeError, match="make_grid has not run"):
        model(flat)
    monkeypatch.setitem(mesh._AXES, "g", mesh.Axis("g", 1, 0, None))
    plain = GNN(dataclasses.replace(cfg, graph_axis=None))
    plain.load_state_dict(weights)
    with torch.no_grad():
        np.testing.assert_allclose(model(flat).predictions.numpy(),
                                   plain(flat).predictions.numpy(), rtol=2e-5, atol=1e-6)
