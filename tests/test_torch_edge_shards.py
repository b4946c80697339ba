"""The port's edge-replicated graph mode against the JAX package's: each rank
holds every atom and a contiguous slice of the edges (``shard_edges``), and
each layer psums its partial aggregate over the graph axis.

- ``shard_edges`` and ``BatchLoader(edge_shards=)`` (the stacked batch and
  each rank's shard) equal to JAX's array for array; edge and halo shards
  exclusive, with JAX's message; edge shards stack, batches with kernel-7
  layouts do not;
- two gloo ranks (graph 2; tests/torch_halo_worker.py, which imports no
  JAX) run the serving forward of attention, mean, sum and max pooling, a
  per-hop model and config 3 on edge shards: equal to JAX's edge-sharded
  ``shard_map`` forward on 2 virtual devices and to the port's forward of
  the whole batch on one device (kernel 7's plain version), rtol 2e-5 /
  atol 1e-6 (tests/test_torch_halo_ranks.py's bar);
- four ranks (data 2 x graph 2) take one train step: the loss equals JAX's
  ``make_graph_parallel_train_step`` on a 2 x 2 mesh and the single-device
  weighted mean (rtol 1e-5), the updated parameters equal both (rtol 2e-4
  / atol 3e-6, tests/test_graph_parallel.py's bar) and are bit-identical
  across the four ranks; a second step with dropout, each data rank's
  generator seeded as ``trainer.train`` seeds it, equals the single-device
  weighted mean with those generators and stays bit-identical across ranks
  (the graph ranks of a data rank draw the same masks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.data.batching import shard_edges as jax_shard_edges
from aimnet_x2d_tpu.data.dataset import BatchLoader as JaxLoader
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.parallel import create_mesh
from aimnet_x2d_tpu.parallel.graph_parallel import make_graph_parallel_train_step
from aimnet_x2d_tpu.training import TrainConfig as JaxTrainConfig
from aimnet_x2d_tpu.training.trainer import make_optimizer as jax_make_optimizer
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.data.batching import (
    attach_flat_layouts,
    index_batch,
    shard_edges,
    stack_batches,
)
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.training import trainer

from test_model import _random_mol
from test_torch_halo_partition import _assert_same, _batches, _port_feats
from test_torch_halo_ranks import KW, _close, _flat, _jax_halo_forward, _run_ranks
from test_torch_train import _tree

torch.set_num_threads(1)

# (name, config fields over KW) of the two-rank forward
CASES = {
    "attention": dict(pooling_type="attention"),
    "mean": dict(pooling_type="mean"),
    "sum": dict(pooling_type="sum"),
    "max": dict(pooling_type="max"),
    "per-hop": dict(pooling_type="attention", parity_mode=False),
    "config3": dict(pooling_type="attention", use_partial_charges=True,
                    use_stereochemistry=True),
}


def _datasets(rng, n):
    mols = [_random_mol(rng, n_atoms=int(rng.integers(5, 10)), num_hops=2, with_stereo=True)
            for _ in range(n)]
    targets = rng.normal(size=(n, 2)).astype(np.float32)
    return (MoleculeDataset(smiles=["x"] * n, targets=targets,
                            features=[_port_feats(m) for m in mols], max_hops=2),
            JaxDataset(smiles=["x"] * n, targets=targets, features=mols, max_hops=2))


def _unshard(stacked, d: int, G: int):
    """Data shard ``d`` of a stacked (N, G, ...) edge-sharded host batch with
    its edges put back together: the whole shard, flat, with kernel 7's
    layouts (the padding edges stay masked)."""
    parts = [index_batch(stacked, d, g) for g in range(G)]
    return attach_flat_layouts(dataclasses.replace(
        parts[0], **{k: np.concatenate([getattr(p, k) for p in parts])
                     for k in ("edge_src", "edge_dst", "edge_hop", "edge_mask")}))


@pytest.mark.parametrize("G", [2, 3, 4])
def test_shard_edges_matches_jax(G):
    rng = np.random.default_rng(10 + G)
    port_b, jax_b = _batches(rng, n=7, with_stereo=True)
    got = shard_edges(attach_flat_layouts(port_b), G)
    want = jax_shard_edges(jax_b, G)
    assert len(got) == len(want) == G
    E = port_b.edge_src.shape[0]
    assert sum(s.edge_src.shape[0] for s in got) == -(-E // G) * G
    assert sum(int(s.edge_mask.sum()) for s in got) == int(port_b.edge_mask.sum())
    for s, j in zip(got, want):
        assert s.fused_fwd is None and s.fused_bwd is None  # no layout of every edge
        _assert_same(s, j)


def test_loader_edge_shards_match_jax():
    rng = np.random.default_rng(5)
    ds, jds = _datasets(rng, 32)
    kw = dict(shuffle=True, seed=3, stack_devices=2, edge_shards=4)
    loader, jloader = BatchLoader(ds, 8, **kw), JaxLoader(jds, batch_size=8, **kw)
    ranks = {(d, g): BatchLoader(ds, 8, rank=(d, g), **kw) for d in range(2) for g in range(4)}
    assert not loader.binned and not jloader.binned and len(loader) == len(jloader) == 2
    for ld in (loader, jloader, *ranks.values()):
        ld.set_epoch(1)
    steps, jsteps = list(loader), list(jloader)
    per_rank = {k: list(v) for k, v in ranks.items()}
    for s, (st, jst) in enumerate(zip(steps, jsteps)):
        assert st.atom_type.shape[:2] == (2, 4) and st.fused_fwd is None
        _assert_same(st, jst)
        for (d, g), bs in per_rank.items():
            _assert_same(bs[s], jax.tree_util.tree_map(lambda x: x[d, g], jst))


def test_edge_and_halo_shards_are_exclusive():
    ds, jds = _datasets(np.random.default_rng(0), 4)
    for make in (lambda: BatchLoader(ds, 2, stack_devices=1, edge_shards=2, halo_shards=2),
                 lambda: JaxLoader(jds, batch_size=2, stack_devices=1, edge_shards=2,
                                   halo_shards=2)):
        with pytest.raises(ValueError, match="edge_shards and halo_shards are exclusive"):
            make()


@pytest.fixture(scope="module")
def two_rank_forward(tmp_path_factory):
    """One start of two ranks (graph 2) running every case's serving forward
    on the edge shards of one batch; returns (ranks' results, the
    single-device batch, the JAX stacked shards, configs and weights)."""
    rng = np.random.default_rng(8)
    port_b, jax_b = _batches(rng, n=7, with_stereo=True)
    assert port_b.tet_mask.any() and port_b.cis_mask.any()
    stacked = stack_batches(shard_edges(port_b, 2))
    jstacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *jax_shard_edges(jax_b, 2))
    cfgs = {name: GNNConfig(**KW, **over) for name, over in CASES.items()}
    weights = {name: init_params(cfg, seed=2) for name, cfg in cfgs.items()}
    job = {"kind": "forward", "grid": (1, 2), "stacked": stack_batches([stacked]),
           "cfgs": {name: (dataclasses.replace(cfg, graph_axis="graph"), weights[name])
                    for name, cfg in cfgs.items()}}
    res = _run_ranks(tmp_path_factory.mktemp("edge-forward"), job, 2)
    return res, attach_flat_layouts(port_b).to("cpu"), jstacked, cfgs, weights


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_edge_forward_matches_jax_and_single_device(case, two_rank_forward):
    res, single, jstacked, cfgs, weights = two_rank_forward
    np.testing.assert_array_equal(res[0][case], res[1][case])  # replicated over the graph axis
    ref = _jax_halo_forward(dict(KW, **CASES[case]), _tree(weights[case]), jstacked, 2)
    _close(res[0][case], ref, f"{case}: ranks vs JAX edge shards")
    model = GNN(cfgs[case])
    model.load_state_dict(params_from_flax(weights[case]))
    with torch.no_grad():
        own = model(single)
    _close(res[0][case], own.predictions.numpy(), f"{case}: ranks vs single device")
    if own.partial_charges is not None:
        for r in res:
            _close(r[f"{case}/charges"], own.partial_charges.numpy(), f"{case}: charges")


def test_four_rank_edge_train_step_matches_jax_and_weighted_mean(tmp_path):
    rng = np.random.default_rng(9)
    ds, jds = _datasets(rng, 16)
    kw = dict(stack_devices=2, edge_shards=2)
    stacked = next(iter(BatchLoader(ds, 8, **kw)))
    jstacked = next(iter(JaxLoader(jds, batch_size=8, **kw)))
    lr, seed = 1e-3, 11
    cfg = GNNConfig(pooling_type="attention", **KW)
    drop = dataclasses.replace(cfg, shell_conv_dropout=0.1, ffn_dropout=0.1)
    flat = init_params(cfg, seed=6)
    steps = [(dataclasses.replace(c, graph_axis="graph"), flat, lr, s)
             for c, s in ((cfg, None), (drop, seed))]
    res = _run_ranks(tmp_path, {"kind": "edge_step", "grid": (2, 2), "stacked": stacked,
                                "steps": steps}, 4)
    for r in res[1:]:  # the same update on every rank, with and without dropout
        for got, want in zip(r, res[0]):
            assert got["loss"] == want["loss"] and got["n"] == want["n"]
            for k, v in want["params"].items():
                np.testing.assert_array_equal(got["params"][k], v, err_msg=k)

    # JAX: make_graph_parallel_train_step on a (data 2, graph 2) mesh
    tc = JaxTrainConfig(learning_rate=lr, task_type="multitask")
    params = _tree(flat)
    opt = jax_make_optimizer(tc, params)
    mesh = create_mesh(num_data=2, num_graph=2, devices=jax.devices()[:4])
    step = make_graph_parallel_train_step(JaxGNN(JaxConfig(**KW)), tc, opt, mesh)
    p_jax, _, loss_jax, n_jax = step(jax.tree_util.tree_map(jnp.copy, params), opt.init(params),
                                     jstacked, jnp.float32(lr), jax.random.PRNGKey(7))
    np.testing.assert_allclose(res[0][0]["loss"], float(loss_jax), rtol=1e-5)
    assert res[0][0]["n"] == float(n_jax) == 16.0
    flat_jax = {k: np.asarray(v) for k, v in _flat(p_jax).items()}
    for k, v in res[0][0]["params"].items():
        np.testing.assert_allclose(v, flat_jax[k], rtol=2e-4, atol=3e-6, err_msg=f"JAX {k}")

    # the port on one device: the weighted mean of the whole data shards'
    # gradients, each shard's dropout drawn from its data rank's generator
    for (c, _, _, s), r in zip(steps, res[0]):
        model = GNN(dataclasses.replace(c, graph_axis=None))
        model.load_state_dict(params_from_flax(flat))
        tcp = trainer.TrainConfig(learning_rate=lr, task_type="multitask")
        opt_t = trainer.make_optimizer(model, tcp)
        loss_fn = trainer.make_loss_fn(tcp)
        grads, loss_sum, n_sum = None, 0.0, 0.0
        for d in range(2):
            b = _unshard(stacked, d, 2).to("cpu")
            gen = None if s is None else torch.Generator().manual_seed(
                s + trainer.DATA_SEED_STRIDE * d)
            opt_t.zero_grad()
            n = float(b.graph_mask.sum())
            loss = loss_fn(model(b, train=True, generator=gen).predictions, b.targets,
                           b.graph_mask)
            loss.backward()
            g = [p.grad.clone() * n if p.grad is not None else None for p in opt_t.params]
            grads = g if grads is None else [a + e if a is not None else None
                                             for a, e in zip(grads, g)]
            loss_sum, n_sum = loss_sum + float(loss.detach()) * n, n_sum + n
        for p, g in zip(opt_t.params, grads):
            p.grad = None if g is None else g / n_sum
        opt_t.step(lr)
        np.testing.assert_allclose(r["loss"], loss_sum / n_sum, rtol=1e-5)
        mean_ref = params_to_flax(model.state_dict(), c)
        for k, v in r["params"].items():
            np.testing.assert_allclose(v, mean_ref[k], rtol=2e-4, atol=3e-6,
                                       err_msg=f"mean (seed {s}) {k}")


def test_stacking_refuses_flat_layouts():
    """Kernel-7 layouts are per batch: stacking batches that carry them
    raises, where it would hand every stacked shard the first's layouts;
    edge shards carry none and stack."""
    port_b, _ = _batches(np.random.default_rng(1), n=4)
    flat = attach_flat_layouts(port_b)
    with pytest.raises(ValueError, match="do not stack"):
        stack_batches([flat, flat])
    assert stack_batches(shard_edges(flat, 2)).edge_src.shape[0] == 2
