"""Config 3 (partial charges and stereochemistry) on halo graph shards, and
the row-major halo route, on gloo ranks of the CPU (one process each,
tests/torch_halo_worker.py, which imports no JAX), against the JAX
package's ``shard_map`` on virtual CPU devices and the port's own
single-device forward of the unpartitioned batch:

- two ranks (graph 2) serve config 3 (both features, and each alone) on
  binned halo shards (the halo stack: the injections, then kernel 5's plain
  version) and on flat halo shards (the row-major route: ``[x ; halo]``
  summed by ``index_add``), of molecules with tetrahedral centres and
  cis/trans pairs and one that the cut splits; and a per-hop
  (``parity_mode=False``) model, with and without config 3, on flat and
  binned shards.  Predictions equal JAX's halo forward (kernel 5 in
  interpret mode) and the single-device forward, each rank's partial
  charges (row 0 of its final x_other) equal JAX's, rtol 2e-5 / atol 1e-6
  (JAX's own bar, tests/test_halo.py);
- four ranks (data 2 x graph 2) take one config-3 train step on binned and
  on flat shards: the loss equals JAX's ``make_graph_parallel_train_step``
  on a 2 x 2 mesh and the single-device weighted mean (rtol 1e-5), every
  updated parameter both (rtol 2e-4 / atol 2e-5, as
  tests/test_torch_halo_ranks.py holds them; the attention heads' score
  biases, whose exact gradient is 0, within lr, as
  tests/test_torch_epochs.py holds them), bit-identical across ranks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.parallel import create_mesh
from aimnet_x2d_tpu.parallel import halo as jax_halo
from aimnet_x2d_tpu.parallel.graph_parallel import make_graph_parallel_train_step
from aimnet_x2d_tpu.training import TrainConfig as JaxTrainConfig
from aimnet_x2d_tpu.training.trainer import make_optimizer as jax_make_optimizer
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts, stack_batches
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.parallel import halo as port_halo
from aimnet_x2d_tpu_torch.training import trainer

from test_torch_halo_partition import _batches
from test_torch_halo_ranks import KW, _close, _flat, _run_ranks
from test_torch_train import _tree

torch.set_num_threads(1)

FEATURES = {"config3": dict(use_partial_charges=True, use_stereochemistry=True),
            "charges": dict(use_partial_charges=True),
            "stereo": dict(use_stereochemistry=True)}
LAYOUTS = {"binned": dict(binned=True, ab=32), "flat": {}}


def _jax_halo_forward(kw, params, stacked, G):
    """JAX's halo forward on G virtual devices: (predictions, each device's
    partial charges concatenated, or None)."""
    mesh = create_mesh(num_data=1, num_graph=G, devices=jax.devices()[:G])
    gm = JaxGNN(JaxConfig(**kw, graph_axis="graph"))
    charges = kw.get("use_partial_charges", False)

    def fwd(p, b):
        local = jax.tree_util.tree_map(lambda x: x[0], b)
        o = gm.apply(p, local, deterministic=True)
        return o.predictions, (o.partial_charges if charges else jnp.zeros(1))

    preds, q = jax.jit(jax.shard_map(fwd, mesh=mesh, in_specs=(P(), P(("graph",))),
                                     out_specs=(P(), P("graph")), check_vma=False))(params, stacked)
    return np.asarray(preds), (np.asarray(q) if charges else None)


def test_two_rank_config3_and_row_route_forward_match_jax_and_single_device(tmp_path,
                                                                            monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    rng = np.random.default_rng(11)
    port_b, jax_b = _batches(rng, n=6, big=40, with_stereo=True)
    assert port_b.tet_mask.any() and port_b.cis_mask.any() and port_b.trans_mask.any()
    stacked, jstacked = {}, {}
    for lay, kw in LAYOUTS.items():
        stacked[lay], stats = port_halo.partition_halo(port_b, 2, return_stats=True, **kw)
        assert stats.cut_edges > 0 and stats.split_molecules >= 1 and stats.halo_rows > 0
        jstacked[lay] = jax_halo.partition_halo(jax_b, 2, **kw)
    cases = {}  # name -> (config kwargs, layout)
    for feat, fkw in FEATURES.items():
        for lay in LAYOUTS:
            cases[f"{feat}/{lay}"] = (fkw, lay)
    for lay in LAYOUTS:
        cases[f"per-hop/{lay}"] = (dict(parity_mode=False), lay)
    cases["per-hop-config3/flat"] = (dict(parity_mode=False, **FEATURES["config3"]), "flat")
    cfgs = {}
    for name, (fkw, lay) in cases.items():
        cfg = GNNConfig(pooling_type="attention", **KW, **fkw)
        cfgs[name] = (cfg, init_params(cfg, seed=3), lay)
    res = _run_ranks(tmp_path, {"kind": "forward", "grid": (1, 2),
                                "stacked": {k: stack_batches([v]) for k, v in stacked.items()},
                                "cfgs": cfgs}, 2)
    single = attach_flat_layouts(port_b).to("cpu")  # the unpartitioned batch, in its order
    for name, (cfg, flat, lay) in cfgs.items():
        np.testing.assert_array_equal(res[0][name], res[1][name])  # replicated over the axis
        kw = dict(KW, pooling_type="attention", **cases[name][0])
        ref, ref_q = _jax_halo_forward(kw, _tree(flat), jstacked[lay], 2)
        _close(res[0][name], ref, f"{name}: ranks vs JAX halo")
        if cfg.use_partial_charges:
            got_q = np.concatenate([r[f"{name}/charges"] for r in res])
            _close(got_q, ref_q, f"{name}: each rank's partial charges vs JAX halo")
        model = GNN(cfg)
        model.load_state_dict(params_from_flax(flat))
        with torch.no_grad():
            own = model(single).predictions.numpy()
        _close(res[0][name], own, f"{name}: ranks vs single device")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_four_rank_config3_step_matches_jax_and_weighted_mean(tmp_path, monkeypatch, layout):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    rng = np.random.default_rng(12)
    pairs = [_batches(rng, n=8, with_stereo=True), _batches(rng, n=8, big=40, with_stereo=True)]
    kw = LAYOUTS[layout]
    parts, _ = port_halo.partition_halo_stack([p for p, _ in pairs], 2, **kw)
    jparts, _ = jax_halo.partition_halo_stack([j for _, j in pairs], 2, **kw)
    lr = 1e-3
    ckw = dict(KW, pooling_type="attention", **FEATURES["config3"])
    cfg = GNNConfig(**ckw)
    flat = init_params(cfg, seed=6)
    res = _run_ranks(tmp_path, {"kind": "step", "grid": (2, 2), "stacked": stack_batches(parts),
                                "cfg": cfg, "params": flat, "lr": lr}, 4)
    for r in res[1:]:  # the update is the same on every rank
        assert r["loss"] == res[0]["loss"] and r["n"] == res[0]["n"]
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)

    # JAX: make_graph_parallel_train_step on a (data 2, graph 2) mesh
    tc = JaxTrainConfig(learning_rate=lr, task_type="multitask")
    params = _tree(flat)
    opt = jax_make_optimizer(tc, params)
    mesh = create_mesh(num_data=2, num_graph=2, devices=jax.devices()[:4])
    step = make_graph_parallel_train_step(JaxGNN(JaxConfig(**ckw)), tc, opt, mesh)
    jstacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *jparts)
    p_halo, _, loss_halo, n_halo = step(jax.tree_util.tree_map(jnp.copy, params),
                                        opt.init(params), jstacked, jnp.float32(lr),
                                        jax.random.PRNGKey(7))
    np.testing.assert_allclose(res[0]["loss"], float(loss_halo), rtol=1e-5)
    assert res[0]["n"] == float(n_halo) == 16.0
    flat_halo = {k: np.asarray(v) for k, v in _flat(p_halo).items()}

    # the port on one device: the weighted mean of the data shards' gradients
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    tcp = trainer.TrainConfig(learning_rate=lr, task_type="multitask")
    opt_t = trainer.make_optimizer(model, tcp)
    loss_fn = trainer.make_loss_fn(tcp)
    grads, loss_sum, n_sum = None, 0.0, 0.0
    for pb, _ in pairs:
        b = attach_flat_layouts(pb).to("cpu")  # the unpartitioned shard
        opt_t.zero_grad()
        n = float(b.graph_mask.sum())
        loss = loss_fn(model(b, train=True).predictions, b.targets, b.graph_mask)
        loss.backward()
        g = [p.grad.clone() * n if p.grad is not None else None for p in opt_t.params]
        grads = g if grads is None else [a + c if a is not None else None for a, c in zip(grads, g)]
        loss_sum, n_sum = loss_sum + float(loss.detach()) * n, n_sum + n
    for p, g in zip(opt_t.params, grads):
        p.grad = None if g is None else g / n_sum
    opt_t.step(lr)
    np.testing.assert_allclose(res[0]["loss"], loss_sum / n_sum, rtol=1e-5)
    mean_ref = params_to_flax(model.state_dict(), cfg)
    for k, v in res[0]["params"].items():
        if k.startswith("params/pooling/attention_weights_") and k.endswith("/bias"):
            # a head's score bias shifts each of its scores alike, so each
            # molecule's softmax does not move: its exact gradient is 0 and
            # Adam turns each side's rounding residue into a step of up to
            # lr (tests/test_torch_epochs.py holds them so)
            for ref in (flat_halo[k], mean_ref[k], flat[k]):
                assert np.abs(v - ref).max() <= lr + 2e-5, k
            continue
        np.testing.assert_allclose(v, flat_halo[k], rtol=2e-4, atol=2e-5, err_msg=f"JAX {k}")
        np.testing.assert_allclose(v, mean_ref[k], rtol=2e-4, atol=2e-5, err_msg=f"mean {k}")


def test_halo_charge_and_stereo_pieces_on_one_rank():
    """The halo injections' pieces against their single-device twins with
    no axis (a graph axis of one rank): the feature-major segment charge
    equilibration equals the row-major one transposed, and the row-major
    halo exchange is the feature-major one transposed."""
    from aimnet_x2d_tpu_torch.models import gnn
    from aimnet_x2d_tpu_torch.ops import halo
    from aimnet_x2d_tpu_torch.parallel.mesh import Axis

    rng = np.random.default_rng(13)
    port_b, _ = _batches(rng, n=6, with_stereo=True)
    b = port_b.to("cpu")
    A = b.atom_type.shape[0]
    x = torch.from_numpy(rng.normal(size=(A, 9)).astype(np.float32))
    got = gnn.charge_equilibration_t_seg(x.T.contiguous(), b, None).T
    want = gnn.charge_equilibration(x, b)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    one = Axis("graph", 1, 0, None)
    send = torch.tensor([[2, 0, -1, 5]], dtype=torch.int32)
    rows = halo.halo_exchange(x, send, one)
    torch.testing.assert_close(rows, halo.halo_exchange_t(x.T.contiguous(), send, one).T)
    torch.testing.assert_close(rows[:2], x[[2, 0]])
    assert float(rows[2].abs().max()) == 0.0
    # its backward sums the cotangents into the sent rows
    xr = x.clone().requires_grad_(True)
    halo.halo_exchange(xr, send, one).sum().backward()
    want_g = torch.zeros_like(x)
    want_g[[2, 0, 5]] = 1.0
    torch.testing.assert_close(xr.grad, want_g)


def test_stereo_context_of_a_halo_shard_keeps_the_pair_lists():
    from aimnet_x2d_tpu_torch.data.batching import index_batch
    from aimnet_x2d_tpu_torch.models import gnn

    rng = np.random.default_rng(14)
    port_b, _ = _batches(rng, n=6, big=40, with_stereo=True)
    shard = index_batch(port_halo.partition_halo(port_b, 2, binned=True, ab=32), 0).to("cpu")
    ctx = gnn.stereo_context(shard)
    assert ctx.stereo_adj is None and shard.bin_adj is not None
    whole = gnn.stereo_context(dataclasses.replace(shard, halo_send_idx=None))
    assert whole.stereo_adj is not None


def test_cli_trains_config3_on_graph_shards(tmp_path):
    """The CLI with ``--graph_shards 2 --use_partial_charges
    --use_stereochemistry`` trains on two gloo ranks (runner.py starts them)
    on halo-partitioned binned shards, and writes the test split's partial
    charges as a single-rank run does; with both dropouts off its best
    validation loss is within 5e-3 of a single-rank run over the same
    molecules per step (the bar of tests/test_torch_halo_cli.py) and its
    charges agree with that run's."""
    import pandas as pd

    from aimnet_x2d_tpu_torch import cli

    rng = np.random.default_rng(15)
    units = ["C", "CC", "O", "N", "C(=O)", "[C@H](F)", "[C@@H](N)", "/C=C/", "/C=C\\", "c1ccccc1"]
    smiles = ["C" + "".join(units[rng.integers(len(units))] for _ in range(int(rng.integers(1, 4))))
              + "O" for _ in range(64)]
    smiles[5] = "C" * 40  # a chain that a graph cut splits
    csv = tmp_path / "c3.csv"
    pd.DataFrame({"smiles": smiles, "gap": rng.normal(size=len(smiles))}).to_csv(csv, index=False)

    def run(name, *extra):
        q = str(tmp_path / f"{name}-q.npz")
        summary = cli.main([
            "--data_path", str(csv), "--target_column", "gap", "--epochs", "1", "--batch_size",
            "16", "--hidden_dim", "48", "--embedding_dim", "8", "--num_message_passing_layers", "2",
            "--num_shells", "2", "--ffn_num_layers", "1", "--device", "cpu",
            "--shell_conv_dropout", "0", "--ffn_dropout", "0", "--learning_rate", "1e-3",
            "--use_partial_charges", "--use_stereochemistry", "--output_partial_charges", q,
            "--model_save_path", str(tmp_path / f"{name}.npz"), *extra])
        with np.load(q) as f:
            return summary, f["charges"], f["molecule_index"]

    grid, gq, gi = run("grid", "--graph_shards", "2")
    single, sq, si = run("single")
    print(f"best val: grid {grid['best_val_loss']:.7f}, single {single['best_val_loss']:.7f}")
    assert np.isfinite(grid["best_val_loss"]) and np.isfinite(grid["test_metrics"]["mae"])
    assert abs(grid["best_val_loss"] - single["best_val_loss"]) < 5e-3
    np.testing.assert_array_equal(gi, si)
    np.testing.assert_allclose(gq, sq, rtol=1e-3, atol=1e-4)
