"""The port's CLI over a rank grid on the CPU: ``--graph_shards 2
--num_devices 2 --device cpu`` starts four gloo ranks (data 2 x graph 2,
runner.py), trains on halo-partitioned binned shards, evaluates and writes
an artifact that the JAX package loads and serves; with both dropouts off
and one epoch its best validation loss is within 5e-3 of a single-device run
with the same seed that takes the same molecules per step (batch 32 = 2 data
shards of 16), JAX's own bar (tests/test_graph_shards_cli.py).  And the
checks that start no rank: ``--graph_shards 0`` and ``--true_multi_hop``
with G > 1 raise; config 3 with G > 1 reaches the rank launch; serving with
``--num_devices 2`` serves in one process; a flat halo shard and config 3
with a graph axis run in the model (one graph rank, equal to the unsplit
batch); a torchrun world size other than num_devices x graph_shards raises
for training (also with neither flag)."""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.config import ValidationError
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.parallel import halo as port_halo

from test_torch_halo_partition import _batches

torch.set_num_threads(1)


@pytest.fixture()
def small_csv(tmp_path):
    rng = np.random.default_rng(0)
    heads = ["C", "O", "N", "F", "Cl", "N#C", "CC", "C=C"]
    units = ["C", "CC", "O", "N", "C(C)", "C(=O)", "C=C", "c1ccc(cc1)", "C1CCC(CC1)"]
    smiles = [heads[rng.integers(8)] + "".join(units[rng.integers(9)]
                                               for _ in range(int(rng.integers(1, 4))))
              + heads[rng.integers(8)] for _ in range(96)]
    smiles[5] = "C" * 40  # a chain that a graph cut splits
    path = tmp_path / "small.csv"
    pd.DataFrame({"smiles": smiles, "gap": rng.normal(size=len(smiles))}).to_csv(path, index=False)
    return str(path)


def _argv(csv, out, *extra):
    return ["--data_path", csv, "--target_column", "gap", "--epochs", "1", "--hidden_dim", "48",
            "--embedding_dim", "8", "--num_message_passing_layers", "2", "--num_shells", "2",
            "--ffn_num_layers", "1", "--device", "cpu", "--shell_conv_dropout", "0",
            "--ffn_dropout", "0", "--learning_rate", "1e-3", "--model_save_path", out, *extra]


def test_cli_graph_shards_trains_and_matches_single_device(tmp_path, small_csv):
    grid = cli.main(_argv(small_csv, str(tmp_path / "g.npz"), "--batch_size", "16",
                          "--graph_shards", "2", "--num_devices", "2"))
    assert np.isfinite(grid["best_val_loss"]) and np.isfinite(grid["test_metrics"]["mae"])
    assert grid["history"][0]["edges_per_sec"] > 0
    single = cli.main(_argv(small_csv, str(tmp_path / "s.npz"), "--batch_size", "32"))
    print(f"best val: grid {grid['best_val_loss']:.7f}, single {single['best_val_loss']:.7f}")
    assert abs(grid["best_val_loss"] - single["best_val_loss"]) < 5e-3
    # the JAX package loads the grid's artifact and predicts from it
    art = jax_load_artifact(str(tmp_path / "g.npz"))
    assert art.model_config.graph_axis is None
    from aimnet_x2d_tpu.chem import compute_features
    from aimnet_x2d_tpu.data.batching import collate

    b = collate([compute_features(s, 2) for s in ["CCO", "c1ccccc1O"]],
                np.zeros((2, 1), np.float32), num_hops=2)
    pred = np.asarray(JaxGNN(art.model_config).apply(art.params, b).predictions)
    assert pred.shape == (2, 1) and np.isfinite(pred).all()


def test_graph_shards_checks_start_no_rank(tmp_path, small_csv, monkeypatch):
    from aimnet_x2d_tpu_torch import runner
    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, save_artifact
    from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts
    from aimnet_x2d_tpu_torch.data.preprocessing import PreprocessingConfig, PreprocessingPipeline
    from aimnet_x2d_tpu_torch.parallel import mesh

    out = str(tmp_path / "m.npz")
    with pytest.raises(ValidationError, match="graph_shards"):
        cli.main(_argv(small_csv, out, "--graph_shards", "0"))
    with pytest.raises(ValidationError, match="hop"):
        cli.main(_argv(small_csv, out, "--graph_shards", "2", "--true_multi_hop"))
    # config 3 with --graph_shards 2 reaches the rank launch (here recorded,
    # not run; tests/test_torch_halo_config3.py trains it on two ranks)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    launched = []
    monkeypatch.setattr(runner, "_launch_ranks", lambda args, world: launched.append(
        (world, args.use_partial_charges, args.use_stereochemistry)) or {})
    monkeypatch.setattr(runner, "print_final_summary", lambda summary, args: None)
    for feature in ("--use_partial_charges", "--use_stereochemistry"):
        cli.main(_argv(small_csv, out, "--graph_shards", "2", feature))
    assert launched == [(2, True, False), (2, False, True)]
    # serving with --num_devices 2 serves in one process, as JAX's CLI does
    cfg = GNNConfig(hidden_dim=32, embedding_dim=8, num_shells=2, num_message_passing_layers=2)
    pipe = PreprocessingPipeline(PreprocessingConfig())
    pipe.fit([np.array([6, 1])] * 4, np.arange(4.0)[:, None])
    save_artifact(out, init_params(cfg, 0), cfg, pipe, extra={"target_columns": ["gap"],
                                                              "max_hops": 2})
    preds = str(tmp_path / "p.csv")
    served = cli.main(["--inference_csv", small_csv, "--model_save_path", out, "--num_devices",
                       "2", "--device", "cpu", "--inference_output", preds])
    assert served["ranks"] == 1 and served["valid_molecules"] == len(pd.read_csv(small_csv))
    assert np.isfinite(pd.read_csv(preds)["gap"]).all()
    # a flat (unbinned) halo shard and config 3 with a graph axis run the
    # row-major halo route; on one graph rank they equal the unsplit batch
    port_b, _ = _batches(np.random.default_rng(1), n=6, big=30, with_stereo=True)
    flat = port_halo.partition_halo(port_b, 1)
    shard = dataclasses.replace(flat, **{f.name: getattr(flat, f.name)[0]
                                         for f in dataclasses.fields(flat)
                                         if isinstance(getattr(flat, f.name), np.ndarray)})
    monkeypatch.setitem(mesh._AXES, "graph", mesh.Axis("graph", 1, 0, None))
    for kw in ({}, dict(use_stereochemistry=True, use_partial_charges=True, graph_axis="graph")):
        model = GNN(GNNConfig(hidden_dim=32, embedding_dim=8, num_shells=2,
                              num_message_passing_layers=2, **kw))
        model.load_state_dict(params_from_flax(init_params(model.config, 1)))
        with torch.no_grad():
            got = model(shard.to("cpu")).predictions
            ref = GNN(dataclasses.replace(model.config, graph_axis=None))
            ref.load_state_dict(model.state_dict())
            want = ref(attach_flat_layouts(port_b).to("cpu")).predictions
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
    # under torchrun the world size must be the grid's, 1 without the flags
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValidationError, match="torchrun started 2"):
        cli.main(_argv(small_csv, out))
    with pytest.raises(ValidationError, match="torchrun started 2"):
        cli.main(_argv(small_csv, out, "--graph_shards", "2", "--num_devices", "2"))


def test_spawned_ranks_meet_at_a_file_rendezvous(monkeypatch):
    """The CLI's spawner hands its ranks a ``file://`` rendezvous in its own
    temporary directory, which it removes after: no TCP port is read and
    released before rank 0 binds it, so no other process can take it in
    between."""
    import argparse
    import os
    import pickle

    import torch.multiprocessing as mp

    from aimnet_x2d_tpu_torch import runner

    seen = {}

    def spawn(fn, args, nprocs, join):
        _, address, world, out_dir = args
        seen.update(address=address, world=world, out_dir=out_dir, nprocs=nprocs)
        with open(os.path.join(out_dir, "summary.pkl"), "wb") as f:
            pickle.dump({"rank": 0}, f)

    monkeypatch.setattr(mp, "spawn", spawn)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert runner._launch_ranks(argparse.Namespace(), 4) == {"rank": 0}
    assert seen["address"] == "file://" + os.path.join(seen["out_dir"], "rendezvous")
    assert seen["world"] == seen["nprocs"] == 4 and not os.path.exists(seen["out_dir"])


def test_multihost_initialize_takes_a_tcp_address_or_a_rendezvous_url(monkeypatch):
    from aimnet_x2d_tpu_torch.parallel import multihost

    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, init_method, world_size, rank: calls.append(init_method))
    multihost.initialize("localhost:1234", 2, 0)
    multihost.initialize("file:///tmp/ranks/rendezvous", 2, 1)
    assert calls == ["tcp://localhost:1234", "file:///tmp/ranks/rendezvous"]
