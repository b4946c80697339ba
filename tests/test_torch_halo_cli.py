"""The port's CLI over a rank grid on the CPU: ``--graph_shards 2
--num_devices 2 --device cpu`` starts four gloo ranks (data 2 x graph 2,
runner.py), trains on halo-partitioned binned shards, evaluates and writes
an artifact that the JAX package loads and serves; with both dropouts off
and one epoch its best validation loss is within 5e-3 of a single-device run
with the same seed that takes the same molecules per step (batch 32 = 2 data
shards of 16), JAX's own bar (tests/test_graph_shards_cli.py).  And the
checks that start no rank: ``--graph_shards 0``, ``--true_multi_hop`` with
G > 1, config 3 with G > 1, serving over several ranks, a flat halo shard in
the model, and a torchrun world size other than num_devices x graph_shards
(also with neither flag)."""

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
    out = str(tmp_path / "m.npz")
    with pytest.raises(ValidationError, match="graph_shards"):
        cli.main(_argv(small_csv, out, "--graph_shards", "0"))
    with pytest.raises(ValidationError, match="hop"):
        cli.main(_argv(small_csv, out, "--graph_shards", "2", "--true_multi_hop"))
    for feature in ("--use_partial_charges", "--use_stereochemistry"):
        with pytest.raises(NotImplementedError, match="graph_shards"):
            cli.main(_argv(small_csv, out, "--graph_shards", "2", feature))
    with pytest.raises(NotImplementedError, match="serving over several ranks"):
        cli.main(["--inference_csv", small_csv, "--model_save_path", out, "--num_devices", "2",
                  "--device", "cpu"])
    # a flat (unbinned) halo shard: the row-major halo route is not ported
    port_b, _ = _batches(np.random.default_rng(1), n=6, big=30)
    flat = port_halo.partition_halo(port_b, 2)
    shard = dataclasses.replace(flat, **{f.name: getattr(flat, f.name)[0]
                                         for f in dataclasses.fields(flat)
                                         if isinstance(getattr(flat, f.name), np.ndarray)})
    model = GNN(GNNConfig(hidden_dim=32, embedding_dim=8, num_shells=2,
                          num_message_passing_layers=2))
    with pytest.raises(NotImplementedError, match="flat-layout halo route"):
        model(shard.to("cpu"))
    with pytest.raises(NotImplementedError, match="charges or stereochemistry on graph shards"):
        GNN(GNNConfig(hidden_dim=32, embedding_dim=8, use_stereochemistry=True,
                      graph_axis="graph"))
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
