"""``--iterable_dataset`` training and ``--inference_hdf5`` serving of the
port's CLI against the JAX package, on the CPU:

- the port's CLI builds the three HDF5 files out of core from a CSV (the
  preprocessing fit on the train file) and trains from them; JAX's
  ``_run_training_streaming`` trains on the same three files from the same
  weights (``--transfer_learning`` of one initial artifact on both sides),
  dropouts 0: every epoch's train and validation loss agree to the fp32
  bar of tests/test_torch_epochs.py (rtol 5e-4 / atol 5e-5), and JAX loads
  the port's artifact;
- a file without preprocessing metadata is refused, as JAX refuses it;
- two gloo ranks (``--graph_shards 2``, the CLI starting them) train on
  halo shards streamed from the same files: the loss falls, and the best
  validation loss is within 5e-3 of the single rank's (the bar of
  tests/test_torch_halo_cli.py);
- ``--inference_hdf5`` equals ``--inference_csv`` on the same molecules,
  over 2 ranks too, and JAX's ``run_hdf5`` to the fp32 bar (the twin of
  the JAX package's ``test_hdf5_inference_chunked_matches_csv``).
"""

import os

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu import runner as jax_runner
from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.cli import parse_arguments as jax_parse
from aimnet_x2d_tpu.inference.pipeline import StreamingInferencePipeline as JaxPipeline
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import init_params, save_artifact
from aimnet_x2d_tpu_torch.data import hdf5 as ph
from aimnet_x2d_tpu_torch.data.preprocessing import PreprocessingConfig, PreprocessingPipeline
from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline
from aimnet_x2d_tpu_torch.runner import gnn_config_from_args

torch.set_num_threads(1)

UNITS = ["C", "CC", "O", "N", "C(=O)", "[C@H](F)", "/C=C/", "c1ccccc1", "C(C)C", "Cl"]
EPOCHS = 3


def _smiles(n, seed):
    rng = np.random.default_rng(seed)
    return ["C" + "".join(UNITS[rng.integers(len(UNITS))] for _ in range(int(rng.integers(1, 4))))
            + "O" for _ in range(n)]


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """The port's CLI, single rank, building the files and training."""
    d = tmp_path_factory.mktemp("stream")
    smiles = _smiles(80, 21)
    rng = np.random.default_rng(22)
    n_heavy = np.array([len(s) for s in smiles], np.float32)
    csv = str(d / "train.csv")
    pd.DataFrame({"smiles": smiles, "a": n_heavy * 0.3 + rng.normal(size=80) * 0.1,
                  "b": -n_heavy + rng.normal(size=80) * 0.2}).to_csv(csv, index=False)
    files = [str(d / f"{s}.h5") for s in ("tr", "va", "te")]
    argv = ["--data_path", csv, "--multi_target_columns", "a,b", "--task_type", "multitask",
            "--epochs", str(EPOCHS), "--batch_size", "8", "--hidden_dim", "32",
            "--embedding_dim", "8", "--num_message_passing_layers", "2", "--num_shells", "2",
            "--ffn_num_layers", "2", "--learning_rate", "1e-3", "--shell_conv_dropout", "0",
            "--ffn_dropout", "0", "--calculate_sae", "--sae_subtasks", "0",
            "--iterable_dataset", "--train_hdf5", files[0], "--val_hdf5", files[1],
            "--test_hdf5", files[2]]
    init = str(d / "init.npz")
    cfg = gnn_config_from_args(cli.parse_arguments(argv), 2)
    save_artifact(init, init_params(cfg, seed=4), cfg,
                  PreprocessingPipeline(PreprocessingConfig(task_type="multitask")))
    argv += ["--transfer_learning", init]
    model = str(d / "port.npz")
    summary = cli.main(argv + ["--model_save_path", model, "--device", "cpu"])
    return dict(dir=d, csv=csv, files=files, argv=argv, model=model, summary=summary,
                smiles=smiles)


def test_streaming_training_matches_jax(streamed, monkeypatch):
    files = streamed["files"]
    assert all(os.path.exists(p) for p in files)
    with h5py.File(files[0]) as f:
        assert "preprocessing" in f["metadata"].attrs
    # the port wrote what JAX's writer writes: JAX reads it as its own
    h5 = ph.HDF5MoleculeDataset(files[0])
    assert h5.target_columns == ["a", "b"] and len(h5) > 48
    h5.close()
    results = []
    jax_train = jax_runner.train
    monkeypatch.setattr(jax_runner, "train",
                        lambda *a, **k: results.append(jax_train(*a, **k)) or results[-1])
    jax_args = jax_parse(streamed["argv"] + ["--model_save_path",
                                             str(streamed["dir"] / "jax.npz")])
    ref = jax_runner._run_training_streaming(jax_args)
    got = streamed["summary"]
    for what in ("train_loss", "val_loss"):
        g = [h[what] for h in got["history"]]
        r = [h[what] for h in results[0].history]
        print(f"{what}: port {np.round(g, 6).tolist()} jax {np.round(r, 6).tolist()}")
        assert len(g) == EPOCHS
        np.testing.assert_allclose(g, r, rtol=5e-4, atol=5e-5, err_msg=what)
    assert got["best_epoch"] == ref["best_epoch"]
    np.testing.assert_allclose(got["test_metrics"]["loss"], ref["test_metrics"]["loss"],
                               rtol=5e-4, atol=5e-5)
    art = jax_load_artifact(streamed["model"])
    assert art.extra["target_columns"] == ["a", "b"] and art.model_config.hidden_dim == 32
    assert art.pipeline.state_dict() == jax_load_artifact(str(streamed["dir"] / "jax.npz")
                                                          ).pipeline.state_dict()


def test_files_without_preprocessing_are_refused(streamed, tmp_path):
    files = [str(tmp_path / f"{s}.h5") for s in ("tr", "va", "te")]
    for p in files:
        ph.write_hdf5_streaming(p, streamed["smiles"][:8], np.zeros((8, 2)), 2)
    argv = [a for a in streamed["argv"]]
    for flag, p in zip(("--train_hdf5", "--val_hdf5", "--test_hdf5"), files):
        argv[argv.index(flag) + 1] = p
    with pytest.raises(ValueError, match="lacks preprocessing metadata"):
        cli.main(argv + ["--model_save_path", str(tmp_path / "m.npz"), "--device", "cpu"])


def test_two_graph_ranks_stream_halo_shards(streamed):
    summary = cli.main(streamed["argv"] + ["--model_save_path",
                                           str(streamed["dir"] / "grid.npz"), "--device", "cpu",
                                           "--graph_shards", "2"])
    losses = [h["train_loss"] for h in summary["history"]]
    print("grid train losses", losses, "single", [h["train_loss"]
                                                  for h in streamed["summary"]["history"]])
    assert losses[-1] < losses[0] and np.isfinite(summary["test_metrics"]["mae"])
    assert abs(summary["best_val_loss"] - streamed["summary"]["best_val_loss"]) < 5e-3


def test_inference_hdf5_equals_csv_and_jax(streamed, tmp_path):
    mols = _smiles(40, 23)
    csv, h5_path = str(tmp_path / "mols.csv"), str(tmp_path / "mols.h5")
    pd.DataFrame({"smiles": mols}).to_csv(csv, index=False)
    ph.write_hdf5_streaming(h5_path, mols, np.zeros((len(mols), 1), np.float32), 2)
    common = ["--model_save_path", streamed["model"], "--device", "cpu",
              "--stream_chunk_size", "16", "--stream_batch_size", "8"]
    out_h5, out_csv = str(tmp_path / "h5.csv"), str(tmp_path / "csv.csv")
    res = cli.main(["--inference_hdf5", h5_path, "--inference_output", out_h5, *common])
    assert res["valid_molecules"] == len(mols)
    cli.main(["--inference_csv", csv, "--inference_output", out_csv, *common])
    a, b = pd.read_csv(out_h5), pd.read_csv(out_csv)
    assert a["smiles"].tolist() == b["smiles"].tolist() and list(a.columns) == ["smiles", "a", "b"]
    np.testing.assert_allclose(a[["a", "b"]].to_numpy(), b[["a", "b"]].to_numpy(),
                               rtol=5e-4, atol=5e-5)
    # two ranks in sequence (rank 0 last: it merges), each a range of the file
    ranked = str(tmp_path / "ranked.csv")
    pipe = StreamingInferencePipeline(streamed["model"], chunk_size=16, batch_size=8,
                                      device="cpu")
    for h in (1, 0):
        pipe.run_hdf5(h5_path, ranked, host_id=h, num_hosts=2)
    assert not os.path.exists(ranked + ".rank1")
    c = pd.read_csv(ranked)
    assert c["smiles"].tolist() == a["smiles"].tolist()
    np.testing.assert_allclose(c[["a", "b"]].to_numpy(), a[["a", "b"]].to_numpy(),
                               rtol=5e-4, atol=5e-5)
    out_jax = str(tmp_path / "jax.csv")
    JaxPipeline(artifact_path=streamed["model"], chunk_size=16, batch_size=8).run_hdf5(h5_path,
                                                                                       out_jax)
    j = pd.read_csv(out_jax)
    assert j["smiles"].tolist() == a["smiles"].tolist()
    np.testing.assert_allclose(a[["a", "b"]].to_numpy(), j[["a", "b"]].to_numpy(),
                               rtol=5e-4, atol=5e-5)
