"""Serving path of the PyTorch port: an artifact written by the JAX
package, served by the port's ``run_csv`` on the CPU, gives the JAX
pipeline's CSV (same rows, same SMILES, predictions within the fp32 bar
rtol 5e-4 / atol 5e-5 of tests/test_parity.py: both sides compute in fp32,
the JAX side on its flat layout, the port on the binned one).  Also the
port's CLI, and that asking for CUDA without a card raises."""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.checkpoint import save_artifact as jax_save_artifact
from aimnet_x2d_tpu.data.dataset import BatchLoader as JaxLoader
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.data.preprocessing import PreprocessingConfig, PreprocessingPipeline
from aimnet_x2d_tpu.data.synthetic import make_synthetic_batch
from aimnet_x2d_tpu.inference.pipeline import StreamingInferencePipeline as JaxPipeline
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.training.predictor import predict as jax_predict
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import load_artifact, params_from_flax
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline
from aimnet_x2d_tpu_torch.models.gnn import GNN
from aimnet_x2d_tpu_torch.training.predictor import predict
from aimnet_x2d_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

SMILES = ["CCO", "c1ccccc1O", "CC(=O)N", "bad((smiles", "C1CCC(CC1)OC#N", "CC(C)(F)F",
          "N#CC=CC", "OCC(O)CO", "C[C@H](N)C(=O)O", "F/C=C/F", "c1ccncc1C", "CCCCCCCC",
          "O=C=O", "C1CC1N", "CC(C)(C)O", "c1ccc2ccccc2c1"]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_inf")
    cfg = JaxConfig(hidden_dim=40, embedding_dim=8, num_message_passing_layers=2,
                    output_dim=2, ffn_num_layers=2, task_type="multitask")
    batch = make_synthetic_batch(num_graphs=3, mean_atoms=8, num_hops=3, num_tasks=2, seed=0)
    params = JaxGNN(cfg).init(jax.random.PRNGKey(3), batch)
    pipe = PreprocessingPipeline(PreprocessingConfig(task_type="multitask"))
    pipe.fit([np.array([6, 1])] * 8, np.random.default_rng(0).normal(size=(8, 2)) * 3 + 1)
    path = str(root / "model.npz")
    jax_save_artifact(path, params, cfg, pipe,
                      extra={"target_columns": ["gap", "homo"], "max_hops": 3})
    csv = str(root / "mols.csv")
    pd.DataFrame({"smiles": SMILES}).to_csv(csv, index=False)
    ref = str(root / "jax.csv")
    JaxPipeline(artifact_path=path, chunk_size=5, batch_size=4).run_csv(csv, ref)
    return path, csv, pd.read_csv(ref)


def _compare(got: pd.DataFrame, ref: pd.DataFrame):
    assert list(got.columns) == list(ref.columns) == ["smiles", "gap", "homo"]
    assert got["smiles"].tolist() == ref["smiles"].tolist()
    assert len(got) == len(SMILES) - 1  # the invalid SMILES is dropped
    g, r = got[["gap", "homo"]].to_numpy(), ref[["gap", "homo"]].to_numpy()
    print(f"max|d| {np.abs(g - r).max():.2e}, max|d|/max|ref| "
          f"{np.abs(g - r).max() / np.abs(r).max():.2e}")  # -s shows it
    np.testing.assert_allclose(g, r, rtol=5e-4, atol=5e-5)


def test_run_csv_matches_jax_pipeline(artifact, tmp_path):
    path, csv, ref = artifact
    out = str(tmp_path / "port.csv")
    summary = StreamingInferencePipeline(path, chunk_size=5, batch_size=4, device="cpu").run_csv(
        csv, out)
    assert summary["total_molecules"] == len(SMILES)
    assert summary["valid_molecules"] == len(SMILES) - 1
    assert 0 < summary["featurize_seconds"] <= summary["seconds"]
    _compare(pd.read_csv(out), ref)


def test_predict_with_embeddings_matches_jax(artifact):
    """predict over binned batches of 4: inverse-transformed predictions,
    molecule and atom embeddings within the fp32 bar, and the atom ->
    molecule index (padding slots collapsed) exactly."""
    path, _, _ = artifact
    smiles = [s for s in SMILES if s != "bad((smiles"]
    targets = np.zeros((len(smiles), 2), np.float32)
    jart = jax_load_artifact(path)
    jds = JaxDataset.from_smiles(smiles, targets, 3)
    ref = jax_predict(JaxGNN(jart.model_config), jart.params,
                      JaxLoader(jds, 4, fixed_shape=True, binned=True), jart.pipeline,
                      return_embeddings=True)
    art = load_artifact(path)
    model = GNN(art.model_config)
    model.load_state_dict(params_from_flax(art.params))
    got = predict(model.eval(), BatchLoader(MoleculeDataset.from_smiles(smiles, targets, 3), 4),
                  "cpu", pipeline=art.pipeline, return_embeddings=True)
    assert set(got) == set(ref)
    for key in ("predictions", "mol_embeddings", "atom_embeddings"):
        np.testing.assert_allclose(got[key], ref[key], rtol=5e-4, atol=5e-5)
    np.testing.assert_array_equal(got["atom_mol_index"], ref["atom_mol_index"])


def test_cli_on_cpu(artifact, tmp_path):
    path, csv, ref = artifact
    out = str(tmp_path / "cli.csv")
    cli.main(["--inference_csv", csv, "--model_save_path", path, "--inference_output", out,
              "--device", "cpu", "--stream_chunk_size", "7"])
    _compare(pd.read_csv(out), ref)


def test_cuda_without_a_card_raises(artifact, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    path, csv, _ = artifact
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--inference_csv", csv, "--model_save_path", path,
                  "--inference_output", str(tmp_path / "x.csv")])
    assert resolve_device("cpu") == torch.device("cpu")
