"""MC-dropout and evidential serving of the PyTorch port against the JAX
package, on the CPU (the kernels' plain versions), from artifacts written
by the JAX package:

- evidential: ``predict_evidential`` and ``run_csv``'s four extra columns
  per target at the fp32 bar (rtol 5e-4 / atol 5e-5, as
  tests/test_torch_inference.py: both sides in fp32, JAX on its flat
  layout, the port on the binned one);
- MC-dropout with every dropout rate 0: the mean equal to JAX's
  ``predict_mc_dropout`` at the fp32 bar, the std exactly 0 (two samples,
  whose mean and deviations are exact in float32);
- MC-dropout with dropout: the masks come from different generators
  (JAX's threefry, the port's hash and torch generator), so the S = 256
  sample means and stds are held statistically, per molecule and target:
  |mean_port - mean_jax| <= 6 sqrt((s_p^2 + s_j^2) / S), and the stds
  within 6 standard errors of a sample std, sqrt((k - 1) / (4 S)) s,
  with the kurtosis k bounded by 9.  Both sides run from fixed seeds, so
  the test is deterministic;
- reruns from the same generator seed are bit-equal;
- the CLI: ``--mc_samples 4`` alone selects MC-dropout and writes the
  ``_uncertainty`` columns; ``--inference_mode evidential`` writes
  ``_aleatoric``, ``_epistemic`` and ``_total_uncertainty``.
"""

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
from aimnet_x2d_tpu.training.predictor import predict_evidential as jax_predict_evidential
from aimnet_x2d_tpu.training.predictor import predict_mc_dropout as jax_predict_mc
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import load_artifact, params_from_flax
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline
from aimnet_x2d_tpu_torch.models.gnn import GNN
from aimnet_x2d_tpu_torch.training.predictor import predict_evidential, predict_mc_dropout

torch.set_num_threads(1)

SMILES = ["CCO", "c1ccccc1O", "CC(=O)N", "bad((smiles", "C1CCC(CC1)OC#N", "CC(C)(F)F",
          "N#CC=CC", "OCC(O)CO", "C[C@H](N)C(=O)O", "F/C=C/F", "c1ccncc1C", "CCCCCCCC"]
VALID = [s for s in SMILES if s != "bad((smiles"]
TARGETS = ["gap", "homo"]
MC_SAMPLES = 256


def _artifact(root, name: str, **kw) -> str:
    cfg = JaxConfig(hidden_dim=32, embedding_dim=8, num_message_passing_layers=2, output_dim=2,
                    ffn_num_layers=2, task_type="multitask", **kw)
    batch = make_synthetic_batch(num_graphs=3, mean_atoms=8, num_hops=3, num_tasks=2, seed=0)
    params = JaxGNN(cfg).init(jax.random.PRNGKey(5), batch)
    pipe = PreprocessingPipeline(PreprocessingConfig(task_type="multitask"))
    pipe.fit([np.array([6, 1])] * 8, np.random.default_rng(0).normal(size=(8, 2)) * 3 + 1)
    path = str(root / f"{name}.npz")
    jax_save_artifact(path, params, cfg, pipe, extra={"target_columns": TARGETS, "max_hops": 3})
    return path


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_unc")
    csv = str(root / "mols.csv")
    pd.DataFrame({"smiles": SMILES}).to_csv(csv, index=False)
    return {
        "csv": csv,
        "no_dropout": _artifact(root, "nodrop", shell_conv_dropout=0.0, ffn_dropout=0.0),
        "dropout": _artifact(root, "drop", shell_conv_dropout=0.1, ffn_dropout=0.1),
        "evidential": _artifact(root, "evid", loss_function="evidential"),
    }


def _jax(path, batch_size: int = 4, smiles=VALID):
    art = jax_load_artifact(path)
    ds = JaxDataset.from_smiles(smiles, np.zeros((len(smiles), 2), np.float32), 3)
    loader = JaxLoader(ds, batch_size, fixed_shape=True)
    return JaxGNN(art.model_config), art.params, loader, art.pipeline


def _port(path, batch_size: int = 4, smiles=VALID):
    art = load_artifact(path)
    model = GNN(art.model_config)
    model.load_state_dict(params_from_flax(art.params))
    ds = MoleculeDataset.from_smiles(smiles, np.zeros((len(smiles), 2), np.float32), 3)
    return model.eval(), BatchLoader(ds, batch_size), art.pipeline


def test_evidential_matches_jax(artifacts):
    jm, jp, jl, jpipe = _jax(artifacts["evidential"])
    ref = jax_predict_evidential(jm, jp, jl, 2, pipeline=jpipe)
    model, loader, pipe = _port(artifacts["evidential"])
    got = predict_evidential(model, loader, "cpu", 2, pipeline=pipe)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=5e-4, atol=5e-5, err_msg=key)
    assert (got["aleatoric_uncertainty"] > 0).all() and (got["epistemic_uncertainty"] > 0).all()


def test_evidential_run_csv_matches_jax(artifacts, tmp_path):
    path, csv = artifacts["evidential"], artifacts["csv"]
    ref_path, out = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    JaxPipeline(artifact_path=path, inference_mode="evidential", chunk_size=5,
                batch_size=4).run_csv(csv, ref_path)
    summary = StreamingInferencePipeline(path, chunk_size=5, batch_size=4, device="cpu",
                                         inference_mode="evidential").run_csv(csv, out)
    assert summary["inference_mode"] == "evidential"
    got, ref = pd.read_csv(out), pd.read_csv(ref_path)
    extra = [t + s for s in ("_aleatoric", "_epistemic", "_total_uncertainty") for t in TARGETS]
    assert set(got.columns) == set(ref.columns) == {"smiles", *TARGETS, *extra}
    assert got["smiles"].tolist() == ref["smiles"].tolist()
    cols = TARGETS + extra
    np.testing.assert_allclose(got[cols].to_numpy(), ref[cols].to_numpy(), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("layout", ["binned", "flat"])
def test_mc_dropout_without_dropout_matches_jax(artifacts, layout):
    """Flat: a 272-atom alkane among the molecules sends the port's loader
    to the flat layout (the row-major training forward)."""
    smiles = VALID if layout == "binned" else VALID[:5] + ["C" * 90]
    jm, jp, jl, jpipe = _jax(artifacts["no_dropout"], smiles=smiles)
    ref = jax_predict_mc(jm, jp, jl, 2, pipeline=jpipe)
    model, loader, pipe = _port(artifacts["no_dropout"], smiles=smiles)
    assert loader.binned == (layout == "binned")
    got = predict_mc_dropout(model, loader, "cpu", 2, pipeline=pipe)
    np.testing.assert_allclose(got["predictions"], ref["predictions"], rtol=5e-4, atol=5e-5)
    assert got["uncertainty"].shape == ref["uncertainty"].shape
    assert np.array_equal(got["uncertainty"], np.zeros_like(got["uncertainty"]))


def test_mc_dropout_statistics_match_jax(artifacts):
    jm, jp, jl, jpipe = _jax(artifacts["dropout"], batch_size=16)  # one batch
    ref = jax_predict_mc(jm, jp, jl, MC_SAMPLES, rng=jax.random.PRNGKey(11), pipeline=jpipe)
    model, loader, pipe = _port(artifacts["dropout"], batch_size=16)
    gen = torch.Generator().manual_seed(11)
    got = predict_mc_dropout(model, loader, "cpu", MC_SAMPLES, generator=gen, pipeline=pipe)
    m_p, m_j = got["predictions"], ref["predictions"]
    s_p, s_j = got["uncertainty"], ref["uncertainty"]
    assert m_p.shape == m_j.shape == (len(VALID), 2)
    assert (s_p > 0).all() and (s_j > 0).all()
    mean_bound = 6 * np.sqrt((s_p**2 + s_j**2) / MC_SAMPLES)
    std_bound = 6 * np.sqrt((9 - 1) / (4 * MC_SAMPLES)) * np.maximum(s_p, s_j)
    print(f"max |dmean|/bound {np.max(np.abs(m_p - m_j) / mean_bound):.3f}, "
          f"max |dstd|/bound {np.max(np.abs(s_p - s_j) / std_bound):.3f}")  # -s shows it
    assert (np.abs(m_p - m_j) <= mean_bound).all()
    assert (np.abs(s_p - s_j) <= std_bound).all()


def test_mc_dropout_reruns_are_bit_equal(artifacts):
    model, loader, pipe = _port(artifacts["dropout"])
    runs = [predict_mc_dropout(model, loader, "cpu", 4, generator=torch.Generator().manual_seed(3),
                               pipeline=pipe) for _ in range(2)]
    runs += [predict_mc_dropout(model, loader, "cpu", 4, pipeline=pipe) for _ in range(2)]
    for a, b in (runs[:2], runs[2:]):
        assert all(np.array_equal(a[k], b[k]) for k in ("predictions", "uncertainty"))
    assert not np.array_equal(runs[0]["uncertainty"], runs[2]["uncertainty"])


def test_cli_mc_samples_selects_mc_dropout(artifacts, tmp_path):
    args = cli.parse_arguments(["--inference_csv", "x.csv", "--mc_samples", "4"])
    assert args.inference_mode == "mc_dropout"
    assert cli.parse_arguments(["--inference_csv", "x.csv"]).inference_mode == "deterministic"
    out = str(tmp_path / "mc.csv")
    summary = cli.main(["--inference_csv", artifacts["csv"], "--model_save_path",
                        artifacts["dropout"], "--inference_output", out, "--device", "cpu",
                        "--mc_samples", "4", "--num_workers", "2"])
    assert summary["inference_mode"] == "mc_dropout"
    got = pd.read_csv(out)
    assert list(got.columns) == ["smiles", *TARGETS, "gap_uncertainty", "homo_uncertainty"]
    assert len(got) == len(VALID) and (got[["gap_uncertainty", "homo_uncertainty"]] > 0).all().all()


def test_cli_evidential_writes_uncertainty_columns(artifacts, tmp_path):
    out = str(tmp_path / "evid.csv")
    cli.main(["--inference_csv", artifacts["csv"], "--model_save_path", artifacts["evidential"],
              "--inference_output", out, "--device", "cpu", "--inference_mode", "evidential"])
    got = pd.read_csv(out)
    for t in TARGETS:
        for s in ("_aleatoric", "_epistemic", "_total_uncertainty"):
            assert np.isfinite(got[t + s]).all() and (got[t + s] > 0).all()
        np.testing.assert_allclose(got[t + "_total_uncertainty"],
                                   got[t + "_aleatoric"] + got[t + "_epistemic"], rtol=1e-5)
    with pytest.raises(ValueError, match="evidential loss"):
        StreamingInferencePipeline(artifacts["dropout"], device="cpu", inference_mode="evidential")
