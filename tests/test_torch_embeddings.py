"""Embedding output of the port (``--save_embeddings``) against the JAX
package, on the CPU, from one artifact (random weights from
``init_params``):

- serving: the ``StreamingEmbeddingWriter`` file of a CSV, with atom
  embeddings, equals JAX's dataset for dataset (``mol_embeddings`` and
  ``atom_embeddings`` within the fp32 bar, rtol 5e-4 / atol 5e-5;
  ``smiles`` and ``atom_offsets`` equal), and its predictions are those of
  serving without embeddings;
- two ranks in sequence (rank 0 last: it merges, as under torchrun) give
  the one-rank file, and leave no rank file;
- after training: ``runner.extract_embeddings`` writes JAX's
  ``_extract_embeddings`` file (a group per split, ``atom_mol_index``);
- MC-dropout and evidential serving write no embeddings, as in JAX.
"""

import argparse
import os

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu import runner as jax_runner
from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.inference.pipeline import StreamingInferencePipeline as JaxPipeline
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu_torch import runner
from aimnet_x2d_tpu_torch.checkpoint import (init_params, load_artifact, params_from_flax,
                                             save_artifact)
from aimnet_x2d_tpu_torch.data.dataset import MoleculeDataset
from aimnet_x2d_tpu_torch.data.preprocessing import PreprocessingConfig, PreprocessingPipeline
from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig

torch.set_num_threads(1)

SMILES = ["CCO", "c1ccccc1O", "CC(=O)N", "C[C@H](N)C(=O)O", "F/C=C/F", "OCC(O)CO", "CC#N",
          "c1ccncc1C", "CCCCCCCC", "CC(C)O", "bad(", "NC(=O)N", "ClC(Cl)Cl"] * 3
FP32 = dict(rtol=5e-4, atol=5e-5)


def _artifact(path, **kw):
    cfg = GNNConfig(hidden_dim=32, output_dim=2, num_shells=2, num_message_passing_layers=2,
                    embedding_dim=8, ffn_num_layers=2, task_type="multitask", **kw)
    pipe = PreprocessingPipeline(PreprocessingConfig(task_type="multitask"))
    pipe.fit([np.array([6, 1, 8])] * 6, np.random.default_rng(0).normal(size=(6, 2)))
    save_artifact(path, init_params(cfg, seed=9), cfg, pipe,
                  extra={"target_columns": ["a", "b"], "max_hops": 2})
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("emb")
    csv = str(d / "mols.csv")
    pd.DataFrame({"smiles": SMILES}).to_csv(csv, index=False)
    return dict(dir=d, csv=csv, model=_artifact(str(d / "m.npz")),
                evidential=_artifact(str(d / "e.npz"), loss_function="evidential"))


def _port(path, emb, mode="deterministic", mc=0):
    return StreamingInferencePipeline(path, chunk_size=10, batch_size=4, device="cpu",
                                      inference_mode=mode, mc_samples=mc, save_embeddings=True,
                                      embeddings_output_path=emb, include_atom_embeddings=True)


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][...] for k in f}


def _assert_same_file(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if v.dtype.kind in "fc":
            np.testing.assert_allclose(got[k], v, err_msg=k, **FP32)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_serving_embeddings_match_jax_and_leave_predictions_alone(data):
    d = data["dir"]
    emb, jemb = str(d / "port.h5"), str(d / "jax.h5")
    out = str(d / "p.csv")
    res = _port(data["model"], emb).run_csv(data["csv"], out)
    assert res["valid_molecules"] == len(SMILES) - 3
    JaxPipeline(artifact_path=data["model"], chunk_size=10, batch_size=4, save_embeddings=True,
                embeddings_output_path=jemb, include_atom_embeddings=True).run_csv(
        data["csv"], str(d / "j.csv"))
    got, want = _read(emb), _read(jemb)
    assert sorted(got) == ["atom_embeddings", "atom_offsets", "mol_embeddings", "smiles"]
    assert got["mol_embeddings"].shape == (res["valid_molecules"], 32)
    assert got["atom_offsets"][-1] == len(got["atom_embeddings"])
    _assert_same_file(got, want)
    plain = str(d / "plain.csv")
    StreamingInferencePipeline(data["model"], chunk_size=10, batch_size=4,
                               device="cpu").run_csv(data["csv"], plain)
    pd.testing.assert_frame_equal(pd.read_csv(out), pd.read_csv(plain))


def test_two_ranks_merge_to_the_one_rank_file(data):
    d = data["dir"]
    one, merged = str(d / "one.h5"), str(d / "merged.h5")
    _port(data["model"], one).run_csv(data["csv"], str(d / "one.csv"))
    for h in (1, 0):
        _port(data["model"], merged).run_csv(data["csv"], str(d / "merged.csv"), host_id=h,
                                             num_hosts=2)
    assert not os.path.exists(merged + ".rank0") and not os.path.exists(merged + ".rank1")
    _assert_same_file(_read(merged), _read(one))


@pytest.mark.parametrize("mode", ["mc_dropout", "evidential"])
def test_uncertainty_serving_writes_no_embeddings(data, mode):
    emb = str(data["dir"] / f"{mode}.h5")
    path = data["evidential"] if mode == "evidential" else data["model"]
    res = _port(path, emb, mode, 2 if mode == "mc_dropout" else 0).run_csv(
        data["csv"], str(data["dir"] / f"{mode}.csv"))
    assert res["valid_molecules"] == len(SMILES) - 3
    assert _read(emb) == {}


def test_training_embeddings_match_jax(data):
    d = data["dir"]
    smiles = [s for s in SMILES if s != "bad("][:20]
    splits = {"train": smiles[:12], "val": smiles[12:16], "test": smiles[16:]}
    args = argparse.Namespace(embeddings_output_path=str(d / "train_port.h5"), batch_size=4,
                              include_atom_embeddings=True)
    art = load_artifact(data["model"])
    model = GNN(art.model_config)
    model.load_state_dict(params_from_flax(art.params))
    model.eval()
    zeros = (lambda s: np.zeros((len(s), 2), np.float32))
    runner.extract_embeddings(args, model, torch.device("cpu"),
                              [(k, MoleculeDataset.from_smiles(s, zeros(s), 2))
                               for k, s in splits.items()])
    jart = jax_load_artifact(data["model"])
    jargs = argparse.Namespace(**{**vars(args),
                                  "embeddings_output_path": str(d / "train_jax.h5")})
    jax_runner._extract_embeddings(jargs, JaxGNN(jart.model_config), jart.params,
                                   [(k, JaxDataset.from_smiles(s, zeros(s), 2))
                                    for k, s in splits.items()])
    with h5py.File(args.embeddings_output_path) as f, h5py.File(jargs.embeddings_output_path) as g:
        assert sorted(f) == sorted(g) == ["test", "train", "val"]
        for name in f:
            assert sorted(f[name]) == ["atom_embeddings", "atom_mol_index", "mol_embeddings",
                                       "smiles"]
            _assert_same_file({k: f[name][k][...] for k in f[name]},
                              {k: g[name][k][...] for k in g[name]})


def test_csv_path_needs_no_h5py(data, tmp_path):
    """Where ``h5py`` is missing (the card's machine), the CLI, the runner,
    the serving pipeline and engine and the search import, and
    ``--inference_csv`` serves: only the HDF5 and embedding paths import it."""
    import subprocess
    import sys

    out = str(tmp_path / "p.csv")
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import aimnet_x2d_tpu_torch.cli as cli, aimnet_x2d_tpu_torch.runner\n"
        "import aimnet_x2d_tpu_torch.inference.pipeline, aimnet_x2d_tpu_torch.inference.engine\n"
        "import aimnet_x2d_tpu_torch.hyperopt\n"
        f"s = cli.main(['--inference_csv', {data['csv']!r}, '--model_save_path', "
        f"{data['model']!r}, '--inference_output', {out!r}, '--device', 'cpu'])\n"
        "assert 'h5py' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print('served', s['valid_molecules'])\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert f"served {len(SMILES) - 3}" in p.stdout
    assert len(pd.read_csv(out)) == len(SMILES) - 3
