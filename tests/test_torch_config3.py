"""Config 3 of the PyTorch port (partial-charge equilibration and
stereochemistry, BASELINE.json config 3) against the JAX package on the CPU,
whose Pallas kernels run in interpret mode as its own tests run them.

- the serving forward of config 3 (both features: kernel 4 per layer), of
  charges only and stereo only (the injections then kernel 1d per layer) and
  of a 1-layer model (kernel 1d), against ``GNN.apply(deterministic=True)``
  on the same weights: predictions, molecule embeddings and partial charges;
- one config-3 train step (loss, every gradient, every parameter after the
  clip + Adam update) against the JAX ``make_train_step``, dropouts 0;
- ``extract_partial_charges`` against the JAX one; ``run_csv`` on a
  JAX-written config-3 artifact against the JAX pipeline; the CLI trains
  config 3 on the CPU, writes the charges file, and the JAX package reads
  the artifact and extracts the same charges.

The batches carry real stereo content (tetrahedral centres and cis/trans
bonds).  Tolerances: fp32 rtol 5e-4 / atol 5e-5 (both sides compute in fp32
and differ only in summation order); bf16 max|d|/max|ref| < 5e-2 (the two
frameworks round bf16 at the same points but sum in other orders).  Run
with ``-s`` to print the measured errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.checkpoint import save_artifact as jax_save_artifact
from aimnet_x2d_tpu.chem import compute_features as jax_features
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.data.binning import bin_pack_batch as jax_bin_pack
from aimnet_x2d_tpu.data.dataset import BatchLoader as JaxLoader
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.data.preprocessing import PreprocessingConfig, PreprocessingPipeline
from aimnet_x2d_tpu.inference.pipeline import StreamingInferencePipeline as JaxPipeline
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.training import trainer as jax_trainer
from aimnet_x2d_tpu.training.predictor import extract_partial_charges as jax_extract
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import (
    init_params,
    load_artifact,
    params_from_flax,
    params_to_flax,
)
from aimnet_x2d_tpu_torch.chem import compute_features
from aimnet_x2d_tpu_torch.data.batching import collate
from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.data.io import split_dataset
from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.training import trainer
from aimnet_x2d_tpu_torch.training.predictor import extract_partial_charges

torch.set_num_threads(1)

SMILES = ["C[C@H](N)C(=O)O", "F/C=C/F", "F/C=C\\Cl", "C[C@@H](O)CC", "CCO",
          "N[C@@H](C)C(=O)O", "C/C=C/C(=O)O", "O[C@H]1CC[C@@H](N)CC1", "c1ccccc1O",
          "Cl/C=C\\C[C@H](F)Br", "CC(=O)N", "OCC(O)CO"]
CONFIGS = {
    "config3": dict(use_partial_charges=True, use_stereochemistry=True),
    "charges": dict(use_partial_charges=True),
    "stereo": dict(use_stereochemistry=True),
    "one_layer": dict(num_message_passing_layers=1),
}
C3 = dict(use_partial_charges=True, use_stereochemistry=True)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for var in ("AIMNET_MP_MEGAKERNEL", "AIMNET_INJECT_FUSED", "AIMNET_WPOOL_KERNEL",
                "AIMNET_ATTNPOOL_KERNEL"):
        monkeypatch.setenv(var, "interpret")


def _tree(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _check(got, ref, dtype, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    print(f"{what} {dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / np.abs(ref).max():.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=what)
    else:
        assert err / np.abs(ref).max() < 5e-2, what


def _batches(targets):
    jb = jax_bin_pack(jax_collate([jax_features(s, 3) for s in SMILES], targets, num_hops=3),
                      ab=64, mb=16)
    pb = bin_pack_batch(collate([compute_features(s, 3) for s in SMILES], targets, num_hops=3),
                        ab=64, mb=16)
    assert pb.tet_mask.sum() >= 3 and pb.cis_mask.sum() >= 2 and pb.trans_mask.sum() >= 2
    return jb, pb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name, dtype):
    kw = dict(hidden_dim=40, embedding_dim=8, num_message_passing_layers=2, output_dim=3,
              ffn_num_layers=2, task_type="multitask", compute_dtype=dtype)
    kw.update(CONFIGS[name])
    jb, pb = _batches(np.zeros((len(SMILES), 3), np.float32))
    flat = init_params(GNNConfig(**kw), seed=4)
    ref = JaxGNN(JaxConfig(**kw)).apply(_tree(flat), jb, deterministic=True)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        out = model.eval()(pb.to("cpu"))
    gm, am = pb.graph_mask, pb.atom_mask
    _check(out.predictions.numpy()[gm], np.asarray(ref.predictions)[gm], dtype, f"{name} pred")
    _check(out.mol_embeddings.numpy()[gm], np.asarray(ref.mol_embeddings)[gm], dtype,
           f"{name} mol emb")
    if kw.get("use_partial_charges"):
        _check(out.partial_charges.numpy()[am], np.asarray(ref.partial_charges)[am], dtype,
               f"{name} charges")
    else:
        assert out.partial_charges is None and ref.partial_charges is None


def test_train_step_matches_jax():
    kw = dict(hidden_dim=40, embedding_dim=8, num_message_passing_layers=2, output_dim=3,
              ffn_num_layers=2, task_type="multitask", shell_conv_dropout=0.0, ffn_dropout=0.0,
              **C3)
    targets = np.random.default_rng(0).normal(size=(len(SMILES), 3)).astype(np.float32)
    jb, pb = _batches(targets)
    flat = init_params(GNNConfig(**kw), seed=6)
    lr = 1e-3
    jcfg = jax_trainer.TrainConfig(learning_rate=lr, loss_function="l1", task_type="multitask")
    jmodel = JaxGNN(JaxConfig(**kw))
    _, grads_ref = jax.value_and_grad(jax_trainer.make_loss_fn(jmodel, jcfg))(_tree(flat), jb)
    params = _tree(flat)  # the jitted step donates its params and optimizer state
    opt = jax_trainer.make_optimizer(jcfg)
    step = jax_trainer.make_train_step(jmodel, jcfg, opt)
    new_ref, _, loss_ref, _ = step(params, opt.init(params), jb, jnp.float32(lr),
                                   jax.random.PRNGKey(0))

    cfg = GNNConfig(**kw)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    opt_t = trainer.Optimizer(model.parameters(), 1.0)
    loss_fn = trainer.make_loss_fn(trainer.TrainConfig(loss_function="l1", task_type="multitask"))
    batch = pb.to("cpu")
    loss = loss_fn(model(batch, train=True).predictions, batch.targets, batch.graph_mask)
    loss.backward()
    print(f"loss port {loss.item():.7f} jax {float(loss_ref):.7f}")
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=5e-4, atol=5e-5)
    got_g = params_to_flax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                            for k, p in model.named_parameters()}, cfg)
    ref_g = _flat(grads_ref)
    assert set(got_g) == set(ref_g)
    assert np.abs(ref_g["params/stereochemical_embedding_2/kernel"]).max() > 0
    print(f"grads: worst max|d| {max(np.abs(got_g[k] - ref_g[k]).max() for k in ref_g):.2e}")
    for k in ref_g:
        np.testing.assert_allclose(got_g[k], ref_g[k], rtol=5e-4, atol=5e-5, err_msg=k)
    opt_t.step(lr)
    got_p = params_to_flax(model.state_dict(), cfg)
    for k, v in _flat(new_ref).items():
        np.testing.assert_allclose(got_p[k], v, rtol=5e-4, atol=5e-5, err_msg=k)


def test_params_round_trip_bit_for_bit():
    cfg = GNNConfig(hidden_dim=40, embedding_dim=8, num_message_passing_layers=3, output_dim=5,
                    **C3)
    flat = init_params(cfg, seed=3)
    assert flat["params/stereochemical_embedding_2/kernel"].shape == (36, 12)
    assert flat["params/stereochemical_embedding/kernel"].shape == (120, 40)
    back = params_to_flax(params_from_flax(flat), cfg)
    assert list(back) == list(flat)
    for k in flat:
        assert back[k].dtype == np.float32 and back[k].shape == flat[k].shape
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.fixture(scope="module")
def c3_artifact(tmp_path_factory):
    """A config-3 artifact written by the JAX package, and its SMILES CSV."""
    root = tmp_path_factory.mktemp("c3")
    cfg = JaxConfig(hidden_dim=40, embedding_dim=8, num_message_passing_layers=2, output_dim=2,
                    ffn_num_layers=2, task_type="multitask", **C3)
    params = JaxGNN(cfg).init(jax.random.PRNGKey(1), jax_collate(
        [jax_features(s, 3) for s in SMILES[:3]], np.zeros((3, 2), np.float32), num_hops=3))
    pipe = PreprocessingPipeline(PreprocessingConfig(task_type="multitask"))
    pipe.fit([np.array([6, 1])] * 8, np.random.default_rng(0).normal(size=(8, 2)) * 3 + 1)
    path = str(root / "c3.npz")
    jax_save_artifact(path, params, cfg, pipe, extra={"target_columns": ["a", "b"],
                                                      "max_hops": 3})
    csv = str(root / "mols.csv")
    pd.DataFrame({"smiles": SMILES}).to_csv(csv, index=False)
    return path, csv


def test_run_csv_on_a_jax_artifact_matches_jax_pipeline(c3_artifact, tmp_path):
    path, csv = c3_artifact
    ref, out = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    JaxPipeline(artifact_path=path, chunk_size=5, batch_size=4).run_csv(csv, ref)
    StreamingInferencePipeline(path, chunk_size=5, batch_size=4, device="cpu").run_csv(csv, out)
    g, r = pd.read_csv(out), pd.read_csv(ref)
    assert g["smiles"].tolist() == r["smiles"].tolist() and len(g) == len(SMILES)
    _check(g[["a", "b"]].to_numpy(), r[["a", "b"]].to_numpy(), "float32", "run_csv")


def _jax_charges(path, smiles):
    jart = jax_load_artifact(path)
    jds = JaxDataset.from_smiles(smiles, np.zeros((len(smiles), 1), np.float32), 3)
    return jax_extract(JaxGNN(jart.model_config), jart.params,
                       JaxLoader(jds, 4, fixed_shape=True, binned=True))


def test_extract_partial_charges_matches_jax(c3_artifact):
    path, _ = c3_artifact
    q_ref, idx_ref = _jax_charges(path, SMILES)
    art = load_artifact(path)
    model = GNN(art.model_config)
    model.load_state_dict(params_from_flax(art.params))
    ds = MoleculeDataset.from_smiles(SMILES, np.zeros((len(SMILES), 1), np.float32), 3)
    q, idx = extract_partial_charges(model.eval(), BatchLoader(ds, 4), "cpu")
    np.testing.assert_array_equal(idx, idx_ref)
    assert idx[-1] == len(SMILES) - 1 and (np.diff(idx) >= 0).all()
    _check(q, q_ref, "float32", "partial charges")


def test_cli_trains_config3_and_writes_charges(tmp_path):
    rng = np.random.default_rng(1)
    smiles = SMILES * 4
    n_atoms = np.array([compute_features(s, 3).num_atoms for s in smiles], np.float32)
    df = pd.DataFrame({"smiles": smiles, "a": n_atoms * 0.5 + rng.normal(size=len(smiles)) * 0.1,
                       "b": -n_atoms + rng.normal(size=len(smiles)) * 0.1})
    csv = str(tmp_path / "train.csv")
    df.to_csv(csv, index=False)
    path, charges = str(tmp_path / "c3.npz"), str(tmp_path / "charges.npz")
    summary = cli.main([
        "--data_path", csv, "--multi_target_columns", "a,b", "--task_type", "multitask",
        "--epochs", "2", "--batch_size", "8", "--hidden_dim", "32", "--embedding_dim", "8",
        "--num_message_passing_layers", "2", "--ffn_num_layers", "2", "--learning_rate", "3e-3",
        "--use_partial_charges", "--use_stereochemistry", "--output_partial_charges", charges,
        "--model_save_path", path, "--device", "cpu", "--seed", "2", "--test_split", "0.25",
        "--train_split", "0.65"])
    hist = summary["history"]
    print("train losses", [h["train_loss"] for h in hist])
    assert len(hist) == 2 and hist[1]["train_loss"] < hist[0]["train_loss"]
    art = jax_load_artifact(path)
    assert art.model_config.use_partial_charges and art.model_config.use_stereochemistry
    # the test split, rebuilt as the runner split it; JAX extracts from the
    # port's artifact in batches of the same size and composition
    (_, _), (_, _), (te_s, _) = split_dataset(smiles, df[["a", "b"]].to_numpy(np.float32), 0.65,
                                              0.1, 0.25, seed=2)
    with np.load(charges) as f:
        assert sorted(f.files) == ["charges", "molecule_index"]
        q, idx = f["charges"], f["molecule_index"]
    jart = jax_load_artifact(path)
    jds = JaxDataset.from_smiles(te_s, np.zeros((len(te_s), 1), np.float32), 3)
    q_ref, idx_ref = jax_extract(JaxGNN(jart.model_config), jart.params,
                                 JaxLoader(jds, 8, fixed_shape=True, binned=True))
    np.testing.assert_array_equal(idx, idx_ref)
    assert idx.dtype == idx_ref.dtype and q.shape == q_ref.shape
    _check(q, q_ref, "float32", "CLI charges")
