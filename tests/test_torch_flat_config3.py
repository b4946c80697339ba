"""Config 3 (partial-charge equilibration and stereochemistry) of the
PyTorch port on the flat layout against the JAX package, on the CPU.  A
batch goes flat when one of its molecules is larger than a 256-atom bin;
here "C" * 90 (272 atoms with hydrogens) forces it, beside molecules with
tetrahedral centres and cis/trans bonds.  The injections run row-major with
their segment branches before every layer, whose aggregation is kernel 7
(the JAX side with ``attach_fused_layouts``, interpret mode) or, under true
per-hop aggregation, the per-hop sums.

- the serving forward of config 3, charges only and stereo only, and of
  config 3 with per-hop aggregation, fp32 and bf16, against ``GNN.apply``:
  predictions, molecule and atom embeddings, partial charges;
- one train step of each (loss, every gradient, every parameter after the
  clip + Adam update; dropouts 0);
- ``extract_partial_charges`` over a flat loader against the JAX one, and
  the CLI training config 3 on a dataset that goes flat with
  ``--output_partial_charges``, whose charges JAX extracts alike from the
  artifact.

Bars: fp32 rtol 5e-4 / atol 5e-5; bf16 max|d|/max|ref| < 5e-2 (the repo's
bars, tests/test_torch_model.py).  Run with ``-s`` to print the errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.chem import compute_features as jax_features
from aimnet_x2d_tpu.data.batching import attach_fused_layouts
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.data.dataset import BatchLoader as JaxLoader
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.training import trainer as jax_trainer
from aimnet_x2d_tpu.training.predictor import extract_partial_charges as jax_extract
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.chem import compute_features
from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts, collate
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.data.io import split_dataset
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.training import trainer
from aimnet_x2d_tpu_torch.training.predictor import extract_partial_charges

torch.set_num_threads(1)

BIG = "C" * 90
SMILES = ["C[C@H](N)C(=O)O", "F/C=C/F", "F/C=C\\Cl", BIG, "C[C@@H](O)CC", "CCO",
          "N[C@@H](C)C(=O)O", "C/C=C/C(=O)O", "O[C@H]1CC[C@@H](N)CC1", "Cl/C=C\\C[C@H](F)Br"]
C3 = dict(use_partial_charges=True, use_stereochemistry=True)
CONFIGS = {
    "config3": C3,
    "charges": dict(use_partial_charges=True),
    "stereo": dict(use_stereochemistry=True),
    "config3-multihop": dict(C3, parity_mode=False),
}


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
    err = float(np.abs(got - ref).max())
    print(f"{what} {dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / np.abs(ref).max():.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=what)
    else:
        assert err / np.abs(ref).max() < 5e-2, what


def _check_update(got_p, ref_p, ref_g, lr):
    """Parameters after the step, to the fp32 bar; where the reference
    gradient is zero up to fp32 rounding (|g| <= 1e-7: an L1 loss whose
    signs cancel, a softmax bias), Adam's first step lr g / (|g| + eps) turns
    either side's rounding residue into a move of up to lr, so those
    elements are held to lr + atol."""
    for k, v in ref_p.items():
        zero = np.abs(ref_g[k]) <= 1e-7
        np.testing.assert_allclose(got_p[k][~zero], v[~zero], rtol=5e-4, atol=5e-5, err_msg=k)
        assert np.all(np.abs(got_p[k][zero] - v[zero]) <= lr + 5e-5), k


def _kw(**kw):
    base = dict(hidden_dim=40, embedding_dim=8, num_message_passing_layers=2, output_dim=2,
                num_shells=3, ffn_num_layers=2, task_type="multitask")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def batches():
    t = np.random.default_rng(0).normal(size=(len(SMILES), 2)).astype(np.float32)
    jb = attach_fused_layouts(jax_collate([jax_features(s, 3) for s in SMILES], t, num_hops=3))
    assert jb.fused_fwd is not None
    pb = attach_flat_layouts(collate([compute_features(s, 3) for s in SMILES], t, num_hops=3))
    assert pb.pool_mat is None and pb.tet_mask.sum() >= 3
    assert pb.cis_mask.sum() >= 2 and pb.trans_mask.sum() >= 2
    return jb, pb.to("cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_flat_config3_forward_matches_jax(batches, name, dtype):
    jb, pb = batches
    kw = _kw(compute_dtype=dtype, **CONFIGS[name])
    flat = init_params(GNNConfig(**kw), seed=4)
    ref = JaxGNN(JaxConfig(**kw)).apply(_tree(flat), jb, deterministic=True)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        out = model.eval()(pb, atom_embeddings=True)
    gm, am = np.asarray(pb.graph_mask), np.asarray(pb.atom_mask)
    _check(out.predictions.numpy()[gm], np.asarray(ref.predictions)[gm], dtype, "predictions")
    _check(out.mol_embeddings.numpy()[gm], np.asarray(ref.mol_embeddings, np.float32)[gm], dtype,
           "mol emb")
    _check(out.atom_embeddings.numpy()[am], np.asarray(ref.atom_embeddings)[am], dtype, "atom emb")
    _check(out.attention_weights.numpy(), np.asarray(ref.attention_weights), dtype, "attention")
    if kw.get("use_partial_charges"):
        _check(out.partial_charges.numpy()[am], np.asarray(ref.partial_charges, np.float32)[am],
               dtype, "charges")
    else:
        assert out.partial_charges is None and ref.partial_charges is None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_flat_config3_train_step_matches_jax(batches, name):
    jb, pb = batches
    lr, clip = 1e-3, 1.0
    kw = _kw(shell_conv_dropout=0.0, ffn_dropout=0.0, **CONFIGS[name])
    flat = init_params(GNNConfig(**kw), seed=6)
    jcfg = jax_trainer.TrainConfig(learning_rate=lr, loss_function="l1", grad_clip=clip,
                                   task_type="multitask")
    jmodel = JaxGNN(JaxConfig(**kw))
    loss_ref, grads_ref = jax.value_and_grad(jax_trainer.make_loss_fn(jmodel, jcfg))(_tree(flat), jb)
    params = _tree(flat)
    opt = jax_trainer.make_optimizer(jcfg)
    new_ref, _, _, _ = jax_trainer.make_train_step(jmodel, jcfg, opt)(
        params, opt.init(params), jb, jnp.float32(lr), jax.random.PRNGKey(0))

    cfg = GNNConfig(**kw)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    tcfg = trainer.TrainConfig(grad_clip=clip, task_type="multitask")
    opt_t = trainer.make_optimizer(model, tcfg)
    loss = trainer.make_loss_fn(tcfg)(model(pb, train=True).predictions, pb.targets, pb.graph_mask)
    loss.backward()
    loss = float(loss.detach())
    print(f"{name} flat step: loss port {loss:.7f} jax {float(loss_ref):.7f}")
    np.testing.assert_allclose(loss, float(loss_ref), rtol=5e-4, atol=5e-5)
    got_g = params_to_flax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                            for k, p in model.named_parameters()}, cfg)
    ref_g = _flat(grads_ref)
    assert set(got_g) == set(ref_g)
    print(f"{name} flat step: grads worst max|d| "
          f"{max(np.abs(got_g[k] - ref_g[k]).max() for k in ref_g):.2e}")
    for k in ref_g:
        np.testing.assert_allclose(got_g[k], ref_g[k], rtol=5e-4, atol=5e-5, err_msg=k)
    if cfg.use_stereochemistry:
        assert np.abs(got_g["params/stereochemical_embedding_2/kernel"]).max() > 0
    opt_t.step(lr)
    _check_update(params_to_flax(model.state_dict(), cfg), _flat(new_ref), ref_g, lr)


def test_extract_partial_charges_on_flat_batches_matches_jax():
    kw = _kw(**C3)
    flat = init_params(GNNConfig(**kw), seed=2)
    jds = JaxDataset.from_smiles(SMILES, np.zeros((len(SMILES), 1), np.float32), 3)
    jloader = JaxLoader(jds, 4)
    assert not jloader.binned
    q_ref, idx_ref = jax_extract(JaxGNN(JaxConfig(**kw)), _tree(flat), jloader)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat))
    ds = MoleculeDataset.from_smiles(SMILES, np.zeros((len(SMILES), 1), np.float32), 3)
    loader = BatchLoader(ds, 4)
    assert not loader.binned
    q, idx = extract_partial_charges(model.eval(), loader, "cpu")
    np.testing.assert_array_equal(idx, idx_ref)
    assert idx[-1] == len(SMILES) - 1 and (np.diff(idx) >= 0).all()
    _check(q, q_ref, "float32", "flat partial charges")


def test_cli_trains_config3_on_a_flat_dataset_and_writes_charges(tmp_path):
    rng = np.random.default_rng(1)
    smiles = SMILES * 3
    df = pd.DataFrame({"smiles": smiles, "a": rng.normal(size=len(smiles)),
                       "b": rng.normal(size=len(smiles))})
    csv = str(tmp_path / "train.csv")
    df.to_csv(csv, index=False)
    path, charges = str(tmp_path / "c3.npz"), str(tmp_path / "charges.npz")
    summary = cli.main([
        "--data_path", csv, "--multi_target_columns", "a,b", "--task_type", "multitask",
        "--epochs", "2", "--batch_size", "8", "--hidden_dim", "32", "--embedding_dim", "8",
        "--num_message_passing_layers", "2", "--ffn_num_layers", "2",
        "--use_partial_charges", "--use_stereochemistry", "--output_partial_charges", charges,
        "--model_save_path", path, "--device", "cpu", "--seed", "2", "--test_split", "0.3",
        "--train_split", "0.6"])
    assert np.isfinite(summary["test_metrics"]["mae"])
    (_, _), (_, _), (te_s, _) = split_dataset(smiles, df[["a", "b"]].to_numpy(np.float32), 0.6,
                                              0.1, 0.3, seed=2)
    assert BIG in te_s  # the test split goes flat
    with np.load(charges) as f:
        q, idx = f["charges"], f["molecule_index"]
    jart = jax_load_artifact(path)
    jds = JaxDataset.from_smiles(te_s, np.zeros((len(te_s), 1), np.float32), 3)
    q_ref, idx_ref = jax_extract(JaxGNN(jart.model_config), jart.params, JaxLoader(jds, 8))
    np.testing.assert_array_equal(idx, idx_ref)
    _check(q, q_ref, "float32", "CLI flat charges")
