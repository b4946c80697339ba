"""The flat (non-binned) layout of the PyTorch port against the JAX package,
on the CPU.  A batch goes flat when one of its molecules is larger than a
256-atom bin; here "C" * 90 (272 atoms with hydrogens) forces it.

- the loader: flat by default for such a dataset, with the JAX loader's slot
  shapes and both edge layouts; datasets that fit stay binned;
- the model's serving forward against ``GNN.apply`` on the same collated
  flat batch, the JAX side with ``attach_fused_layouts`` so that its kernel
  7 runs in interpret mode: attention, mean, sum and max pooling, fp32 and
  bf16, and models without message passing (flat and binned);
- one train step on a flat batch against the JAX train step: loss, every
  gradient and every parameter after clip + Adam (dropouts 0);
- serving: ``run_csv`` on a JAX-written artifact over a CSV with one such
  molecule against the JAX pipeline, and the port's CLI training and
  serving such a CSV.

Bars: fp32 rtol 5e-4 / atol 5e-5; bf16 max|d|/max|ref| < 5e-2 (the repo's
bars, tests/test_torch_model.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu.checkpoint import save_artifact as jax_save_artifact
from aimnet_x2d_tpu.chem import compute_features as jax_features
from aimnet_x2d_tpu.data.batching import attach_fused_layouts
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.data.binning import bin_pack_batch as jax_bin_pack
from aimnet_x2d_tpu.data.dataset import BatchLoader as JaxLoader
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.data.preprocessing import PreprocessingConfig, PreprocessingPipeline
from aimnet_x2d_tpu.inference.pipeline import StreamingInferencePipeline as JaxPipeline
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.training import trainer as jax_trainer
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.chem import compute_features
from aimnet_x2d_tpu_torch.data.batching import MolBatch, attach_flat_layouts, collate
from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.training import trainer

torch.set_num_threads(1)

BIG = "C" * 90  # 272 atoms with hydrogens
SMILES = ["CCO", "c1ccccc1O", "CC(=O)N", BIG, "C1CCC(CC1)OC#N", "CC(C)(F)F", "N#CC=CC",
          "OCC(O)CO", "C[C@H](N)C(=O)O", "F/C=C/F"]


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


@pytest.fixture(scope="module")
def batches():
    """(JAX flat batch with its kernel-7 layouts, the port's flat batch on
    the CPU), the same collated arrays; targets random."""
    targets = np.random.default_rng(0).normal(size=(len(SMILES), 2)).astype(np.float32)
    jb = attach_fused_layouts(jax_collate([jax_features(s, 3) for s in SMILES], targets,
                                          num_hops=3))
    assert jb.fused_fwd is not None  # otherwise JAX silently runs its XLA segment sum
    pb = attach_flat_layouts(collate([compute_features(s, 3) for s in SMILES], targets,
                                     num_hops=3))
    assert pb.bin_adj is None and pb.pool_mat is None
    return jb, pb.to("cpu")


def _kw(**kw):
    base = dict(hidden_dim=48, embedding_dim=8, num_message_passing_layers=2, output_dim=2,
                num_shells=3, ffn_num_layers=3, task_type="multitask")
    base.update(kw)
    return base


def _forward(kw, jb, pb, seed=7):
    flat = init_params(GNNConfig(**kw), seed=seed)
    ref = JaxGNN(JaxConfig(**kw)).apply(_tree(flat), jb, deterministic=True)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        out = model.eval()(pb, atom_embeddings=True)
    return out, ref


def _compare(out, ref, pb, dtype, pooling):
    gm, am = np.asarray(pb.graph_mask), np.asarray(pb.atom_mask)
    _check(out.predictions.numpy()[gm], np.asarray(ref.predictions)[gm], dtype, "predictions")
    _check(out.mol_embeddings.numpy()[gm], np.asarray(ref.mol_embeddings, np.float32)[gm], dtype,
           "mol emb")
    _check(out.atom_embeddings.numpy()[am], np.asarray(ref.atom_embeddings)[am], dtype, "atom emb")
    if pooling == "attention":
        _check(out.attention_weights.numpy(), np.asarray(ref.attention_weights), dtype, "attention")
    else:
        assert out.attention_weights is None and ref.attention_weights is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooling", ["attention", "mean", "sum", "max"])
def test_flat_forward_matches_jax(batches, pooling, dtype):
    jb, pb = batches
    out, ref = _forward(_kw(pooling_type=pooling, compute_dtype=dtype), jb, pb)
    _compare(out, ref, pb, dtype, pooling)


@pytest.mark.parametrize("layout", ["flat", "binned"])
def test_model_without_message_passing_matches_jax(batches, layout):
    """num_message_passing_layers=0: the flat route, and on binned batches
    the feature-major path with the stack skipped (JAX runs its row-major
    binned path there)."""
    jb, pb = batches
    if layout == "binned":
        small = [s for s in SMILES if s != BIG]
        t = np.zeros((len(small), 2), np.float32)
        jb = jax_bin_pack(jax_collate([jax_features(s, 3) for s in small], t, num_hops=3),
                          ab=64, mb=16)
        pb = bin_pack_batch(collate([compute_features(s, 3) for s in small], t, num_hops=3),
                            ab=64, mb=16).to("cpu")
    out, ref = _forward(_kw(num_message_passing_layers=0), jb, pb)
    _compare(out, ref, pb, "float32", "attention")


def test_one_train_step_on_a_flat_batch_matches_jax(batches):
    """fp32, dropouts 0, the global-norm clip binding: loss, every gradient
    (kernel 7's backward in each layer) and every updated parameter."""
    jb, pb = batches
    clip, lr = 1e-3, 1e-3
    kw = _kw(shell_conv_dropout=0.0, ffn_dropout=0.0)
    flat = init_params(GNNConfig(**kw), seed=5)
    jcfg = jax_trainer.TrainConfig(learning_rate=lr, loss_function="l1", grad_clip=clip,
                                   task_type="multitask")
    jmodel = JaxGNN(JaxConfig(**kw))
    params = _tree(flat)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jax_trainer.make_loss_fn(jmodel, jcfg)(p, jb)))(params)
    opt = jax_trainer.make_optimizer(jcfg)
    step = jax_trainer.make_train_step(jmodel, jcfg, opt)
    new_ref, _, step_loss, _ = step(params, opt.init(params), jb, jnp.float32(lr),
                                    jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(step_loss), float(loss_ref), rtol=1e-6)

    cfg = GNNConfig(**kw)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    tcfg = trainer.TrainConfig(grad_clip=clip, task_type="multitask")
    opt_t = trainer.make_optimizer(model, tcfg)
    out = model(pb, train=True)
    loss = trainer.make_loss_fn(tcfg)(out.predictions, pb.targets, pb.graph_mask)
    loss.backward()
    loss = float(loss.detach())
    print(f"flat step: loss port {loss:.7f} jax {float(loss_ref):.7f}")
    np.testing.assert_allclose(loss, float(loss_ref), rtol=5e-4, atol=5e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    got_g, ref_g = params_to_flax(grads, cfg), _flat(grads_ref)
    assert set(got_g) == set(ref_g)
    worst = max(float(np.abs(got_g[k] - ref_g[k]).max()) for k in ref_g)
    print(f"flat step: grads worst max|d| {worst:.2e}")
    for k in ref_g:
        np.testing.assert_allclose(got_g[k], ref_g[k], rtol=5e-4, atol=5e-5, err_msg=k)
    # the layers' gradients reach the aggregation's input through its backward
    assert np.abs(got_g["params/message_passing_layers_0/input_proj_kernel"]).max() > 0
    norm = opt_t.step(lr)
    gnorm_ref = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in ref_g.values())))
    np.testing.assert_allclose(float(norm), gnorm_ref, rtol=5e-4)
    assert gnorm_ref > clip  # the clip binds
    got_p, ref_p = params_to_flax(model.state_dict(), cfg), _flat(new_ref)
    for k in ref_p:
        np.testing.assert_allclose(got_p[k], ref_p[k], rtol=5e-4, atol=5e-5, err_msg=k)


def test_training_dropout_on_the_flat_layout_needs_a_generator(batches):
    _, pb = batches
    cfg = GNNConfig(**_kw(ffn_dropout=0.0))
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed=0)))
    with pytest.raises(ValueError, match="generator"):
        model(pb, train=True)
    gen = torch.Generator().manual_seed(0)
    a = model(pb, train=True, generator=gen).predictions
    b = model(pb, train=True, generator=gen).predictions
    with torch.inference_mode():
        c = model(pb).predictions
    assert not torch.equal(a, b) and not torch.equal(a, c)  # the layers' masks differ per call


def test_loader_goes_flat_when_a_molecule_exceeds_a_bin():
    t = np.arange(2 * len(SMILES), dtype=np.float32).reshape(-1, 2)
    ds = MoleculeDataset.from_smiles(SMILES, t, max_hops=3)
    loader = BatchLoader(ds, batch_size=4)
    assert loader.binned is False
    loader.warm_bin_pins()  # nothing to plan on a flat loader
    batches = list(loader)
    jloader = JaxLoader(JaxDataset.from_smiles(SMILES, t, 3), 4)
    assert jloader.binned is False
    for got, want in zip(batches, jloader):
        assert got.bin_adj is None and got.pool_mat is None and got.tet_bin is None
        for f in dataclasses.fields(MolBatch):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        fwd, bwd = got.fused_fwd, got.fused_bwd
        n_real = int(got.edge_mask.sum())
        assert fwd.num_rows == bwd.num_rows == got.num_atom_slots
        assert fwd.num_edges == bwd.num_edges == n_real
    slots = {}
    loader.pin_slots(slots)
    assert "bins" not in slots and slots["atom_slots"] == batches[0].num_atom_slots
    assert len({b.num_atom_slots for b in batches}) == 1
    small = MoleculeDataset.from_smiles(SMILES[:3], t[:3], max_hops=3)
    small_loader = BatchLoader(small, 4)
    assert small_loader.binned is True
    assert next(iter(small_loader)).fused_fwd is None


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_flat")
    kw = dict(hidden_dim=40, embedding_dim=8, num_message_passing_layers=2, output_dim=2,
              ffn_num_layers=2, task_type="multitask")
    params = _tree(init_params(GNNConfig(**kw), seed=3))
    pipe = PreprocessingPipeline(PreprocessingConfig(task_type="multitask"))
    pipe.fit([np.array([6, 1])] * 8, np.random.default_rng(0).normal(size=(8, 2)) * 3 + 1)
    path = str(root / "model.npz")
    jax_save_artifact(path, params, JaxConfig(**kw), pipe,
                      extra={"target_columns": ["gap", "homo"], "max_hops": 3})
    csv = str(root / "mols.csv")
    pd.DataFrame({"smiles": SMILES + ["bad((smiles"]}).to_csv(csv, index=False)
    ref = str(root / "jax.csv")
    JaxPipeline(artifact_path=path, chunk_size=6, batch_size=4).run_csv(csv, ref)
    return path, csv, pd.read_csv(ref)


def test_run_csv_serves_a_large_molecule_as_jax_does(artifact, tmp_path):
    """Chunks of 6: the port serves the chunk with the 272-atom molecule on
    the flat layout and the other binned (the JAX pipeline on the CPU runs
    both flat)."""
    path, csv, ref = artifact
    out = str(tmp_path / "port.csv")
    summary = StreamingInferencePipeline(path, chunk_size=6, batch_size=4, device="cpu").run_csv(
        csv, out)
    assert summary["valid_molecules"] == len(SMILES)
    got = pd.read_csv(out)
    assert got["smiles"].tolist() == ref["smiles"].tolist()  # the 272-atom molecule included
    g, r = got[["gap", "homo"]].to_numpy(), ref[["gap", "homo"]].to_numpy()
    print(f"run_csv with a {len(BIG)}-carbon chain: max|d| {np.abs(g - r).max():.2e}, "
          f"max|d|/max|ref| {np.abs(g - r).max() / np.abs(r).max():.2e}")
    np.testing.assert_allclose(g, r, rtol=5e-4, atol=5e-5)


def test_cli_trains_and_serves_a_csv_with_a_large_molecule(tmp_path):
    rng = np.random.default_rng(1)
    smiles = (SMILES * 3)[:24]
    df = pd.DataFrame({"smiles": smiles, "y": rng.normal(size=len(smiles))})
    csv = str(tmp_path / "train.csv")
    df.to_csv(csv, index=False)
    art = str(tmp_path / "model.npz")
    summary = cli.main(["--data_path", csv, "--target_column", "y", "--epochs", "2",
                        "--batch_size", "8", "--hidden_dim", "32", "--embedding_dim", "8",
                        "--num_message_passing_layers", "2", "--model_save_path", art,
                        "--device", "cpu"])
    assert len(summary["history"]) == 2
    assert np.isfinite([h["train_loss"] for h in summary["history"]]).all()
    out = str(tmp_path / "preds.csv")
    cli.main(["--inference_csv", csv, "--model_save_path", art, "--inference_output", out,
              "--device", "cpu"])
    preds = pd.read_csv(out)
    assert len(preds) == len(smiles) and np.isfinite(preds["y"]).all()
