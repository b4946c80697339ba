"""The port's training path against the JAX package's, on the CPU.

- one full train step (training forward through the plain versions of the
  kernels, loss, backward, global-norm clip, Adam) against the JAX
  ``trainer.make_train_step`` from the same parameters and batch, dropouts
  0, with the JAX fused kernels in interpret mode: the loss, every
  gradient (under its flax name) and every parameter after the update, in
  fp32 at rtol 5e-4 / atol 5e-5; once with the clip binding;
- the host pieces: scheduler LR sequences, the preprocessing fit/transform,
  ``split_dataset``, a shuffled loader's batch order, ``evaluate``;
- the CLI end to end: two epochs on an in-script CSV on the CPU, the loss
  falls, the artifact loads in the JAX package and its predictions match
  the port's ``run_csv``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.chem import compute_features as jax_features
from aimnet_x2d_tpu.data import io as jax_io
from aimnet_x2d_tpu.data import preprocessing as jax_prep
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.data.binning import bin_pack_batch as jax_bin_pack
from aimnet_x2d_tpu.data.dataset import BatchLoader as JaxLoader
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.inference.pipeline import StreamingInferencePipeline as JaxPipeline
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.training import evaluator as jax_evaluator
from aimnet_x2d_tpu.training import schedulers as jax_sched
from aimnet_x2d_tpu.training import trainer as jax_trainer
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.chem import compute_features
from aimnet_x2d_tpu_torch.data import io, preprocessing
from aimnet_x2d_tpu_torch.data.batching import collate
from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.training import evaluator, schedulers, trainer

torch.set_num_threads(1)

SMILES = ["CCO", "c1ccccc1O", "CC(=O)N", "C1CCC(CC1)OC#N", "CC(C)(F)F", "N#CC=CC",
          "OCC(O)CO", "C[C@H](N)C(=O)O", "F/C=C/F", "c1ccncc1C", "CCCCCCCC", "O=C=O"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    monkeypatch.setenv("AIMNET_MP_PROJ", "1")
    monkeypatch.setenv("AIMNET_ATTNPOOL_KERNEL", "interpret")
    monkeypatch.setenv("AIMNET_WPOOL_KERNEL", "interpret")


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


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_one_train_step_matches_jax(clip):
    kw = dict(hidden_dim=48, embedding_dim=8, num_message_passing_layers=2, output_dim=3,
              num_shells=3, ffn_num_layers=3, pooling_type="attention", task_type="multitask",
              shell_conv_dropout=0.0, ffn_dropout=0.0)
    rng = np.random.default_rng(0)
    targets = rng.normal(size=(len(SMILES), 3)).astype(np.float32)
    jb = jax_bin_pack(jax_collate([jax_features(s, 3) for s in SMILES], targets, num_hops=3),
                      ab=64, mb=16)
    pb = bin_pack_batch(collate([compute_features(s, 3) for s in SMILES], targets, num_hops=3),
                        ab=64, mb=16)
    flat = init_params(GNNConfig(**kw), seed=5)
    lr = 1e-3
    jcfg = jax_trainer.TrainConfig(learning_rate=lr, loss_function="l1", task_type="multitask",
                                   grad_clip=clip)
    jmodel = JaxGNN(JaxConfig(**kw))
    params = _tree(flat)
    loss_ref, grads_ref = jax.value_and_grad(jax_trainer.make_loss_fn(jmodel, jcfg))(params, jb)
    opt = jax_trainer.make_optimizer(jcfg)
    step = jax_trainer.make_train_step(jmodel, jcfg, opt)
    new_ref, _, step_loss, _ = step(params, opt.init(params), jb, jnp.float32(lr),
                                    jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(step_loss), float(loss_ref), rtol=1e-6)

    cfg = GNNConfig(**kw)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    opt_t = trainer.Optimizer(model.parameters(), clip)
    loss_fn = trainer.make_loss_fn(trainer.TrainConfig(loss_function="l1", task_type="multitask"))
    batch = pb.to("cpu")
    out = model(batch, train=True)
    loss = loss_fn(out.predictions, batch.targets, batch.graph_mask)
    loss.backward()
    print(f"loss port {float(loss):.7f} jax {float(loss_ref):.7f}")
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=5e-4, atol=5e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    got_g = params_to_flax(grads, cfg)
    ref_g = _flat(grads_ref)
    assert set(got_g) == set(ref_g)
    worst = max(float(np.abs(got_g[k] - ref_g[k]).max()) for k in ref_g)
    print(f"grads: worst max|d| {worst:.2e}")
    for k in ref_g:
        np.testing.assert_allclose(got_g[k], ref_g[k], rtol=5e-4, atol=5e-5, err_msg=k)
    norm = opt_t.step(lr)
    gnorm_ref = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in ref_g.values())))
    np.testing.assert_allclose(float(norm), gnorm_ref, rtol=5e-4)
    assert (gnorm_ref > clip) == (clip < 1.0)  # the small clip binds, the default does not
    got_p = params_to_flax(model.state_dict(), cfg)
    ref_p = _flat(new_ref)
    for k in ref_p:
        np.testing.assert_allclose(got_p[k], ref_p[k], rtol=5e-4, atol=5e-5, err_msg=k)


def test_train_forward_draws_dropout_and_differs_from_serving():
    cfg = GNNConfig(hidden_dim=32, embedding_dim=4, num_message_passing_layers=2,
                    shell_conv_dropout=0.3, ffn_dropout=0.3)
    pb = bin_pack_batch(collate([compute_features(s, 3) for s in SMILES[:4]],
                                np.zeros((4, 1)), num_hops=3), ab=64, mb=16).to("cpu")
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed=1)))
    gen = torch.Generator().manual_seed(0)
    a = model(pb, train=True, generator=gen).predictions
    b = model(pb, train=True, generator=gen).predictions
    with torch.no_grad():
        c = model(pb).predictions
    assert a.requires_grad and not torch.equal(a, b) and not torch.equal(a.detach(), c)
    same = model(pb, train=True, drop_seed=7, generator=torch.Generator().manual_seed(1))
    again = model(pb, train=True, drop_seed=7, generator=torch.Generator().manual_seed(1))
    assert torch.equal(same.predictions, again.predictions)
    with pytest.raises(ValueError, match="FFN dropout"):
        model(pb, train=True, drop_seed=7)


def test_mean_pool_training_raises():
    """Mean-pool training runs and its gradients flow: they reach the x_self
    projection, the stack and the head.  (The name is kept from when this
    path raised, so the test keeps its identity across versions.)"""
    cfg = GNNConfig(hidden_dim=32, embedding_dim=4, num_message_passing_layers=2,
                    pooling_type="mean")
    pb = bin_pack_batch(collate([compute_features(s, 3) for s in SMILES[:2]],
                                np.ones((2, 1)), num_hops=3), ab=64, mb=16).to("cpu")
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed=0)))
    out = model(pb, train=True, generator=torch.Generator().manual_seed(0))
    (out.predictions[pb.graph_mask] - 1.0).abs().mean().backward()
    grads = dict(model.named_parameters())
    xs = cfg.x_self_dim
    for name, rows in (("embedding_projection.weight", slice(0, xs)),
                       ("embedding_projection.weight", slice(xs, None)),
                       ("message_passing_layers.0.input_proj.weight", slice(None)),
                       ("concat_self_other.weight", slice(None)),
                       ("output_layer.weight", slice(None))):
        g = grads[name].grad
        assert g is not None and torch.isfinite(g).all() and g[rows].abs().max() > 0, name


def test_params_round_trip_bit_for_bit():
    cfg = GNNConfig(hidden_dim=40, embedding_dim=8, num_message_passing_layers=3, output_dim=5)
    flat = init_params(cfg, seed=3)
    back = params_to_flax(params_from_flax(flat), cfg)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == np.float32 and back[k].shape == flat[k].shape
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("name,kw", [
    ("ReduceLROnPlateau", dict(lr_reduce_factor=0.3, lr_patience=2)),
    ("CosineAnnealingLR", dict(lr_cosine_t_max=5)),
    ("StepLR", dict(lr_step_size=3, lr_step_gamma=0.5)),
    ("ExponentialLR", dict(lr_exp_gamma=0.9)),
])
def test_scheduler_sequences_match_jax(name, kw):
    losses = [1.0, 0.9, 0.95, 0.96, 0.97, 0.91, 0.92, 0.93, 0.94, 0.8, 0.81, 0.82]
    a = jax_sched.create_scheduler(name, 1e-3, **kw)
    b = schedulers.create_scheduler(name, 1e-3, **kw)
    got = [b.step(e, v) for e, v in enumerate(losses)]
    assert got == [a.step(e, v) for e, v in enumerate(losses)]
    assert len(set(got)) > 1


@pytest.mark.parametrize("sae", [False, True])
def test_preprocessing_fit_transform_matches_jax(sae):
    rng = np.random.default_rng(2)
    nums = [rng.integers(1, 10, rng.integers(3, 12)) for _ in range(60)]
    targets = rng.normal(size=(60, 2)) * 4 + np.array([[1.0, -3.0]])
    targets[:, 0] += [0.7 * len(n) for n in nums]
    cfg = dict(apply_sae=sae, sae_subtasks=[0] if sae else None, task_type="multitask")
    a = jax_prep.PreprocessingPipeline(jax_prep.PreprocessingConfig(**cfg))
    b = preprocessing.PreprocessingPipeline(preprocessing.PreprocessingConfig(**cfg))
    a.fit(nums[:40], targets[:40])
    b.fit(nums[:40], targets[:40])
    np.testing.assert_array_equal(b.transform(nums, targets), a.transform(nums, targets))
    assert b.state_dict() == a.state_dict()
    rt = preprocessing.PreprocessingPipeline.from_state_dict(b.state_dict())
    np.testing.assert_array_equal(rt.transform(nums, targets), a.transform(nums, targets))


@pytest.mark.parametrize("n,seed", [(10, 42), (97, 0), (1000, 7)])
def test_split_matches_jax(n, seed):
    smiles = [f"C{i}" for i in range(n)]
    targets = np.arange(n, dtype=np.float32)[:, None]
    a = jax_io.split_dataset(smiles, targets, 0.8, 0.1, 0.1, seed=seed)
    b = io.split_dataset(smiles, targets, 0.8, 0.1, 0.1, seed=seed)
    for (sa, ta), (sb, tb) in zip(a, b):
        assert sa == sb
        np.testing.assert_array_equal(ta, tb)


def test_shuffled_loader_order_and_packing_match_jax():
    smiles = SMILES * 3
    targets = np.arange(len(smiles), dtype=np.float32)[:, None]
    ds = MoleculeDataset.from_smiles(smiles, targets, 3)
    jds = JaxDataset.from_smiles(smiles, targets, 3)
    ours = BatchLoader(ds, 8, shuffle=True, seed=11, bin_ab=64, bin_mb=16)
    ref = JaxLoader(jds, 8, shuffle=True, seed=11, binned=True, bin_ab=64, bin_mb=16,
                    slim_edges=False)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for x, y in zip(ours._batch_indices(), ref._batch_indices()):
            np.testing.assert_array_equal(x, y)
        for bo, br in zip(ours, ref):
            for f in ("targets", "graph_mask", "atom_type", "atom_mol", "bin_adj", "pool_mat",
                      "edge_src", "edge_dst", "tet_nbrs", "cis_pairs"):
                np.testing.assert_array_equal(getattr(bo, f), np.asarray(getattr(br, f)), f)
    ours.set_epoch(1)
    assert not np.array_equal(np.concatenate(ours._batch_indices()), np.arange(len(smiles)))


def test_evaluate_matches_jax():
    kw = dict(hidden_dim=32, embedding_dim=8, num_message_passing_layers=2, output_dim=2,
              task_type="multitask")
    rng = np.random.default_rng(4)
    targets = rng.normal(size=(len(SMILES), 2)).astype(np.float32)
    pipe = preprocessing.PreprocessingPipeline(
        preprocessing.PreprocessingConfig(task_type="multitask"))
    pipe.fit(None, targets)
    jpipe = jax_prep.PreprocessingPipeline.from_state_dict(pipe.state_dict())
    flat = init_params(GNNConfig(**kw), seed=2)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat))
    got = evaluator.evaluate(model.eval(), BatchLoader(MoleculeDataset.from_smiles(
        SMILES, targets, 3), 5), "cpu", config=trainer.TrainConfig(task_type="multitask"),
        pipeline=pipe)
    ref = jax_evaluator.evaluate(
        JaxGNN(JaxConfig(**kw)), _tree(flat),
        JaxLoader(JaxDataset.from_smiles(SMILES, targets, 3), 5, binned=True),
        config=jax_trainer.TrainConfig(task_type="multitask"), pipeline=jpipe)
    for k in ("loss", "mae", "rmse", "r2"):
        np.testing.assert_allclose(got[k], ref[k], rtol=5e-4, atol=5e-5, err_msg=k)
    for k in ("mae", "rmse", "r2"):
        np.testing.assert_allclose(got["per_task"][k], ref["per_task"][k], rtol=5e-4, atol=5e-5)
    p, t = rng.normal(size=(9, 3)), rng.normal(size=(9, 3))
    assert evaluator.compute_metrics(p, t) == jax_evaluator.compute_metrics(p, t)


def test_cli_trains_on_cpu_and_jax_serves_the_artifact(tmp_path):
    rng = np.random.default_rng(0)
    smiles = (SMILES + ["CC(C)O", "CCN(CC)CC", "c1ccoc1", "CC#N", "OC(=O)CC(=O)O", "CCOC(C)=O",
                        "C1CCOC1", "NCCO"]) * 3
    n_atoms = np.array([compute_features(s, 3).num_atoms for s in smiles], np.float32)
    df = pd.DataFrame({"smiles": smiles, "a": n_atoms * 0.5 + rng.normal(size=len(smiles)) * 0.1,
                       "b": -n_atoms + rng.normal(size=len(smiles)) * 0.1})
    csv = str(tmp_path / "train.csv")
    df.to_csv(csv, index=False)
    path = str(tmp_path / "model.npz")
    summary = cli.main([
        "--data_path", csv, "--multi_target_columns", "a,b", "--task_type", "multitask",
        "--epochs", "2", "--batch_size", "16", "--hidden_dim", "32", "--embedding_dim", "8",
        "--num_message_passing_layers", "2", "--ffn_num_layers", "2", "--learning_rate", "3e-3",
        "--model_save_path", path, "--device", "cpu", "--seed", "3"])
    hist = summary["history"]
    print("train losses", [h["train_loss"] for h in hist])
    assert len(hist) == 2 and hist[1]["train_loss"] < hist[0]["train_loss"]
    assert np.isfinite(summary["test_metrics"]["mae"])
    art = jax_load_artifact(path)
    assert art.extra["target_columns"] == ["a", "b"] and art.extra["max_hops"] == 3
    assert art.model_config.hidden_dim == 32 and art.pipeline.standard_scaler is not None
    mols = str(tmp_path / "mols.csv")
    pd.DataFrame({"smiles": SMILES}).to_csv(mols, index=False)
    ref, out = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    JaxPipeline(artifact_path=path, chunk_size=5, batch_size=4).run_csv(mols, ref)
    StreamingInferencePipeline(path, chunk_size=5, batch_size=4, device="cpu").run_csv(mols, out)
    g, r = pd.read_csv(out), pd.read_csv(ref)
    assert g["smiles"].tolist() == r["smiles"].tolist()
    np.testing.assert_allclose(g[["a", "b"]].to_numpy(), r[["a", "b"]].to_numpy(),
                               rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("flag", [["--save_embeddings"], ["--inference_hdf5", "x.h5"],
                                  ["--iterable_dataset"], ["--hyperparameter_file", "hp.yaml"]])
def test_cli_later_slices_raise(flag, tmp_path, monkeypatch):
    """The four flags that raised NotImplementedError until the port took
    them: each now parses to the JAX CLI's postprocessed namespace (the
    port's extra ``--device`` aside) and reaches its branch --
    ``--save_embeddings`` writes each split's embeddings after training,
    ``--inference_hdf5`` serves through ``run_hdf5``, ``--iterable_dataset``
    builds the HDF5 files and trains from them, and
    ``--hyperparameter_file`` with ``--num_trials`` > 1 runs the search."""
    from aimnet_x2d_tpu.cli import parse_arguments as jax_parse
    from aimnet_x2d_tpu_torch import hyperopt, runner
    from aimnet_x2d_tpu_torch.inference import engine

    argv = ["--data_path", "x.csv", *flag]
    got = vars(cli.parse_arguments(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jax_parse(argv))

    csv, out = str(tmp_path / "t.csv"), str(tmp_path / "m.npz")
    smiles = SMILES * 2
    pd.DataFrame({"smiles": smiles, "y": np.arange(len(smiles), dtype=np.float32)}).to_csv(
        csv, index=False)
    small = ["--data_path", csv, "--target_column", "y", "--epochs", "1", "--batch_size", "8",
             "--hidden_dim", "16", "--embedding_dim", "4", "--num_message_passing_layers", "1",
             "--ffn_num_layers", "1", "--model_save_path", out, "--device", "cpu"]
    reached = []
    if flag[0] == "--save_embeddings":
        emb = str(tmp_path / "emb.h5")
        cli.main(small + ["--save_embeddings", "--embeddings_output_path", emb])
        import h5py

        with h5py.File(emb) as f:
            assert sorted(f) == ["test", "train", "val"]
            assert sorted(f["train"]) == ["mol_embeddings", "smiles"]
            assert f["train/mol_embeddings"].shape[1] == 16
        return
    if flag[0] == "--inference_hdf5":
        for p in (out, str(tmp_path / "x.h5")):
            open(p, "w").close()

        class Pipe:
            def __init__(self, **kw):
                assert kw["save_embeddings"] is False and kw["device"].type == "cpu"

            def run_hdf5(self, path, output):
                reached.append(path)
                return {}

        monkeypatch.setattr(engine, "StreamingInferencePipeline", Pipe)
        cli.main(["--inference_hdf5", str(tmp_path / "x.h5"), "--model_save_path", out,
                  "--device", "cpu"])
        assert reached == [str(tmp_path / "x.h5")]
        return
    if flag[0] == "--iterable_dataset":
        h5 = [str(tmp_path / f"{s}.h5") for s in ("tr", "va", "te")]
        summary = cli.main(small + ["--iterable_dataset", "--train_hdf5", h5[0], "--val_hdf5",
                                    h5[1], "--test_hdf5", h5[2]])
        assert all(os.path.exists(p) for p in h5) and np.isfinite(summary["best_val_loss"])
        return
    monkeypatch.setattr(hyperopt, "run_hyperparameter_optimization",
                        lambda a: reached.append(a.num_trials) or {"results": []})
    monkeypatch.setattr(runner, "main_runner", lambda a: reached.append("one run"))
    cli.main(small + ["--hyperparameter_file", "hp.yaml", "--num_trials", "2"])
    cli.main(small + ["--hyperparameter_file", "hp.yaml"])  # one trial: a plain run, as JAX
    assert reached == [2, "one run"]


def test_cli_takes_every_flag_of_the_jax_cli():
    """The port's parser has every option string of the JAX parser, and one
    more: ``--device``."""
    from aimnet_x2d_tpu.cli import build_parser as jax_parser

    def options(p):
        return {o for a in p._actions for o in a.option_strings}

    port, jax_opts = options(cli.build_parser()), options(jax_parser())
    assert port - jax_opts == {"--device"} and not jax_opts - port
