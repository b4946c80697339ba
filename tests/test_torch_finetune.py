"""Fine-tuning and the rest of training of the port against the JAX package,
on the CPU: freeze and unfreeze masks and parameter counts by flax name,
the optimizer's updates with freeze, unfreeze and layer-wise LR decay (the
global-norm clip binding), ``transfer_params``, checkpoint/resume, the
tracker, and a CLI fine-tune run whose artifact the JAX pipeline serves.

Bars: fp32 rtol 5e-4 / atol 5e-5 (the repo's bar, tests/test_torch_model.py);
frozen parameters and resumed runs bit for bit.
"""

import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import yaml

from aimnet_x2d_tpu.checkpoint import transfer_params as jax_transfer
from aimnet_x2d_tpu.data.dataset import BatchLoader as JaxLoader
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.inference.pipeline import StreamingInferencePipeline as JaxPipeline
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.training import trainer as jax_trainer
from aimnet_x2d_tpu.utils import optimization as jax_opt
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import (
    TrainCheckpointer,
    init_params,
    load_artifact,
    params_from_flax,
    params_to_flax,
    transfer_params,
)
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.training import trainer
from aimnet_x2d_tpu_torch.utils import optimization, tracking

torch.set_num_threads(1)

SMILES = ["CCO", "c1ccccc1O", "CC(=O)N", "C1CCC(CC1)OC#N", "CC(C)(F)F", "N#CC=CC",
          "OCC(O)CO", "C[C@H](N)C(=O)O", "F/C=C/F", "c1ccncc1C", "CCCCCCCC", "O=C=O",
          "CC(C)O", "CCN(CC)CC", "c1ccoc1", "CC#N"]
KW = dict(hidden_dim=32, embedding_dim=8, num_message_passing_layers=2, num_shells=1,
          ffn_num_layers=3, pooling_type="mean", shell_conv_dropout=0.0, ffn_dropout=0.0)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    monkeypatch.setenv("AIMNET_MP_PROJ", "1")
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


PATTERNS = [["message_passing_layers_0"], ["output_layer", "ffn/block_1"], ["embedding"]]


@pytest.mark.parametrize("freeze", [True, False])
@pytest.mark.parametrize("patterns", PATTERNS, ids=["mp0", "head", "embedding"])
def test_freeze_mask_and_counts_match_jax(patterns, freeze):
    cfg = GNNConfig(**KW, output_dim=3)
    flat = init_params(cfg, seed=0)
    model = GNN(cfg)
    ref = _flat(jax_opt.freeze_mask(_tree(flat), patterns, freeze=freeze))
    got = optimization.freeze_mask(model, patterns, freeze=freeze)
    names = optimization.flax_names(model)
    assert set(names.values()) == set(ref) and set(names) == set(dict(model.named_parameters()))
    assert {names[k]: v for k, v in got.items()} == {k: float(v) for k, v in ref.items()}
    assert 0 < sum(got.values()) < len(got)
    assert optimization.count_parameters(model, got) == jax_opt.count_parameters(
        _tree(flat), _tree(ref))
    assert optimization.count_parameters(model) == jax_opt.count_parameters(_tree(flat))


@pytest.mark.parametrize("case", ["freeze", "unfreeze", "llrd", "freeze_llrd"])
def test_optimizer_updates_match_jax(case):
    """Two steps from the same gradients (the small clip binding): every
    parameter against optax's chain; frozen ones bit for bit unchanged."""
    cfg = GNNConfig(**KW, output_dim=2)
    kw = dict(learning_rate=2e-3, grad_clip=1e-3, lr_decay_factor=0.7,
              layer_wise_lr_decay=case.endswith("llrd"),
              freeze_patterns=["message_passing_layers_1", "embedding_projection"]
              if case.startswith("freeze") else None,
              unfreeze_patterns=["output_layer", "ffn"] if case == "unfreeze" else None)
    flat = init_params(cfg, seed=1)
    rng = np.random.default_rng(2)
    grad_steps = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in flat.items()}
                  for _ in range(2)]
    jcfg = jax_trainer.TrainConfig(**kw)
    params = _tree(flat)
    opt = jax_trainer.make_optimizer(jcfg, params)
    state = opt.init(params)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    opt_t = trainer.make_optimizer(model, trainer.TrainConfig(**kw))
    names = optimization.flax_names(model)
    for grads in grad_steps:
        updates, state = opt.update(_tree(grads), state, params)
        updates = jax.tree_util.tree_map(lambda u: u * jnp.float32(kw["learning_rate"]), updates)
        params = optax.apply_updates(params, updates)
        sd = params_from_flax(grads)
        for n, p in model.named_parameters():
            p.grad = sd[n].clone()
        opt_t.step(kw["learning_rate"])
    got, ref = params_to_flax(model.state_dict(), cfg), _flat(params)
    moved = 0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=5e-4, atol=5e-5, err_msg=k)
        if np.array_equal(ref[k], flat[k]):
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
        else:
            moved += 1
    assert 0 < moved <= len(ref)
    if case != "llrd":
        assert moved < len(ref)  # some parameters are frozen
    if case.endswith("llrd"):
        # the decay depth is the JAX package's len(path) - 1 of the flax path
        ref_depth = _flat(jax.tree_util.tree_map_with_path(
            lambda path, _: np.int32(jax_trainer._param_depth(path)), _tree(flat)))
        got_scale = optimization.lr_decay_scales(model, 0.7)
        for n, k in names.items():
            assert got_scale[n] == 0.7 ** int(ref_depth[k]), k
        assert int(ref_depth["params/atom_type_embedding"]) == 1
        assert int(ref_depth["params/output_layer/kernel"]) == 2
        assert int(ref_depth["params/ffn/block_0/linear1/kernel"]) == 4


def test_transfer_params_matches_jax():
    src_cfg = GNNConfig(**KW, output_dim=1)
    dst_cfg = GNNConfig(**{**KW, "pooling_type": "attention"}, output_dim=12)
    src, dst = init_params(src_cfg, seed=3), init_params(dst_cfg, seed=4)
    out_j, buf_j = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf_j):
        ref, rc, rs = jax_transfer(_tree(src), _tree(dst))
    with contextlib.redirect_stdout(out_j):
        got, gc, gs = transfer_params(src, dst)
    assert (gc, gs) == (rc, rs) and out_j.getvalue() == buf_j.getvalue()
    assert 0 < gc < len(dst) and gs > 0
    ref = _flat(ref)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert np.array_equal(got["params/output_layer/kernel"], dst["params/output_layer/kernel"])
    assert np.array_equal(got["params/ffn/block_0/linear1/kernel"],
                          src["params/ffn/block_0/linear1/kernel"])


def _data(seed=0):
    targets = np.random.default_rng(seed).normal(size=(len(SMILES), 1)).astype(np.float32)
    return targets


class _Recorder(tracking.Tracker):
    def __init__(self):
        self.steps = []

    def log(self, metrics, step=None):
        self.steps.append((step, metrics["val_loss"]))


def _port_run(epochs, lr, ckpt_dir=None, seed=5):
    cfg = GNNConfig(**KW, output_dim=1)
    targets = _data()
    ds = MoleculeDataset.from_smiles(SMILES, targets, 1)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed=seed)))
    tc = trainer.TrainConfig(epochs=epochs, learning_rate=lr, lr_scheduler="ExponentialLR",
                             lr_exp_gamma=0.9)
    rec = _Recorder()
    result = trainer.train(
        model, BatchLoader(ds, 8, bin_ab=64, bin_mb=16, shuffle=True, seed=7),
        BatchLoader(ds, 16, bin_ab=64, bin_mb=16), tc, device="cpu", seed=0, tracker=rec,
        checkpointer=TrainCheckpointer(ckpt_dir) if ckpt_dir else None, checkpoint_every=1)
    return result, rec


@pytest.mark.parametrize("lr", [1e-3, 0.5])
def test_resume_equals_an_uninterrupted_run(lr, tmp_path, capsys):
    """2 epochs, then a second run of 4 that resumes from the checkpoint,
    against 4 epochs in one run, bit for bit.  At lr 0.5 the best epoch
    comes before the resume, and the resumed run returns its parameters."""
    whole, rec_whole = _port_run(4, lr)
    _port_run(2, lr, str(tmp_path))
    ckpt = TrainCheckpointer(str(tmp_path))
    assert ckpt.latest_epoch() == 1
    capsys.readouterr()
    resumed, rec = _port_run(4, lr, str(tmp_path))
    assert "[resume] restored checkpoint at epoch 1" in capsys.readouterr().out
    assert [s for s, _ in rec.steps] == [2, 3] and rec.steps == rec_whole.steps[2:]
    assert resumed.best_epoch == whole.best_epoch and resumed.best_val_loss == whole.best_val_loss
    for k, v in whole.state_dict.items():
        assert torch.equal(resumed.state_dict[k], v), k
    assert [h["val_loss"] for h in resumed.history] == [h["val_loss"] for h in whole.history[2:]]
    if lr == 0.5:
        assert whole.best_epoch < 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"epoch_{e}.pt" for e in (1, 2, 3)]


def test_run_matches_jax():
    """4 epochs of the port's ``train`` against the JAX ``train`` from the
    same weights and batches: every epoch's validation loss and the best
    parameters."""
    lr = 1e-3
    cfg = GNNConfig(**KW, output_dim=1)
    whole, _ = _port_run(4, lr)
    targets = _data()
    jds = JaxDataset.from_smiles(SMILES, targets, 1)
    jtc = jax_trainer.TrainConfig(epochs=4, learning_rate=lr, lr_scheduler="ExponentialLR",
                                  lr_exp_gamma=0.9)
    ref = jax_trainer.train(
        JaxGNN(JaxConfig(**KW, output_dim=1)), _tree(init_params(cfg, seed=5)),
        JaxLoader(jds, 8, shuffle=True, seed=7, binned=True, bin_ab=64, bin_mb=16),
        JaxLoader(jds, 16, binned=True, bin_ab=64, bin_mb=16), jtc, verbose=False)
    np.testing.assert_allclose([h["val_loss"] for h in whole.history],
                               [h["val_loss"] for h in ref.history], rtol=5e-4, atol=5e-5)
    assert whole.best_epoch == ref.best_epoch
    got, want = params_to_flax(whole.state_dict, cfg), _flat(ref.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=5e-5, err_msg=k)


def test_cli_finetune_resume_and_jax_serves(tmp_path, capsys):
    rng = np.random.default_rng(0)
    smiles = SMILES * 2
    n = len(smiles)
    df = pd.DataFrame({"smiles": smiles, "gap": rng.normal(size=n),
                       **{f"t{i}": rng.normal(size=n) for i in range(3)}})
    csv = str(tmp_path / "data.csv")
    df.to_csv(csv, index=False)
    base = ["--data_path", csv, "--batch_size", "8", "--hidden_dim", "32", "--embedding_dim", "8",
            "--num_shells", "1", "--num_message_passing_layers", "2", "--pooling_type", "mean",
            "--learning_rate", "3e-3", "--device", "cpu", "--seed", "3"]
    pre = str(tmp_path / "pre.npz")
    cli.main([*base, "--target_column", "gap", "--epochs", "1", "--model_save_path", pre])
    tuned = str(tmp_path / "tuned.npz")
    ckpt = str(tmp_path / "ckpt")
    exp = str(tmp_path / "exp" / "config.yaml")
    tune = [*base, "--multi_target_columns", "t0,t1,t2", "--task_type", "multitask",
            "--transfer_learning", pre, "--freeze_pretrained", "--layer_wise_lr_decay",
            "--checkpoint_dir", ckpt, "--checkpoint_every", "1", "--model_save_path", tuned,
            "--experiment_config", exp]
    capsys.readouterr()
    cli.main([*tune, "--epochs", "2"])
    out = capsys.readouterr().out
    assert "[transfer] copied" in out and "trainable)" in out
    a, b = load_artifact(pre), load_artifact(tuned)
    assert b.model_config.output_dim == 3
    frozen = [k for k in b.params if not k.startswith("params/output_layer/")]
    assert len(frozen) == len(a.params) - 2
    for k in frozen:
        np.testing.assert_array_equal(b.params[k], a.params[k], err_msg=k)
    fresh = init_params(b.model_config, seed=3)
    assert not np.array_equal(b.params["params/output_layer/kernel"],
                              fresh["params/output_layer/kernel"])
    with open(exp) as f:
        saved = yaml.safe_load(f)["config"]
    assert saved["transfer_learning"] == pre and saved["freeze_pretrained"] is True
    summary = cli.main([*tune, "--epochs", "3"])
    out = capsys.readouterr().out
    assert "[resume] restored checkpoint at epoch 1" in out and "experiment complete" in out
    assert [h["epoch"] for h in summary["history"]] == [2]
    with open(tuned + ".summary.json") as f:
        assert json.load(f)["history"][0]["epoch"] == 2
    mols = str(tmp_path / "mols.csv")
    pd.DataFrame({"smiles": SMILES}).to_csv(mols, index=False)
    ref, got = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    JaxPipeline(artifact_path=tuned, chunk_size=5, batch_size=4).run_csv(mols, ref)
    StreamingInferencePipeline(tuned, chunk_size=5, batch_size=4, device="cpu").run_csv(mols, got)
    g, r = pd.read_csv(got), pd.read_csv(ref)
    assert g["smiles"].tolist() == r["smiles"].tolist()
    cols = ["t0", "t1", "t2"]
    np.testing.assert_allclose(g[cols].to_numpy(), r[cols].to_numpy(), rtol=5e-4, atol=5e-5)


def test_tracker_without_wandb_warns_and_runs(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # as if not installed
    args = cli.parse_arguments(["--data_path", "x.csv", "--enable_wandb", "--wandb_tags", "a,b"])
    assert args.wandb_tag_list == ["a", "b"] and args.wandb_project == "aimnet-x2d-tpu"
    t = tracking.create_tracker(args)
    assert not t.enabled and "wandb is not installed" in capsys.readouterr().out
    t.log({"x": 1.0}, step=0)
    t.summary({"x": 1.0})
    t.finish()
    assert not tracking.create_tracker(cli.parse_arguments(["--data_path", "x.csv"])).enabled
