"""The port's hyperparameter search (aimnet_x2d_tpu_torch/hyperopt.py)
against the JAX package's, on the CPU:

- ``sample_hparam_value`` draws JAX's value stream for each kind of spec;
- a trial re-derives the fields derived from a sampled source (the twin of
  the JAX package's ``test_hyperopt_rederives_ffn_hidden_dim``);
- a 2-trial search (hidden 24, 1 epoch, both sides from the same weights
  by ``--transfer_learning``, dropouts 0, mean pooling, the MSE loss: an
  L1 batch whose residual signs cancel leaves an exactly-zero output-bias
  gradient that Adam turns into a move of up to lr from either side's
  rounding residue) matches JAX's
  trial for trial: the sampled configurations, seeds and artifact paths,
  the statuses, the validation losses (rel 1e-4), the results file's keys,
  the promoted artifact (its trial and configuration, its parameters to
  the fp32 bar) and the removed trial artifacts;
- trials that raise are recorded as failed on both sides, and nothing is
  promoted.
"""

import json
import os
import random

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from aimnet_x2d_tpu import hyperopt as jax_hyperopt
from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.cli import parse_arguments as jax_parse
from aimnet_x2d_tpu_torch import cli, hyperopt
from aimnet_x2d_tpu_torch.checkpoint import init_params, load_artifact, save_artifact
from aimnet_x2d_tpu_torch.runner import gnn_config_from_args

torch.set_num_threads(1)

SPECS = [[256, 384, 512], {"type": "int", "min": 1, "max": 4},
         {"type": "float", "min": 0.0, "max": 0.2},
         {"type": "float", "min": 1.0e-4, "max": 2.0e-3, "log": True},
         {"type": "choice", "values": ["attention", "mean"]}, 0.5]


def test_sampler_draws_jax_stream():
    for spec in SPECS:
        a, b = random.Random(7), random.Random(7)
        assert ([hyperopt.sample_hparam_value(a, spec) for _ in range(20)]
                == [jax_hyperopt.sample_hparam_value(b, spec) for _ in range(20)])
    with pytest.raises(ValueError):
        hyperopt.sample_hparam_value(random.Random(0), {"type": "gauss"})
    space = yaml.safe_load(open(os.path.join(os.path.dirname(__file__), "..",
                                             "example_hyperparams.yaml")))
    rng = random.Random(3)
    want = [{k: jax_hyperopt.sample_hparam_value(rng, v) for k, v in space.items()}
            for _ in range(4)]
    assert hyperopt.sample_trials(space, 3, 4) == want


def test_trial_rederives_derived_fields():
    args = cli.parse_arguments(["--data_path", "x.csv", "--num_workers", "2"])
    assert args.ffn_hidden_dim == 512 and args.precompute_num_workers == 2
    t = hyperopt.trial_arguments(args, {"hidden_dim": 256, "num_workers": 3}, 2)
    assert (t.ffn_hidden_dim, t.precompute_num_workers, t.stream_batch_size) == (256, 3, None)
    assert t.seed == args.seed + 2 and t.model_save_path == args.model_save_path + ".trial2"
    assert t.hyperparameter_file is None and t.num_trials == 1
    kept = hyperopt.trial_arguments(args, {"hidden_dim": 256, "ffn_hidden_dim": 64}, 0)
    assert kept.ffn_hidden_dim == 64 and args.ffn_hidden_dim == 512


@pytest.fixture(scope="module")
def search(tmp_path_factory):
    d = tmp_path_factory.mktemp("hp")
    rng = np.random.default_rng(31)
    smiles = ["CCO", "c1ccccc1O", "CC(=O)N", "OCC(O)CO", "CC#N", "c1ccncc1C", "CCCCCC",
              "CC(C)O", "NC(=O)N", "ClCCl", "CCN(CC)CC", "C1CCOC1"] * 4
    n = np.array([len(s) for s in smiles], np.float32)
    csv = str(d / "t.csv")
    pd.DataFrame({"smiles": smiles, "y": n * 0.2 + rng.normal(size=len(n)) * 0.1}).to_csv(
        csv, index=False)
    space = str(d / "space.yaml")
    with open(space, "w") as f:
        yaml.safe_dump({"learning_rate": {"type": "float", "min": 1e-4, "max": 3e-3, "log": True},
                        "lr_scheduler": ["ReduceLROnPlateau", "CosineAnnealingLR"],
                        "batch_size": [8, 16]}, f)
    argv = ["--data_path", csv, "--target_column", "y", "--epochs", "1", "--hidden_dim", "24",
            "--embedding_dim", "4", "--num_message_passing_layers", "2", "--num_shells", "2",
            "--ffn_num_layers", "1", "--pooling_type", "mean", "--shell_conv_dropout", "0",
            "--ffn_dropout", "0", "--loss_function", "mse", "--num_workers", "0",
            "--hyperparameter_file", space, "--num_trials", "2", "--seed", "5"]
    init = str(d / "init.npz")
    cfg = gnn_config_from_args(cli.parse_arguments(argv), 1)
    save_artifact(init, init_params(cfg, seed=1), cfg)
    argv += ["--transfer_learning", init]
    port = cli.main(argv + ["--model_save_path", str(d / "port.npz"), "--device", "cpu"])
    jax = jax_hyperopt.run_hyperparameter_optimization(
        jax_parse(argv + ["--model_save_path", str(d / "jax.npz")]))
    return dict(dir=d, port=port, jax=jax)


def test_search_matches_jax_trial_for_trial(search):
    d, port, jax = search["dir"], search["port"], search["jax"]
    assert [r["status"] for r in port["results"]] == ["ok", "ok"]
    for p, j in zip(port["results"], jax["results"]):
        assert p.keys() == j.keys()
        assert (p["trial"], p["config"], p["status"]) == (j["trial"], j["config"], j["status"])
        print(f"trial {p['trial']} {p['config']}: val {p['val_loss']:.7f} jax {j['val_loss']:.7f}")
        assert abs(p["val_loss"] - j["val_loss"]) <= 1e-4 * abs(j["val_loss"])
    assert port["best"]["trial"] == jax["best"]["trial"]
    assert port["best"]["artifact"] == str(d / "port.npz") + f".trial{port['best']['trial']}"
    with open(d / "port.npz.hyperopt_results.json") as f, \
            open(d / "jax.npz.hyperopt_results.json") as g:
        a, b = json.load(f), json.load(g)
    assert a.keys() == b.keys() and a["best"].keys() == b["best"].keys()
    got, want = load_artifact(str(d / "port.npz")), jax_load_artifact(str(d / "jax.npz"))
    assert got.extra["hyperopt_best_trial"] == want.extra["hyperopt_best_trial"]
    assert got.extra["hyperopt_config"] == want.extra["hyperopt_config"]
    assert got.model_config.to_dict() == want.model_config.to_dict()
    flat_j = {k: np.asarray(v) for k, v in _flat(want.params).items()}
    assert got.params.keys() == flat_j.keys()
    for k, v in flat_j.items():
        np.testing.assert_allclose(got.params[k], v, rtol=5e-4, atol=5e-5, err_msg=k)
    # the trial artifacts are removed; their summaries stay, on both sides
    left = sorted(p for p in os.listdir(d) if ".trial" in p)
    assert left == sorted(f"{side}.npz.trial{t}.summary.json"
                          for side in ("jax", "port") for t in (0, 1))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_failed_trials_are_recorded_and_nothing_promoted(tmp_path, capsys):
    space = str(tmp_path / "bad.yaml")
    with open(space, "w") as f:
        yaml.safe_dump({"epochs": [0]}, f)  # every trial fails validation
    argv = ["--data_path", str(tmp_path / "missing.csv"), "--hyperparameter_file", space,
            "--num_trials", "2"]
    port = cli.main(argv + ["--model_save_path", str(tmp_path / "p.npz"), "--device", "cpu"])
    jax = jax_hyperopt.run_hyperparameter_optimization(
        jax_parse(argv + ["--model_save_path", str(tmp_path / "j.npz")]))
    assert [r["status"] for r in port["results"]] == [r["status"] for r in jax["results"]] == [
        "failed", "failed"]
    assert port["best"]["trial"] == jax["best"]["trial"] == -1
    assert not os.path.exists(tmp_path / "p.npz")
    with open(tmp_path / "p.npz.hyperopt_results.json") as f:
        assert [r["status"] for r in json.load(f)["results"]] == ["failed", "failed"]
