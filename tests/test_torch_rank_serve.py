"""Serving over several ranks (``StreamingInferencePipeline.run_csv`` with
``host_id`` / ``num_hosts``, and the CLI under ``torch.distributed.run``),
on the CPU, against the port's single-rank output and the JAX package's
``run_csv`` on the same artifact (written by JAX):

- 2 and 3 ranks run in sequence, as the JAX package's own test runs them
  (tests/test_inference_streaming.py): the last rank to run is rank 0,
  which merges; the merged CSV holds every row in input order, no rank file
  is left, and its values equal the single-rank output and JAX's at the
  fp32 bar (rtol 5e-4 / atol 5e-5, as tests/test_torch_inference.py), in
  every inference mode (deterministic, MC-dropout with the dropouts at 0,
  evidential); MC-dropout with dropout on serves its uncertainty column;
- a real run of two gloo processes started by ``torch.distributed.run``
  merges the rows in order, leaves no rank file, and equals the single
  rank;
- ``--num_devices 2`` outside torchrun serves in one process, with a note.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu.checkpoint import save_artifact as jax_save_artifact
from aimnet_x2d_tpu.data.preprocessing import PreprocessingConfig, PreprocessingPipeline
from aimnet_x2d_tpu.data.synthetic import make_synthetic_batch
from aimnet_x2d_tpu.inference.pipeline import StreamingInferencePipeline as JaxPipeline
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNITS = ["C", "CC", "O", "N", "C(C)", "C(=O)", "C=C", "c1ccc(cc1)", "[C@H](F)", "/C=C/"]
TARGETS = ["gap", "homo"]


def _smiles(n=29):
    rng = np.random.default_rng(0)
    out = ["C" + "".join(UNITS[rng.integers(len(UNITS))] for _ in range(int(rng.integers(1, 4))))
           + "O" for _ in range(n)]
    out[7] = "bad((smiles"  # dropped, on rank 0's range
    out[20] = "C1CC"  # an unclosed ring: dropped on the last rank's range
    return out


def _artifact(root, name, **kw):
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
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("rank_serve")
    csv = str(root / "mols.csv")
    pd.DataFrame({"smiles": _smiles()}).to_csv(csv, index=False)
    return {"csv": csv,
            "deterministic": _artifact(root, "det"),
            "mc_dropout": _artifact(root, "mc0", shell_conv_dropout=0.0, ffn_dropout=0.0),
            "mc_dropout_on": _artifact(root, "mc", shell_conv_dropout=0.1, ffn_dropout=0.1),
            "evidential": _artifact(root, "evid", loss_function="evidential")}


def _port(path, mode="deterministic", mc=0):
    return StreamingInferencePipeline(path, chunk_size=5, batch_size=4, device="cpu",
                                      inference_mode=mode, mc_samples=mc)


def _close(got: pd.DataFrame, want: pd.DataFrame, what: str):
    assert got["smiles"].tolist() == want["smiles"].tolist(), what
    cols = [c for c in want.columns if c != "smiles"]
    assert list(got.columns) == list(want.columns), what
    np.testing.assert_allclose(got[cols].to_numpy(np.float64), want[cols].to_numpy(np.float64),
                               rtol=5e-4, atol=5e-5, err_msg=what)


@pytest.mark.parametrize("mode", ["deterministic", "mc_dropout", "evidential"])
@pytest.mark.parametrize("ranks", [2, 3])
def test_ranks_in_sequence_merge_in_order_and_match_single_and_jax(data, tmp_path, mode, ranks):
    path, csv = data[mode], data["csv"]
    mc = 2 if mode == "mc_dropout" else 0
    single = str(tmp_path / "single.csv")
    _port(path, mode, mc).run_csv(csv, single)
    ref = pd.read_csv(single)
    merged = str(tmp_path / "merged.csv")
    results = [_port(path, mode, mc).run_csv(csv, merged, host_id=h, num_hosts=ranks)
               for h in reversed(range(ranks))]  # rank 0 last: it merges
    # one process: the all-gather sees only this rank's counts
    assert sum(r["total_molecules"] for r in results) == len(_smiles())
    assert sum(r["valid_molecules"] for r in results) == len(ref) == len(_smiles()) - 2
    for h in range(ranks):
        assert not os.path.exists(f"{merged}.rank{h}")
    got = pd.read_csv(merged)
    _close(got, ref, f"{mode} x {ranks} ranks vs one rank")
    if mode == "mc_dropout":
        assert (got[[f"{t}_uncertainty" for t in TARGETS]].to_numpy() == 0).all()
    jax_out = str(tmp_path / "jax.csv")
    JaxPipeline(artifact_path=path, chunk_size=5, batch_size=4,
                inference_mode=mode, mc_samples=mc).run_csv(csv, jax_out)
    _close(got, pd.read_csv(jax_out), f"{mode} x {ranks} ranks vs JAX")


def test_mc_dropout_with_dropout_serves_over_ranks(data, tmp_path):
    merged = str(tmp_path / "mc.csv")
    for h in (1, 0):
        _port(data["mc_dropout_on"], "mc_dropout", 4).run_csv(data["csv"], merged, host_id=h,
                                                              num_hosts=2)
    got = pd.read_csv(merged)
    assert len(got) == len(_smiles()) - 2 and not os.path.exists(merged + ".rank1")
    unc = got[[f"{t}_uncertainty" for t in TARGETS]].to_numpy()
    assert np.isfinite(unc).all() and (unc > 0).all()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_torchrun_two_gloo_ranks_serve_and_merge(data, tmp_path):
    out = str(tmp_path / "ranks.csv")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
           "2", "--master_addr", "localhost", "--master_port", str(_free_port()), "-m",
           "aimnet_x2d_tpu_torch.cli", "--inference_csv", data["csv"], "--model_save_path",
           data["deterministic"], "--inference_output", out, "--device", "cpu",
           "--stream_batch_size", "4", "--stream_chunk_size", "5"]
    p = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "rank 1 of 2" in p.stdout and "rank 0 of 2" in p.stdout
    assert not os.path.exists(out + ".rank0") and not os.path.exists(out + ".rank1")
    single = str(tmp_path / "single.csv")
    _port(data["deterministic"]).run_csv(data["csv"], single)
    _close(pd.read_csv(out), pd.read_csv(single), "torchrun 2 ranks vs one rank")


def test_num_devices_at_serving_serves_in_one_process(data, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = str(tmp_path / "nd.csv")
    summary = cli.main(["--inference_csv", data["csv"], "--model_save_path", data["deterministic"],
                        "--inference_output", out, "--device", "cpu", "--num_devices", "2",
                        "--graph_shards", "2", "--stream_batch_size", "4"])
    assert "serving in one process" in capsys.readouterr().out
    assert summary["ranks"] == 1 and summary["valid_molecules"] == len(_smiles()) - 2
    single = str(tmp_path / "single.csv")
    _port(data["deterministic"]).run_csv(data["csv"], single)
    _close(pd.read_csv(out), pd.read_csv(single), "--num_devices 2 vs one rank")
