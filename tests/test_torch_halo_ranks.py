"""The port's halo graph-partitioned execution on several gloo ranks (one
process each, tests/torch_halo_worker.py, which imports no JAX) against the
JAX package's ``shard_map`` on virtual CPU devices and against the port's
own single-device results:

- two ranks (graph 2) run the serving forward of a binned halo partition
  with a split molecule (``cut_edges`` > 0; ab 16, so chunked fragments add
  same-rank cross-bin halo rows) for attention, mean, sum and max pooling:
  equal to JAX's halo forward on 2 devices (kernel 5 in interpret mode) and
  to the port's forward of the unpartitioned batch, rtol 2e-5 / atol 1e-6
  (JAX's own bar, tests/test_halo.py);
- four ranks (data 2 x graph 2) take one train step: the loss equals
  JAX's ``make_graph_parallel_train_step`` on a 2 x 2 mesh and the
  single-device weighted mean (rtol 1e-5), and every updated parameter
  equals both (rtol 2e-4 / atol 2e-5, as tests/test_halo.py: head biases
  whose exact gradient is 0 move by Adam's amplified residue) and is
  bit-identical across the four ranks.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.parallel import create_mesh
from aimnet_x2d_tpu.parallel import halo as jax_halo
from aimnet_x2d_tpu.parallel.graph_parallel import make_graph_parallel_train_step
from aimnet_x2d_tpu.training import TrainConfig as JaxTrainConfig
from aimnet_x2d_tpu.training.trainer import make_optimizer as jax_make_optimizer
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts, stack_batches
from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.parallel import halo as port_halo
from aimnet_x2d_tpu_torch.training import trainer

from test_torch_halo_partition import _batches
from test_torch_train import _tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_halo_worker.py")
KW = dict(hidden_dim=32, output_dim=2, num_shells=2, num_message_passing_layers=2,
          embedding_dim=8, ffn_num_layers=2, task_type="multitask", shell_conv_dropout=0.0,
          ffn_dropout=0.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, job, world):
    job_path = str(tmp_path / "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), port, job_path,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    res = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def _jax_halo_forward(kw, params, stacked, G):
    mesh = create_mesh(num_data=1, num_graph=G, devices=jax.devices()[:G])
    gm = JaxGNN(JaxConfig(**kw, graph_axis="graph"))

    def fwd(p, b):
        local = jax.tree_util.tree_map(lambda x: x[0], b)
        return gm.apply(p, local, deterministic=True).predictions

    return np.asarray(jax.jit(jax.shard_map(fwd, mesh=mesh, in_specs=(P(), P(("graph",))),
                                            out_specs=P(), check_vma=False))(params, stacked))


def _close(got, want, what):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    print(f"{what}: max|d| {err:.2e}")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6, err_msg=what)


def test_two_rank_halo_forward_matches_jax_and_single_device(tmp_path, monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    rng = np.random.default_rng(3)
    port_b, jax_b = _batches(rng, n=6, big=40)
    stacked, stats = port_halo.partition_halo(port_b, 2, return_stats=True, binned=True, ab=16)
    assert stats.cut_edges > 0 and stats.split_molecules >= 1 and stats.halo_rows > 0
    jstacked = jax_halo.partition_halo(jax_b, 2, binned=True, ab=16)
    pools = ("attention", "mean", "sum", "max")
    cfgs = {pt: (GNNConfig(pooling_type=pt, **KW), init_params(GNNConfig(pooling_type=pt, **KW),
                                                               seed=2)) for pt in pools}
    res = _run_ranks(tmp_path, {"kind": "forward", "grid": (1, 2),
                                "stacked": stack_batches([stacked]),
                                "cfgs": cfgs}, 2)
    single = attach_flat_layouts(port_b).to("cpu")  # the unpartitioned batch, in its order
    for pt, (cfg, flat) in cfgs.items():
        np.testing.assert_array_equal(res[0][pt], res[1][pt])  # replicated over the graph axis
        ref = _jax_halo_forward(dict(KW, pooling_type=pt), _tree(flat), jstacked, 2)
        _close(res[0][pt], ref, f"{pt}: ranks vs JAX halo")
        model = GNN(cfg)
        model.load_state_dict(params_from_flax(flat))
        with torch.no_grad():
            own = model(single).predictions.numpy()
        _close(res[0][pt], own, f"{pt}: ranks vs single device")


def test_four_rank_train_step_matches_jax_and_weighted_mean(tmp_path, monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    rng = np.random.default_rng(4)
    pairs = [_batches(rng, n=8), _batches(rng, n=8, big=40)]
    parts, _ = port_halo.partition_halo_stack([p for p, _ in pairs], 2, binned=True, ab=32)
    jparts, _ = jax_halo.partition_halo_stack([j for _, j in pairs], 2, binned=True, ab=32)
    lr = 1e-3
    cfg = GNNConfig(pooling_type="attention", **KW)
    flat = init_params(cfg, seed=6)
    res = _run_ranks(tmp_path, {"kind": "step", "grid": (2, 2), "stacked": stack_batches(parts),
                                "cfg": cfg, "params": flat, "lr": lr}, 4)
    for r in res[1:]:  # the update is the same on every rank
        assert r["loss"] == res[0]["loss"] and r["n"] == res[0]["n"]
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)

    # JAX: make_graph_parallel_train_step on a (data 2, graph 2) mesh
    tc = JaxTrainConfig(learning_rate=lr, task_type="multitask")
    params = _tree(flat)
    opt = jax_make_optimizer(tc, params)
    mesh = create_mesh(num_data=2, num_graph=2, devices=jax.devices()[:4])
    step = make_graph_parallel_train_step(JaxGNN(JaxConfig(**KW)), tc, opt, mesh)
    jstacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *jparts)
    p_halo, _, loss_halo, n_halo = step(jax.tree_util.tree_map(jnp.copy, params),
                                        opt.init(params), jstacked, jnp.float32(lr),
                                        jax.random.PRNGKey(7))
    np.testing.assert_allclose(res[0]["loss"], float(loss_halo), rtol=1e-5)
    assert res[0]["n"] == float(n_halo) == 16.0
    flat_halo = {k: np.asarray(v) for k, v in _flat(p_halo).items()}

    # the port on one device: the weighted mean of the data shards' gradients
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    tcp = trainer.TrainConfig(learning_rate=lr, task_type="multitask")
    opt_t = trainer.make_optimizer(model, tcp)
    loss_fn = trainer.make_loss_fn(tcp)
    grads, loss_sum, n_sum = None, 0.0, 0.0
    for pb, _ in pairs:
        b = bin_pack_batch(pb, ab=64, mb=16).to("cpu")  # the unpartitioned shard
        opt_t.zero_grad()
        n = float(b.graph_mask.sum())
        loss = loss_fn(model(b, train=True).predictions, b.targets, b.graph_mask)
        loss.backward()
        g = [p.grad.clone() * n if p.grad is not None else None for p in opt_t.params]
        grads = g if grads is None else [a + c if a is not None else None for a, c in zip(grads, g)]
        loss_sum, n_sum = loss_sum + float(loss.detach()) * n, n_sum + n
    for p, g in zip(opt_t.params, grads):
        p.grad = None if g is None else g / n_sum
    opt_t.step(lr)
    np.testing.assert_allclose(res[0]["loss"], loss_sum / n_sum, rtol=1e-5)
    mean_ref = params_to_flax(model.state_dict(), cfg)
    for k, v in res[0]["params"].items():
        np.testing.assert_allclose(v, flat_halo[k], rtol=2e-4, atol=2e-5, err_msg=f"JAX {k}")
        np.testing.assert_allclose(v, mean_ref[k], rtol=2e-4, atol=2e-5, err_msg=f"mean {k}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
