"""One rank of the port's multi-rank graph-axis tests (tests/test_torch_halo_ranks.py,
tests/test_torch_halo_config3.py, tests/test_torch_edge_shards.py).

    python tests/torch_halo_worker.py RANK WORLD PORT JOB.pkl OUT_DIR

Imports the port only (never JAX).  Joins a gloo process group at
``localhost:PORT``, builds the (data, graph) grid of the job and runs it on
this rank's shard of the job's stacked host batches:

- ``forward``: the serving forward of each (config, flax parameters[,
  batch key]) entry, predictions saved, and partial charges (this rank's
  atoms) under ``<name>/charges`` where the model has them; ``stacked`` is
  one stacked batch or a dict of them, which the batch key picks from;
- ``step``: one train step of the grid (parallel/graph_parallel.py) with
  Adam at the job's learning rate; the loss, the molecule count and the
  updated parameters (flax names) saved;
- ``edge_step``: for each entry of ``steps`` (config, flax parameters,
  learning rate, dropout seed or None) one train step of the grid from
  those parameters, the dropout generator seeded ``seed +
  trainer.DATA_SEED_STRIDE * data index`` as ``trainer.train`` seeds it;
  the list of (loss, molecule count, updated parameters) saved.

A configuration with ``graph_axis`` set runs edge-replicated on batches
without halo arrays (data/batching.py ``shard_edges``).

Writes ``OUT_DIR/rank{RANK}.pkl``.
"""

import os
import pickle
import sys


def main() -> None:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    job_path, out_dir = sys.argv[4], sys.argv[5]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from aimnet_x2d_tpu_torch.checkpoint import params_from_flax, params_to_flax
    from aimnet_x2d_tpu_torch.data.batching import index_batch
    from aimnet_x2d_tpu_torch.models.gnn import GNN
    from aimnet_x2d_tpu_torch.parallel import mesh, multihost
    from aimnet_x2d_tpu_torch.training import trainer

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    n_data, n_graph = job["grid"]
    cpu = torch.device("cpu")
    multihost.initialize(f"localhost:{port}", world, rank, "gloo", cpu)
    out = {}
    try:
        grid = mesh.make_grid(n_data, n_graph, cpu, "gloo")
        stacked = job["stacked"]
        if not isinstance(stacked, dict):
            stacked = {None: stacked}
        batches = {k: index_batch(v, grid.data.index, grid.graph.index).to(cpu)
                   for k, v in stacked.items()}
        batch = next(iter(batches.values()))
        if job["kind"] == "forward":
            for name, spec in job["cfgs"].items():
                cfg, flat, key = (*spec, None)[:3]
                model = GNN(cfg)
                model.load_state_dict(params_from_flax(flat))
                with torch.no_grad():
                    o = model(batches[key])
                out[name] = o.predictions.numpy()
                if o.partial_charges is not None:
                    out[f"{name}/charges"] = o.partial_charges.numpy()
        else:
            def step(cfg, flat, lr, seed=None):
                model = GNN(cfg)
                model.load_state_dict(params_from_flax(flat))
                tc = trainer.TrainConfig(learning_rate=lr, task_type=cfg.task_type)
                opt = trainer.make_optimizer(model, tc)
                gen = None
                if seed is not None:
                    gen = torch.Generator().manual_seed(
                        seed + trainer.DATA_SEED_STRIDE * grid.data.index)
                loss, n = trainer.train_step(model, opt, batch, lr, trainer.make_loss_fn(tc),
                                             generator=gen, grid=grid)
                return {"loss": float(loss), "n": float(n),
                        "params": params_to_flax(model.state_dict(), cfg)}

            if job["kind"] == "edge_step":
                out = [step(*spec) for spec in job["steps"]]
            else:
                out = step(job["cfg"], job["params"], job["lr"])
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        multihost.sync()
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
