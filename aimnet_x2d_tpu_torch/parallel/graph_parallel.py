"""The rule of the train step over the (data, graph) rank grid
(``training/trainer.py::train_step`` with ``grid``; counterpart of
aimnet_x2d_tpu/parallel/graph_parallel.py::make_graph_parallel_train_step and
of the data-parallel step of aimnet_x2d_tpu/training/trainer.py).

Each rank holds its (data d, graph g) shard: with G > 1 a halo shard of data
shard d (the model pools over the graph axis, so every graph rank of d ends
with the same molecule embeddings, loss and head) or an edge shard of it
(data/batching.py ``shard_edges``: every atom replicated, a slice of the
edges, each layer's partial aggregate psummed over the graph axis, so every
graph rank of d computes the same dense forward), with G = 1 the whole data
shard.  One step:

- forward with dropout: the caller seeds the layers' seed and the FFN's
  generator per data rank (distinct across data ranks, identical across
  the graph ranks of one, as JAX folds the data index into the key); on
  edge shards the graph ranks of one then draw the same masks, because
  they draw them on the same replicated atoms;
- loss = sum_d loss_d n_d / sum_d n_d over the data ranks (n_d the real
  molecules of shard d), the same value on every rank;
- backward of this rank's share, ``loss_d n_d / (N G)``: each collective's
  backward is its exact transpose (parallel/mesh.py), so the cotangents
  reaching a graph rank through the pools' psums carry a factor G, which
  the 1/G takes out;
- every parameter gradient summed over all ranks (one ``all_reduce`` of the
  flattened gradients), which makes it the gradient of the single-device
  weighted mean; then the same clip and Adam update on every rank, so the
  parameters stay identical across ranks.

The same rule is exact on edge shards, with no second one.  Each graph rank
of d backprops 1/G of d's loss through the same replicated dense forward.
At a layer's psum the backward psums the cotangents, so every rank's
partial aggregate, and through it the rank's own edges, gets the whole
cotangent back.  On any replicated tensor the G ranks' cotangents are linear
in their 1/G shares plus their own edges' terms, and they sum to the one
device's cotangent there.  The all-reduce of the gradients thus adds the
dense parameters' G shares of 1/G each and the edge terms' disjoint parts.
"""

from __future__ import annotations

import torch

from .mesh import Grid


def grid_objective(loss: torch.Tensor, n: torch.Tensor, grid: Grid):
    """From this rank's mean ``loss`` over its ``n`` real molecules: (the
    objective this rank backprops, ``loss_d n_d / (N G)``; the weighted mean
    over the data ranks; their molecules), the last two detached and the
    same on every rank."""
    stats = grid.data.all_reduce(torch.stack([loss.detach() * n, n]))
    n_tot = stats[1].clamp(min=1.0)
    return loss * n / (n_tot * grid.n_graph), stats[0] / n_tot, stats[1]


def allreduce_grads(params, grid: Grid) -> None:
    """Sum every parameter's gradient over all ranks, in place (one
    collective over the flattened gradients)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or grid.size == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    grid.world.all_reduce(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()
