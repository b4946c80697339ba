"""The (data, graph) rank grid and its collectives (counterpart of
aimnet_x2d_tpu/parallel/mesh.py and of the ``lax`` collectives the JAX
package uses inside ``shard_map``).

``num_devices x graph_shards`` ranks, one process each, form a grid:
rank r sits at data index ``r // G`` and graph index ``r % G``, as the JAX
mesh lays its devices out (``devices.reshape(n_data, n_graph)``).  Each
rank's graph axis is the process subgroup of its data index (the G ranks
that share one data shard, partitioned atom-wise), its data axis the
subgroup of its graph index.  :func:`make_grid` builds the groups once per
process (every rank must call it) and registers them, so the model resolves
``GNNConfig.graph_axis = "graph"`` with :func:`axis`, as JAX resolves an
axis name inside ``shard_map``.

Collectives on an :class:`Axis`, autograd-aware where the JAX package
differentiates through them:

- ``psum``: the sum over the axis; its backward is the psum of the
  cotangents (the exact transpose of a sum replicated to every rank);
- ``pmax``: the maximum over the axis, no gradient (JAX only takes it of
  stop-gradient values);
- ``all_gather``: (G, ...) of every rank's tensor; its backward sums the
  cotangents over the axis and keeps this rank's slice;
- ``all_to_all``: chunk g of a (G, ...) tensor to rank g; its backward is
  the same exchange of the cotangents.

Backends: NCCL when every rank has a card of its own, gloo when ranks share
a card or run on the CPU.  Gloo takes CUDA tensors in ``all_reduce`` and
``broadcast`` only, so on a card ``all_gather`` and ``all_to_all`` copy their
tensor to the host, exchange it there and copy the result back
(``Axis.staged``); every other collective acts on the card's tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from . import multihost

# gloo ops that take no CUDA tensors: staged through the host on a card
GLOO_HOST_ONLY = ("all_gather", "all_to_all")


@dataclasses.dataclass
class Axis:
    """One axis of the grid as this rank sees it: its size, this rank's
    index along it and the process group of the ranks along it (None when
    the axis has size 1)."""

    name: str
    size: int
    index: int
    group: Optional[object]
    staged: tuple = ()  # ops copied through the host (see the module docstring)

    def _on_host(self, op: str, x: torch.Tensor) -> bool:
        return op in self.staged and x.is_cuda

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place, no autograd; returns ``x``."""
        if self.size > 1:
            dist.all_reduce(x, op=op, group=self.group)
        return x

    def all_gather_raw(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x[None]
        src = (x.cpu() if self._on_host("all_gather", x) else x).contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return torch.stack(out).to(x.device)

    def all_to_all_raw(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        src = x.cpu() if self._on_host("all_to_all", x) else x
        src = src.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(x.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _PSum.apply(x, self) if self.size > 1 else x

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(x.detach().clone(), dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return _AllGather.apply(x, self) if self.size > 1 else x[None]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return _AllToAll.apply(x, self) if self.size > 1 else x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return ax.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_reduce(g.contiguous().clone()), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return ax.all_gather_raw(x)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        return ax.all_reduce(g.contiguous().clone())[ax.index], None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return ax.all_to_all_raw(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_to_all_raw(g), None


@dataclasses.dataclass
class Grid:
    """This rank's place in the (data, graph) grid."""

    n_data: int
    n_graph: int
    rank: int
    device: torch.device
    data: Axis
    graph: Axis
    world: Axis

    @property
    def size(self) -> int:
        return self.n_data * self.n_graph


_AXES: Dict[str, Axis] = {}


def axis(name: str) -> Axis:
    """The registered axis ``name`` ("data", "graph" or "world")."""
    if name not in _AXES:
        raise RuntimeError(f"no grid axis {name!r}: parallel.mesh.make_grid has not run")
    return _AXES[name]


def local_rank_device(rank: int, device: str) -> torch.device:
    """Rank ``rank``'s device: ``cuda:{local rank % cards}`` or the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_grid(n_data: int, n_graph: int, device: torch.device, backend: str) -> Grid:
    """Build the axes' process groups of an initialized world of
    ``n_data * n_graph`` ranks and register them; every rank calls it."""
    world, rank = multihost.process_count(), multihost.process_index()
    if world != n_data * n_graph:
        raise ValueError(f"{world} ranks for a {n_data} x {n_graph} grid")
    staged = GLOO_HOST_ONLY if backend == "gloo" else ()
    d, g = divmod(rank, n_graph)
    graph_group = data_group = None
    # new_group must be entered by every rank, for every group, in one order
    for dd in range(n_data):
        grp = dist.new_group([dd * n_graph + gg for gg in range(n_graph)]) if n_graph > 1 else None
        if dd == d:
            graph_group = grp
    for gg in range(n_graph):
        grp = dist.new_group([dd * n_graph + gg for dd in range(n_data)]) if n_data > 1 else None
        if gg == g:
            data_group = grp
    grid = Grid(
        n_data, n_graph, rank, device,
        data=Axis("data", n_data, d, data_group, staged),
        graph=Axis("graph", n_graph, g, graph_group, staged),
        world=Axis("world", world, rank, dist.group.WORLD if world > 1 else None, staged),
    )
    _AXES.update(data=grid.data, graph=grid.graph, world=grid.world)
    return grid
