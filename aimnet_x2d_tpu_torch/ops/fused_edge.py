"""Edge aggregation of the flat (non-binned) layout, forward and backward
(counterpart of aimnet_x2d_tpu/ops/fused_edge.py::fused_edge_aggregate).

``out[a] = sum over the real edges e with dst(e) = a of x[src(e)]``: the
union of hops with multiplicities (quirk Q1), an (A, D) fp32 array.  With
``exact=False`` (bf16 models) the operand is rounded to bf16 before the
sum, as the TPU kernel's default-precision products round it; with
``exact=True`` (fp32 models) it is summed in fp32.  The backward is the same
sum on the source-keyed layout, ``dx[src] += g[dst]``: it gets the fp32
cotangent of the fp32 output (the layer casts after the op), rounds it to
bf16 when ``exact=False``, and casts the fp32 result to x's dtype.

The layout is built on the host, once per batch (:func:`build_layouts`):
a CSR keyed by destination (``row_ptr`` (A + 1,), ``col`` (E,) int32, each
row's edges in the collate order, dst-major then hop) for the forward and
its transpose keyed by source for the backward.  Each carries the kernel's
tiles: for every ``TILE_ROWS`` consecutive rows, the source rows their edges
read, as intervals of whole ``GROUP``-row groups, and each edge's row in the
tile's shared-memory image of those intervals (:func:`tile_intervals`).
The TPU package's window/source-block layout, its alignment and its minimum
batch size are not carried over: every flat batch, whatever its size, runs
the kernel.

On a CUDA tensor :func:`fused_edge_aggregate` launches the hand-written
kernel (``csrc/fused_edge.cu``, ``edge_agg``) through :func:`fused_edge_fwd`
and, in the backward, :func:`fused_edge_bwd`, each with its own launch
count and its launches by route (``routes``): the span route (one block a
tile, its rows summed from its image in shared memory) where every tile's
image fits ``STAGE_BUDGET`` bytes, else the direct route (a warp a row,
gathering from device memory) -- :func:`stage_plan`.  On a CPU tensor it
runs :func:`fused_edge_plain`.  There is no plain path on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from . import cuda_build

Array = Union[np.ndarray, torch.Tensor]

TILE_ROWS = 32  # destination rows of a kernel block (a tile)
GROUP = 8  # source rows are staged in aligned groups of 8: 16-byte copies whatever D is
GAP_GROUPS = 1  # empty groups an interval may hold before a new one starts
STAGE_BUDGET = 48 * 1024  # shared-memory bytes a tile's image may take on the span route
INDEX_BUDGET = 4096  # edges whose indices a tile keeps in shared memory


@dataclasses.dataclass
class EdgeLayout:
    """CSR of the real edges keyed by one end (the destination for the
    forward, the source for the backward): row ``a`` holds the other ends
    ``col[row_ptr[a]:row_ptr[a + 1]]``; with the kernel's tiles of
    ``TILE_ROWS`` rows (:func:`tile_intervals`).  numpy on the host, torch
    tensors after :meth:`to`, but for ``image_rows`` and ``tile_edges``,
    which stay on the host (the wrapper sizes the launch from them)."""

    row_ptr: Array  # (A + 1,) int32
    col: Array  # (E,) int32
    col_local: Array  # (E,) int32: col[e]'s row in its tile's image
    tile_iv: Array  # (tiles + 1,) int32: tile t's intervals are iv[tile_iv[t]:tile_iv[t + 1]]
    iv: Array  # (intervals, 3) int32: first source row, rows, first row in the image
    image_rows: np.ndarray  # (tiles,) int64: rows of each tile's image
    tile_edges: np.ndarray  # (tiles,) int64: each tile's edges

    @property
    def num_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.col.shape[0])

    def to(self, device: "str | torch.device", copy=None) -> "EdgeLayout":
        """The layout with its arrays on ``device``, each copied by ``copy``
        (a host tensor -> its device copy) when given."""
        copy = copy or (lambda t: t.to(device))

        def move(a):
            return copy(torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
                        else a)

        return EdgeLayout(move(self.row_ptr), move(self.col), move(self.col_local),
                          move(self.tile_iv), move(self.iv), self.image_rows, self.tile_edges)


def tile_intervals(row_ptr: np.ndarray, col: np.ndarray, tile_rows: int = TILE_ROWS):
    """The kernel's tiles of a CSR: rows [t * tile_rows, (t + 1) * tile_rows)
    read the source rows of their edges, which collate's packing keeps in a
    few runs.  Each tile's source rows, in ``GROUP``-row groups, become
    intervals of consecutive groups (a gap of more than ``GAP_GROUPS`` empty
    groups starts a new one), laid one after another in the tile's image.
    Returns (col_local (E,): each edge's source row in its tile's image;
    tile_iv (tiles + 1,): each tile's first interval; iv (intervals, 3):
    first source row (a multiple of GROUP), rows (a multiple of GROUP, may
    pass the last row), first row in the image; image_rows (tiles,);
    tile_edges (tiles,)), int32 but the last two."""
    A = len(row_ptr) - 1
    tiles = -(-A // tile_rows)
    col = np.asarray(col, np.int64)
    bounds = np.asarray(row_ptr, np.int64)[np.minimum(np.arange(tiles + 1) * tile_rows, A)]
    if col.size == 0:
        return (np.zeros(0, np.int32), np.zeros(tiles + 1, np.int32), np.zeros((0, 3), np.int32),
                np.zeros(tiles, np.int64), np.diff(bounds))
    # each tile's occupied groups, marked in a bitmap over the tile's own range of groups
    group = col // GROUP
    busy = np.flatnonzero(np.diff(bounds) > 0)
    lo = np.zeros(tiles, np.int64)
    width = np.zeros(tiles, np.int64)
    lo[busy] = np.minimum.reduceat(group, bounds[busy])
    width[busy] = np.maximum.reduceat(group, bounds[busy]) - lo[busy] + 1
    offset = np.cumsum(width) - width
    where = np.repeat(offset - lo, np.diff(bounds)) + group
    marked = np.zeros(int(width.sum()), bool)
    marked[where] = True
    pos = np.flatnonzero(marked)  # the occupied (tile, group) pairs, in order
    ktile = np.searchsorted(offset, pos, side="right") - 1
    kgroup = pos - offset[ktile] + lo[ktile]
    new = np.ones(pos.size, bool)
    new[1:] = (ktile[1:] != ktile[:-1]) | (kgroup[1:] - kgroup[:-1] > 1 + GAP_GROUPS)
    first = np.flatnonzero(new)
    last = np.append(first[1:], pos.size) - 1
    iv_tile = ktile[first]
    rows = (kgroup[last] - kgroup[first] + 1) * GROUP
    tile_iv = np.searchsorted(iv_tile, np.arange(tiles + 1))
    # each interval's first image row: the rows of the tile's intervals before it
    base = np.cumsum(rows) - rows
    base -= base[tile_iv[iv_tile]]
    image_rows = np.zeros(tiles, np.int64)
    filled = tile_iv[1:] > tile_iv[:-1]
    image_rows[filled] = (base + rows)[tile_iv[1:][filled] - 1]
    iv = np.stack([kgroup[first] * GROUP, rows, base], 1)
    # an edge's image row: its source row shifted by its interval's shift
    shift = (base - kgroup[first] * GROUP)[np.cumsum(new) - 1]  # by occupied pair
    col_local = col + np.repeat(shift, np.diff(np.append(pos, marked.size)))[where]
    return (col_local.astype(np.int32), tile_iv.astype(np.int32), iv.astype(np.int32),
            image_rows, np.diff(bounds))


def build_layout(edge_src: np.ndarray, edge_dst: np.ndarray, edge_mask: np.ndarray,
                 num_atoms: int) -> EdgeLayout:
    """The destination-keyed CSR of the real (masked-in) edges, each row in
    the edges' input order, with its tiles of ``TILE_ROWS`` rows
    (:func:`tile_intervals`).
    Raises on a real edge whose end lies outside [0, num_atoms)."""
    m = np.asarray(edge_mask, bool)
    src = np.asarray(edge_src)[m].astype(np.int64)
    dst = np.asarray(edge_dst)[m].astype(np.int64)
    for name, v in (("source", src), ("destination", dst)):
        if v.size and (v.min() < 0 or v.max() >= num_atoms):
            raise ValueError(f"an edge {name} lies outside the {num_atoms} atom slots")
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(num_atoms + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=num_atoms), out=row_ptr[1:])
    col = src[order]
    return EdgeLayout(row_ptr.astype(np.int32), col.astype(np.int32),
                      *tile_intervals(row_ptr, col))


def build_layouts(edge_src: np.ndarray, edge_dst: np.ndarray, edge_mask: np.ndarray,
                  num_atoms: int) -> Tuple[EdgeLayout, EdgeLayout]:
    """(forward, backward) layouts: the backward swaps the ends
    (``dx[src] += g[dst]``)."""
    return (build_layout(edge_src, edge_dst, edge_mask, num_atoms),
            build_layout(edge_dst, edge_src, edge_mask, num_atoms))


def _rounded(x: torch.Tensor, exact: bool) -> torch.Tensor:
    return x if exact else x.to(torch.bfloat16)


def fused_edge_plain(x: torch.Tensor, layout: EdgeLayout, exact: bool) -> torch.Tensor:
    """Plain PyTorch version: x (A, D) -> (A, D) fp32, the sum over each
    CSR row of x's rows (rounded to bf16 first unless ``exact``)."""
    A = layout.num_rows
    row_ptr, col = layout.row_ptr.long(), layout.col.long()
    rows = torch.repeat_interleave(torch.arange(A, device=x.device), row_ptr.diff())
    out = torch.zeros(A, x.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add_(0, rows, _rounded(x, exact)[col].float())


def lib() -> ctypes.CDLL:
    """The built ``csrc/fused_edge.cu`` (kernels 7 and 8), typed for ctypes."""
    return type_lib(cuda_build.load("fused_edge"))


def type_lib(so: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a build of ``csrc/fused_edge.cu``
    (once)."""
    if not getattr(so, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        so.edge_agg.argtypes = [vp, vp, vp, vp, vp, vp, vp] + [i] * 7 + [vp]
        so.edge_agg.restype = i
        so.wseg_sum.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
        so.wseg_sum.restype = i
        so.fused_edge_error_string.argtypes = [i]
        so.fused_edge_error_string.restype = ctypes.c_char_p
        so._typed = True
    return so


def stage_plan(layout: EdgeLayout, D: int, stage_bytes_per_value: int) -> int:
    """The launch's route: the span route when every tile's image (rows x D
    values) fits ``STAGE_BUDGET`` bytes of shared memory -- then the bytes
    of the largest image, which each block gets -- else the direct route,
    -1 (a launch mixing the two routes ran slower than either, on an H100)."""
    need = int(layout.image_rows.max(initial=0)) * D * stage_bytes_per_value
    return need if need <= STAGE_BUDGET else -1


def _launch(what: str, x: torch.Tensor, layout: EdgeLayout, exact: bool, routes: dict,
            so: "ctypes.CDLL | None" = None) -> torch.Tensor:
    """Launch ``edge_agg`` of ``so`` (the built library by default) on the
    current stream and count its route; raise on any input the kernel does
    not take and on any launch error."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"{what}: x must be a 2-D float32 or bfloat16 tensor, got {x.dtype}")
    arrays = (("row_ptr", layout.row_ptr), ("col", layout.col), ("col_local", layout.col_local),
              ("tile_iv", layout.tile_iv), ("iv", layout.iv))
    if any(a.dtype != torch.int32 for _, a in arrays):
        raise TypeError(f"{what}: the layout must be int32")
    cuda_build.check_cuda(what, x.device, ("x", x, 4 if x.dtype == torch.float32 else 2),
                          *((n, a, 4) for n, a in arrays))
    A, D = x.shape
    if layout.num_rows != A:
        raise ValueError(f"{what}: a layout of {layout.num_rows} rows for {A} atoms")
    tiles = layout.image_rows.shape[0]
    if tiles != -(-A // TILE_ROWS) or layout.tile_iv.shape[0] != tiles + 1:
        raise ValueError(f"{what}: the layout's tiles do not cover its rows")
    if A * D >= 2**31:
        raise ValueError(f"{what}: {A} x {D} values exceed the kernel's 32-bit indices")
    out = torch.empty(A, D, dtype=torch.float32, device=x.device)
    if A and D:
        stage_bf16 = x.dtype == torch.bfloat16 or not exact
        stage_bytes = stage_plan(layout, D, 2 if stage_bf16 else 4)
        idx_cap = int(min(layout.tile_edges.max(), INDEX_BUDGET))
        so = lib() if so is None else type_lib(so)
        ptr = lambda t: t.data_ptr() if t.numel() else None  # noqa: E731
        status = so.edge_agg(
            x.data_ptr(), *(ptr(a) for _, a in arrays), out.data_ptr(),
            int(x.dtype == torch.bfloat16), int(stage_bf16), A, D, TILE_ROWS, stage_bytes,
            idx_cap, torch.cuda.current_stream(x.device).cuda_stream,
        )
        if status != 0:
            raise RuntimeError(f"{what}: {so.fused_edge_error_string(status).decode()}")
        routes["span" if stage_bytes >= 0 else "direct"] += 1
    return out


def fused_edge_fwd(x: torch.Tensor, layout: EdgeLayout, exact: bool) -> torch.Tensor:
    """The forward on the card: x (A, D) on the destination-keyed layout ->
    (A, D) fp32."""
    out = _launch("fused_edge_fwd", x, layout, exact, fused_edge_fwd.routes)
    fused_edge_fwd.launches += 1
    return out


fused_edge_fwd.launches = 0
fused_edge_fwd.routes = {"span": 0, "direct": 0}  # launches by route


def fused_edge_bwd(g: torch.Tensor, layout: EdgeLayout, exact: bool) -> torch.Tensor:
    """The backward on the card: the fp32 cotangent g (A, D) on the
    source-keyed layout -> dx (A, D) fp32 (the caller casts to x's dtype)."""
    out = _launch("fused_edge_bwd", g, layout, exact, fused_edge_bwd.routes)
    fused_edge_bwd.launches += 1
    return out


fused_edge_bwd.launches = 0
fused_edge_bwd.routes = {"span": 0, "direct": 0}


class _FusedEdgeFn(torch.autograd.Function):
    """The aggregation with the JAX custom VJP: kernels on CUDA tensors,
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, exact):
        ctx.layout, ctx.exact, ctx.dtype = bwd, exact, x.dtype
        if x.device.type == "cuda":
            return fused_edge_fwd(x, fwd, exact)
        if x.device.type == "cpu":
            return fused_edge_plain(x, fwd, exact)
        raise ValueError(f"fused_edge_aggregate: unsupported device {x.device}")

    @staticmethod
    def backward(ctx, g):
        g = g.float().contiguous()
        bwd = fused_edge_bwd if g.device.type == "cuda" else fused_edge_plain
        dx = bwd(g, ctx.layout, ctx.exact).to(ctx.dtype)
        return dx, None, None, None


def fused_edge_aggregate(x: torch.Tensor, fwd_layout: EdgeLayout, bwd_layout: EdgeLayout,
                         exact: bool = False) -> torch.Tensor:
    """Differentiable ``out[a] = sum_{dst(e)=a} x[src(e)]``: x (A, D) ->
    (A, D) fp32.  ``fwd_layout`` / ``bwd_layout`` are the batch's
    ``fused_fwd`` / ``fused_bwd`` on x's device."""
    return _FusedEdgeFn.apply(x.contiguous(), fwd_layout, bwd_layout, bool(exact))
