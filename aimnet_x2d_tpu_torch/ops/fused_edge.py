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
its transpose keyed by source for the backward.  The TPU package's
window/source-block layout, its alignment and its minimum batch size are
not carried over: every flat batch, whatever its size, runs the kernel.

On a CUDA tensor :func:`fused_edge_aggregate` launches the hand-written
kernel (``csrc/fused_edge.cu``, ``edge_agg``: one warp per destination row)
through :func:`fused_edge_fwd` and, in the backward, :func:`fused_edge_bwd`,
each with its own launch count; on a CPU tensor it runs
:func:`fused_edge_plain`.  There is no plain path on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from . import cuda_build

Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class EdgeLayout:
    """CSR of the real edges keyed by one end (the destination for the
    forward, the source for the backward): row ``a`` holds the other ends
    ``col[row_ptr[a]:row_ptr[a + 1]]``.  numpy on the host, torch tensors
    after :meth:`to`."""

    row_ptr: Array  # (A + 1,) int32
    col: Array  # (E,) int32

    @property
    def num_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.col.shape[0])

    def to(self, device: "str | torch.device") -> "EdgeLayout":
        def move(a):
            t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
            return t.to(device)

        return EdgeLayout(move(self.row_ptr), move(self.col))


def build_layout(edge_src: np.ndarray, edge_dst: np.ndarray, edge_mask: np.ndarray,
                 num_atoms: int) -> EdgeLayout:
    """The destination-keyed CSR of the real (masked-in) edges, each row in
    the edges' input order.  Raises on a real edge whose end lies outside
    [0, num_atoms)."""
    m = np.asarray(edge_mask, bool)
    src = np.asarray(edge_src)[m].astype(np.int64)
    dst = np.asarray(edge_dst)[m].astype(np.int64)
    for name, v in (("source", src), ("destination", dst)):
        if v.size and (v.min() < 0 or v.max() >= num_atoms):
            raise ValueError(f"an edge {name} lies outside the {num_atoms} atom slots")
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(num_atoms + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=num_atoms), out=row_ptr[1:])
    return EdgeLayout(row_ptr.astype(np.int32), src[order].astype(np.int32))


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
    so = cuda_build.load("fused_edge")
    if not getattr(so, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        so.edge_agg.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
        so.edge_agg.restype = i
        so.wseg_sum.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
        so.wseg_sum.restype = i
        so.fused_edge_error_string.argtypes = [i]
        so.fused_edge_error_string.restype = ctypes.c_char_p
        so._typed = True
    return so


def _launch(what: str, x: torch.Tensor, layout: EdgeLayout, exact: bool) -> torch.Tensor:
    """Launch ``edge_agg`` on the current stream; raise on any input the
    kernel does not take and on any launch error."""
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise TypeError(f"{what}: x must be a 2-D float32 or bfloat16 tensor, got {x.dtype}")
    row_ptr, col = layout.row_ptr, layout.col
    if row_ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"{what}: the layout must be int32")
    cuda_build.check_cuda(what, x.device, ("x", x, 4 if x.dtype == torch.float32 else 2),
                          ("row_ptr", row_ptr, 4), ("col", col, 4))
    A, D = x.shape
    if layout.num_rows != A:
        raise ValueError(f"{what}: a layout of {layout.num_rows} rows for {A} atoms")
    out = torch.empty(A, D, dtype=torch.float32, device=x.device)
    if A and D:
        so = lib()
        status = so.edge_agg(
            x.data_ptr(), row_ptr.data_ptr(), col.data_ptr() if col.numel() else None,
            out.data_ptr(), int(x.dtype == torch.bfloat16), A, D, int(not exact),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        if status != 0:
            raise RuntimeError(f"{what}: {so.fused_edge_error_string(status).decode()}")
    return out


def fused_edge_fwd(x: torch.Tensor, layout: EdgeLayout, exact: bool) -> torch.Tensor:
    """The forward on the card: x (A, D) on the destination-keyed layout ->
    (A, D) fp32."""
    out = _launch("fused_edge_fwd", x, layout, exact)
    fused_edge_fwd.launches += 1
    return out


fused_edge_fwd.launches = 0


def fused_edge_bwd(g: torch.Tensor, layout: EdgeLayout, exact: bool) -> torch.Tensor:
    """The backward on the card: the fp32 cotangent g (A, D) on the
    source-keyed layout -> dx (A, D) fp32 (the caller casts to x's dtype)."""
    out = _launch("fused_edge_bwd", g, layout, exact)
    fused_edge_bwd.launches += 1
    return out


fused_edge_bwd.launches = 0


class _FusedEdgeFn(torch.autograd.Function):
    """The aggregation with the JAX custom VJP: kernels on CUDA tensors,
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, fwd_ptr, fwd_col, bwd_ptr, bwd_col, exact):
        ctx.layout = EdgeLayout(bwd_ptr, bwd_col)
        ctx.exact, ctx.dtype = exact, x.dtype
        fwd = EdgeLayout(fwd_ptr, fwd_col)
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
        return dx, None, None, None, None, None


def fused_edge_aggregate(x: torch.Tensor, fwd_layout: EdgeLayout, bwd_layout: EdgeLayout,
                         exact: bool = False) -> torch.Tensor:
    """Differentiable ``out[a] = sum_{dst(e)=a} x[src(e)]``: x (A, D) ->
    (A, D) fp32.  ``fwd_layout`` / ``bwd_layout`` are the batch's
    ``fused_fwd`` / ``fused_bwd`` on x's device."""
    return _FusedEdgeFn.apply(x.contiguous(), fwd_layout.row_ptr, fwd_layout.col,
                              bwd_layout.row_ptr, bwd_layout.col, bool(exact))
