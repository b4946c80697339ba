"""Windowed segment sum over a windowed-CSR edge layout (counterpart of
aimnet_x2d_tpu/ops/pallas_segment.py).

:func:`windowed_layout` groups the real edges by destination window on the
host (a numpy copy of the JAX function); :func:`pallas_windowed_segment_sum`
gathers the source rows outside the kernel, as the JAX op does, and sums
each window's slots into its window-local rows:

    out[w*window + s] = sum over slots i of window w with seg_local[i] == s of data[i]

Padding slots (``seg_local == window``) are dropped.  With ``exact=False``
the data is rounded to bf16 before the sum (the TPU kernel's default
precision rounds its data operand; the JAX CPU interpreter does not, so the
port rounds explicitly).  The output is (W*window, D) fp32; slice ``[:A]``
for the per-atom sums.  The op is forward only, as the JAX op is, and lies
on no model path of either package.

On a CUDA tensor it launches the hand-written kernel (``csrc/fused_edge.cu``,
``wseg_sum``: a block per window and part of its segments sorts the
window's slots by segment in shared memory, then a warp a segment sums its
rows in slot order); on a CPU tensor it runs
:func:`windowed_segment_sum_plain`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import cuda_build
from .fused_edge import lib


def windowed_layout(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_mask: np.ndarray,
    num_atoms: int,
    window: int = 256,
    chunk: int = 256,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Host-side regrouping of edges by destination atom window.

    Returns (src_perm, seg_local, num_windows, cap): ``src_perm`` (W*cap,)
    int32, the source atom per slot (0 for padding); ``seg_local`` (W*cap,)
    int32, dst - window base per slot, ``window`` for padding slots; cap is
    the per-window edge capacity, rounded up to ``chunk``."""
    W = -(-num_atoms // window)
    src = np.asarray(edge_src)[np.asarray(edge_mask)]
    dst = np.asarray(edge_dst)[np.asarray(edge_mask)]
    win_of = dst // window
    order = np.argsort(win_of, kind="stable")
    src, dst, win_of = src[order], dst[order], win_of[order]
    counts = np.bincount(win_of, minlength=W)
    cap = int(max(counts.max() if counts.size else 1, 1))
    cap = -(-cap // chunk) * chunk

    src_perm = np.zeros(W * cap, np.int32)
    seg_local = np.full(W * cap, window, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for w in range(W):
        n = counts[w]
        if n:
            sl = slice(w * cap, w * cap + n)
            src_perm[sl] = src[starts[w] : starts[w] + n]
            seg_local[sl] = dst[starts[w] : starts[w] + n] - w * window
    return src_perm, seg_local, W, cap


def windowed_segment_sum_plain(data: torch.Tensor, seg_local: torch.Tensor, num_windows: int,
                               cap: int, window: int, exact: bool) -> torch.Tensor:
    """Plain PyTorch version: data (W*cap, D) -> (W*window, D) fp32."""
    n_out = num_windows * window
    seg = seg_local.long()
    base = torch.arange(num_windows, device=data.device).repeat_interleave(cap) * window
    ids = torch.where(seg < window, base + seg, torch.full_like(seg, n_out))
    d = data if exact else data.to(torch.bfloat16)
    out = torch.zeros(n_out + 1, data.shape[1], dtype=torch.float32, device=data.device)
    return out.index_add_(0, ids, d.float())[:n_out]


def wseg_sum(data: torch.Tensor, seg_local: torch.Tensor, num_windows: int, cap: int,
             window: int, exact: bool) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: data (W*cap, D) fp32 ->
    (W*window, D) fp32.  Raises on any input the kernel does not take and on
    any launch error."""
    what = "wseg_sum"
    if data.dtype != torch.float32 or seg_local.dtype != torch.int32:
        raise TypeError(f"{what}: data must be float32 and seg_local int32")
    cuda_build.check_cuda(what, data.device, ("data", data, 4), ("seg_local", seg_local, 4))
    D = data.shape[1]
    if data.shape[0] != num_windows * cap or seg_local.shape != (num_windows * cap,):
        raise ValueError(f"{what}: data {tuple(data.shape)}, seg_local {tuple(seg_local.shape)}, "
                         f"need {num_windows} windows x {cap} slots")
    out = torch.empty(num_windows * window, D, dtype=torch.float32, device=data.device)
    if num_windows and D:
        so = lib()
        status = so.wseg_sum(data.data_ptr(), seg_local.data_ptr(), out.data_ptr(), num_windows,
                             D, window, cap, int(not exact),
                             torch.cuda.current_stream(data.device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"{what}: {so.fused_edge_error_string(status).decode()}")
        wseg_sum.launches += 1
    return out


wseg_sum.launches = 0


def pallas_windowed_segment_sum(
    x: torch.Tensor,
    src_perm: torch.Tensor,
    seg_local: torch.Tensor,
    num_atoms: int,
    num_windows: int,
    cap: int,
    window: int = 256,
    chunk: int = 256,
    exact: bool = True,
) -> torch.Tensor:
    """``out[a] = sum_{edges e with dst(e)=a} x[src(e)]`` via the windowed
    layout: x (A, D) float -> (W*window, D) fp32 (the JAX signature, less
    ``interpret``; ``num_atoms`` and ``chunk`` only describe the layout)."""
    del num_atoms, chunk
    valid = (seg_local < window)[:, None]
    data = torch.where(valid, x[src_perm.long()], torch.zeros((), dtype=x.dtype, device=x.device))
    data = data.float().contiguous()
    seg = seg_local.contiguous()
    if data.device.type == "cuda":
        return wseg_sum(data, seg.to(torch.int32), num_windows, cap, window, exact)
    return windowed_segment_sum_plain(data, seg, num_windows, cap, window, exact)
