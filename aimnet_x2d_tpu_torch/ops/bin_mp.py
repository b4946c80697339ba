"""Fused message-passing stack over the bin-packed layout, forward
(counterpart of aimnet_x2d_tpu/ops/bin_mp.py::binned_mp_stack_t).

Per bin and per layer (reference semantics under quirk Q1, union of hops):

    agg = adj @ x                   (int8 multiplicity adjacency)
    h   = act([x | agg] W_in + b_in)
    s   =     [x | agg] W_s  + b_s
    blocks: h = h + W2 act(W1 h + b1) + b2
    x   = (h + s) + x

in the feature-major layout: x is (D, A) with A = nb * ab.  On a CUDA tensor
:func:`binned_mp_stack_t` launches the hand-written kernel
(``csrc/mp_stack.cu``); on a CPU tensor it runs :func:`mp_stack_plain`, the
plain PyTorch version of the same arithmetic.  Both take the weights
prepped once per model load (:func:`stack_weights`).

Cast points (as the JAX kernel): fp32 accumulation -> cast to the compute
dtype -> bias add in the compute dtype -> activation; the residual adds
round to the compute dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence

import torch

from ..utils.activation import ACTIVATION_CODES, get_activation_function
from . import cuda_build


def padded_dim(D: int) -> int:
    """D rounded up to a multiple of 16 (the kernel's tile height)."""
    return -(-D // 16) * 16


def prep_layer(lw: Sequence[torch.Tensor], dt: torch.dtype, Dp: int) -> List[torch.Tensor]:
    """One layer's fp32 weights ``(w_in0, w_in1, b_in, w_s0, w_s1, b_s,
    [w1, b1, w2, b2] x blocks)`` — kernels in (in, out) orientation, as
    ``ShellConvolutionLayer.stack_weights`` hands them — in the kernel's
    form: input/skip pairs stacked into (Dp, 2Dp) matrices, every matrix
    transposed to (out, in), biases as (Dp,) columns, cast to ``dt``, with
    D padded to ``Dp`` by zero rows and columns (padded features stay 0)."""
    w_in0, w_in1, b_in, w_s0, w_s1, b_s = lw[:6]
    D = w_in0.shape[1]

    def pair(w0, w1):
        out = w0.new_zeros(Dp, 2 * Dp, dtype=dt)
        out[:D, :D] = w0.T.to(dt)
        out[:D, Dp : Dp + D] = w1.T.to(dt)
        return out

    def square(wk):
        out = wk.new_zeros(Dp, Dp, dtype=dt)
        out[:D, :D] = wk.T.to(dt)
        return out

    def col(b):
        out = b.new_zeros(Dp, dtype=dt)
        out[:D] = b.to(dt)
        return out

    prepped = [pair(w_in0, w_in1), col(b_in), pair(w_s0, w_s1), col(b_s)]
    prepped += [square(w) if w.ndim == 2 else col(w) for w in lw[6:]]
    return prepped


@dataclasses.dataclass
class StackWeights:
    """Every layer's prepped weights, plus one flat buffer holding them in
    the order the CUDA kernel walks (layer by layer, then
    ``W_in, b_in, W_s, b_s, [W1, b1, W2, b2] x blocks``).  In bf16 each
    matrix of the flat buffer is tile-major (:func:`tile_major`), the layout
    the kernel's tensor-core fragment loads read whole; fp32 matrices stay
    row-major."""

    layers: List[List[torch.Tensor]]
    flat: torch.Tensor
    D: int
    Dp: int
    n_blocks: int

    @property
    def dtype(self) -> torch.dtype:
        return self.flat.dtype


def tile_major(w: torch.Tensor) -> torch.Tensor:
    """(R, C) with R, C multiples of 16 -> its 16 x 16 tiles one after
    another, row of tiles by row of tiles, each tile row-major, flattened."""
    R, C = w.shape
    return w.reshape(R // 16, 16, C // 16, 16).permute(0, 2, 1, 3).reshape(-1)


def stack_weights(layers_ws: Sequence[Sequence[torch.Tensor]], dt: torch.dtype) -> StackWeights:
    D = layers_ws[0][0].shape[1]
    Dp = padded_dim(D)
    layers = [prep_layer(lw, dt, Dp) for lw in layers_ws]
    tiled = dt == torch.bfloat16
    flat = torch.cat([
        tile_major(w) if tiled and w.ndim == 2 else w.reshape(-1) for lw in layers for w in lw
    ]).contiguous()
    return StackWeights(layers, flat, D, Dp, (len(layers_ws[0]) - 6) // 4)


def _dot(w: torch.Tensor, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(m, k) @ (k, n) with fp32 accumulation, cast to ``dt``."""
    return torch.matmul(w.float(), x.float()).to(dt)


def _layer_plain(x, adj, ws, act, n_blocks):
    dt = x.dtype
    Dp, A = x.shape
    nb, ab, _ = adj.shape
    xb = x.reshape(Dp, nb, ab).permute(1, 0, 2)  # (nb, Dp, ab)
    # agg[d, i] = sum_j x[d, j] adj[i, j] per bin, fp32
    agg = torch.matmul(xb.float(), adj.float().transpose(1, 2))
    agg = agg.permute(1, 0, 2).reshape(Dp, A).to(dt)
    xa = torch.cat([x, agg], dim=0)
    w_in, b_in, w_s, b_s = ws[:4]
    h = act(_dot(w_in, xa, dt) + b_in[:, None])
    for i in range(n_blocks):
        w1, b1, w2, b2 = ws[4 + 4 * i : 8 + 4 * i]
        v = act(_dot(w1, h, dt) + b1[:, None])
        h = _dot(w2, v, dt) + b2[:, None] + h
    s = _dot(w_s, xa, dt) + b_s[:, None]
    return h + s


def mp_stack_plain(xT: torch.Tensor, bin_adj: torch.Tensor, sw: StackWeights, act: str) -> torch.Tensor:
    """Plain PyTorch version of the stack: xT (D, A) in the compute dtype ->
    (D, A).  Runs the padded weights on xT padded with zero rows."""
    fn = get_activation_function(act)
    D, A = xT.shape
    x = torch.cat([xT, xT.new_zeros(sw.Dp - D, A)]) if sw.Dp > D else xT
    for ws in sw.layers:
        x = _layer_plain(x, bin_adj, ws, fn, sw.n_blocks) + x
    return x[:D].contiguous()


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mp_stack")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mp_stack_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, i, vp]
        lib.mp_stack_fwd.restype = i
        lib.mp_stack_smem_bytes.argtypes = [i, i, i, i, i]
        lib.mp_stack_smem_bytes.restype = ctypes.c_longlong
        lib.mp_stack_smem_limit.argtypes = []
        lib.mp_stack_smem_limit.restype = ctypes.c_longlong
        lib.mp_stack_error_string.argtypes = [i]
        lib.mp_stack_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def mp_stack_fwd(xT: torch.Tensor, bin_adj: torch.Tensor, sw: StackWeights, act: str) -> torch.Tensor:
    """Launch the CUDA stack kernel (one block per bin) on the current
    stream.  Raises on any input the kernel does not take and on any
    launch error; never falls back."""
    if xT.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mp_stack_fwd: unsupported dtype {xT.dtype}")
    if sw.dtype != xT.dtype:
        raise TypeError(f"mp_stack_fwd: weights are {sw.dtype}, activations {xT.dtype}")
    # the kernel reads x and bin_adj in 16-byte vectors, the weights as wmma
    # fragments (32-byte aligned)
    for name, t, align in (("xT", xT, 16), ("bin_adj", bin_adj, 16), ("weights", sw.flat, 32)):
        if not t.is_cuda or t.device != xT.device:
            raise ValueError(f"mp_stack_fwd: {name} must be on {xT.device}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"mp_stack_fwd: {name} must be contiguous and {align}-byte aligned")
    if bin_adj.dtype != torch.int8:
        raise TypeError("mp_stack_fwd: bin_adj must be int8")
    if act.lower() not in ACTIVATION_CODES:
        raise ValueError(f"mp_stack_fwd: unsupported activation {act!r}")
    nb, ab, ab2 = bin_adj.shape
    D, A = xT.shape
    if ab != ab2 or ab % 64 or A != nb * ab or D != sw.D:
        raise ValueError(
            f"mp_stack_fwd: xT {tuple(xT.shape)}, bin_adj {tuple(bin_adj.shape)}, D={sw.D}: "
            "need A = nb*ab, ab a multiple of 64, D matching the weights"
        )
    lib = _lib()
    bf16 = int(xT.dtype == torch.bfloat16)
    Dp = sw.Dp
    limit = lib.mp_stack_smem_limit()
    global_mode = int(lib.mp_stack_smem_bytes(bf16, Dp, ab, sw.n_blocks, 0) > limit)
    if lib.mp_stack_smem_bytes(bf16, Dp, ab, sw.n_blocks, global_mode) > limit:
        raise ValueError(f"mp_stack_fwd: D={D}, ab={ab} exceed one block's shared memory")
    if global_mode:
        out = torch.empty(Dp, A, dtype=xT.dtype, device=xT.device)
        agg = torch.empty(Dp, A, dtype=xT.dtype, device=xT.device)
    else:
        out = torch.empty(D, A, dtype=xT.dtype, device=xT.device)
        agg = out  # unused in shared-memory mode
    n_layers = len(sw.layers)
    if nb:
        status = lib.mp_stack_fwd(
            xT.data_ptr(), out.data_ptr(), agg.data_ptr(), bin_adj.data_ptr(), sw.flat.data_ptr(),
            bf16, D, Dp, A, nb, ab, n_layers, sw.n_blocks, ACTIVATION_CODES[act.lower()], global_mode,
            torch.cuda.current_stream(xT.device).cuda_stream,
        )
        if status != 0:
            raise RuntimeError(f"mp_stack_fwd: {lib.mp_stack_error_string(status).decode()}")
        mp_stack_fwd.launches += 1
    return out[:D] if global_mode else out


mp_stack_fwd.launches = 0


def binned_mp_stack_t(xT: torch.Tensor, bin_adj: torch.Tensor, sw: StackWeights, act: str = "silu") -> torch.Tensor:
    """Feature-major stack entry: xT (D, A) in the compute dtype, bin_adj
    (nb, ab, ab) int8 -> (D, A).  CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    if xT.device.type == "cuda":
        return mp_stack_fwd(xT, bin_adj, sw, act)
    if xT.device.type == "cpu":
        return mp_stack_plain(xT, bin_adj, sw, act)
    raise ValueError(f"binned_mp_stack_t: unsupported device {xT.device}")
