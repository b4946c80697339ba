"""Fused message-passing stack over the bin-packed layout, forward and
backward (counterpart of aimnet_x2d_tpu/ops/bin_mp.py::binned_mp_stack_t).

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
prepped once per model load (:func:`stack_weights`).  In bf16, every form
of the forward runs on 64-atom tiles (``stack_fwd_tile_kernel``, a cluster
of tiles a bin, its weights in one stream, :func:`fwd_weights`) where the
shape fits them (:func:`_takes_tiles`); fp32 and the other shapes launch
the kernel of one block a bin.  ``_launch_tiles`` and ``_launch_bins``
count the launches of each.

Cast points (as the JAX kernel): fp32 accumulation -> cast to the compute
dtype -> bias add in the compute dtype -> activation; the residual adds
round to the compute dtype.

Training (:func:`binned_mp_stack_train_t`, a ``torch.autograd.Function``)
adds, as the JAX op does in train mode: in-block dropout from a counter
hash of (feature row, global atom column, layer/block tag, seed), bit-equal
to the JAX mask; the x_other projection folded in front of layer 0
(``x0 = act(kb^T emb + bb)``, kernel 1c); each layer's input saved by the
forward; and a backward that recomputes each layer from its saved input
and walks it back (kernel 1b, ``csrc/mp_stack_bwd.cu``).

With the embedding fold (``vt``, kernel 1c-vocab: the JAX op's
``vocab_sizes``) the training forward takes the code rows (F, A) int32 and
the block-diagonal table instead of emb, the kernels look each atom's
embedding up themselves, and the backward returns the table's fp32
cotangent (its diagonal blocks) instead of demb (``mp_stack_fwd_train_vocab``;
the walk, then ``mp_stack_bwd_vocab``).

Kernel 1d, the JAX op at ``n_layers=1`` (``binned_mp_layer_t``), is the
same two kernels launched for one layer, with their own launch counters
(``mp_layer_fwd``, ``mp_layer_fwd_train``, ``mp_layer_bwd``):
:func:`binned_mp_layer_t` and :func:`binned_mp_layer_train_t` return
``layer(x) + x``, since the kernels' residual rounds where the JAX caller's
add does.  Their plain versions are the stack's over one layer.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.activation import ACTIVATION_CODES, activation_grad, get_activation_function
from . import cuda_build
from .embed import VocabTable, embed_from_codes, expand_diag, prep_vocab, table_grad


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
    return type_lib(cuda_build.load("mp_stack"))


def type_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the stack forward library's
    entry points (once); also for its marked build (chip_smoke.py)."""
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
        u, f = ctypes.c_uint, ctypes.c_float
        lib.mp_stack_tiles.argtypes = [vp] * 4 + [i] + [vp] * 4 + [i] * 11 + [u, u, f, vp]
        lib.mp_stack_tiles.restype = i
        lib.mp_stack_tiles_smem_bytes.argtypes = [i] * 4
        lib.mp_stack_tiles_smem_bytes.restype = ctypes.c_longlong
        lib.mp_stack_tiles_stream_elems.argtypes = [i] * 4
        lib.mp_stack_tiles_stream_elems.restype = ctypes.c_longlong
        lib.mp_stack_fwd_train.argtypes = [vp, vp, vp, vp, vp, vp, vp] + [i] * 13 + [u, u, f, vp]
        lib.mp_stack_fwd_train.restype = i
        lib.mp_stack_fwd_train_vocab.argtypes = [vp, vp, vp, i] + [vp] * 6 + [i] * 12 + [u, u, f, vp]
        lib.mp_stack_fwd_train_vocab.restype = i
        lib._typed = True
    return lib


# ---- the bf16 forward on tiles: its weight stream and launch ------------- #

def fwd_stream_elems(Dp: int, n_blocks: int, n_layers: int, E: int = 0) -> int:
    """Elements of the forward's weight stream (the C entry
    ``mp_stack_tiles_stream_elems``): the stages, then the biases."""
    kp = lambda k: -(-k // 32) * 32  # noqa: E731
    stages = ((kp(E) if E else 0) + n_layers * (2 * kp(2 * Dp) + 2 * n_blocks * kp(Dp))) // 32
    return stages * Dp * 32 + (Dp if E else 0) + n_layers * (2 + 2 * n_blocks) * Dp


def _tile_index(R: int, C: int, base: int) -> np.ndarray:
    """Positions of a tile-major (R, C) matrix's elements that starts at
    ``base`` (:func:`tile_major`), as an (R, C) array."""
    r, c = np.arange(R)[:, None], np.arange(C)[None, :]
    return base + ((r // 16) * (C // 16) + c // 16) * 256 + (r % 16) * 16 + c % 16


def fwd_stream_index(Dp: int, n_blocks: int, n_layers: int, E: int = 0) -> np.ndarray:
    """Positions in ``cat([sw.flat, pw.flat])`` (bf16, tile-major matrices;
    ``pw`` only under the fold, E > 0) of every element of the forward's
    weight stream, in the order the tile kernel uses them: the fold's kb^T,
    then per layer W_in, W1_0, W2_0, ..., W1_{n-1}, W2_{n-1}, W_s, each in
    :func:`frag_stream` order, then the biases: bb (fold), then per layer
    b_in, b1_0, b2_0, ..., b_s; the length of the concatenation marks a zero."""
    layer_sz = 2 * (2 * Dp * Dp + Dp) + n_blocks * 2 * (Dp * Dp + Dp)
    pbase = n_layers * layer_sz
    zero = pbase + (E * Dp + Dp if E else 0)
    mats, biases = [], []
    if E:
        mats.append(_tile_index(Dp, E, pbase))
        biases.append(pbase + E * Dp + np.arange(Dp))
    for l in range(n_layers):
        o = l * layer_sz
        mats.append(_tile_index(Dp, 2 * Dp, o))
        biases.append(o + 2 * Dp * Dp + np.arange(Dp))
        w_s = _tile_index(Dp, 2 * Dp, o + 2 * Dp * Dp + Dp)
        b_s = o + 4 * Dp * Dp + Dp + np.arange(Dp)
        o += 2 * (2 * Dp * Dp + Dp)
        for _ in range(n_blocks):
            mats += [_tile_index(Dp, Dp, o), _tile_index(Dp, Dp, o + Dp * Dp + Dp)]
            biases += [o + Dp * Dp + np.arange(Dp), o + 2 * Dp * Dp + Dp + np.arange(Dp)]
            o += 2 * (Dp * Dp + Dp)
        mats.append(w_s)
        biases.append(b_s)
    return np.concatenate([frag_stream(m, zero) for m in mats] + biases)


_FWD_INDEX: Dict[Tuple, torch.Tensor] = {}


def fwd_weights(sw: StackWeights, pw: Optional["ProjWeights"] = None) -> torch.Tensor:
    """The forward's weight stream (bf16): one gather from ``sw.flat`` and,
    under the fold, ``pw.flat`` by :func:`fwd_stream_index` (the index
    cached per shape and device)."""
    E = pw.E if pw is not None else 0
    key = (sw.Dp, sw.n_blocks, len(sw.layers), E, sw.flat.device)
    idx = _FWD_INDEX.get(key)
    if idx is None:
        idx = _FWD_INDEX[key] = torch.from_numpy(
            fwd_stream_index(sw.Dp, sw.n_blocks, len(sw.layers), E)).to(sw.flat.device)
    parts = [sw.flat] + ([pw.flat] if pw is not None else []) + [sw.flat.new_zeros(1)]
    return torch.cat(parts)[idx]


_FWD_TILES: Dict[Tuple, bool] = {}  # (bf16, Dp, ab, n_blocks, n_layers, E) -> the tiles take it


def _takes_tiles(lib, bf16: int, Dp: int, ab: int, nblk: int, L: int, E: int) -> bool:
    """Whether the bf16 forward on tiles (``stack_fwd_tile_kernel``) takes
    the shape; else ``mp_stack_kernel`` runs it.  Asked of the library once
    per shape, which also checks the weight stream's length."""
    key = (bf16, Dp, ab, nblk, L, E)
    if key not in _FWD_TILES:
        tiles = bool(bf16) and lib.mp_stack_tiles_smem_bytes(Dp, ab, nblk, E) >= 0
        if tiles and lib.mp_stack_tiles_stream_elems(Dp, nblk, L, E) != fwd_stream_elems(
                Dp, nblk, L, E):
            raise RuntimeError("mp_stack_tiles: the weight stream's length disagrees")
        _FWD_TILES[key] = tiles
    return _FWD_TILES[key]


def _launch_tiles(what: str, lib, x: torch.Tensor, adj: torch.Tensor, sw: StackWeights, act: str,
                  out: torch.Tensor, xs: Optional[torch.Tensor] = None, xs_first: int = 0,
                  drop=(0, 0, 0, 1.0), pw: Optional["ProjWeights"] = None,
                  vt: Optional[VocabTable] = None) -> None:
    """One launch of the bf16 forward on tiles (every form: x the input, or
    under the fold emb, or with ``vt`` the code rows); ``xs`` (n, D, A), if
    given, receives the inputs of layers ``xs_first``..; ``drop`` is
    (on, seed, threshold, scale).  Raises on a launch error."""
    nb, ab, _ = adj.shape
    table = ((x.data_ptr(), vt.bd.data_ptr(), _sizes_arg(vt), len(vt.sizes)) if vt is not None
             else (None, None, None, 0))
    ws = fwd_weights(sw, pw)
    status = lib.mp_stack_tiles(
        None if vt is not None else x.data_ptr(), *table, out.data_ptr(),
        xs.data_ptr() if xs is not None and xs.numel() else None, adj.data_ptr(), ws.data_ptr(),
        sw.D, sw.Dp, pw.E if pw is not None else 0, nb * ab, nb, ab, len(sw.layers), sw.n_blocks,
        ACTIVATION_CODES[act.lower()], xs_first, *drop, _stream(x.device))
    if status != 0:
        raise RuntimeError(f"{what}: {lib.mp_stack_error_string(status).decode()}")
    _launch_tiles.launches += 1


_launch_tiles.launches = 0


def _check_shapes(what: str, x, adj, sw, E=None, want=None):
    """Raise unless x (``want`` rows: D, or E with the projection fold) and
    bin_adj fit the kernels; returns (nb, ab, A)."""
    if adj.dtype != torch.int8:
        raise TypeError(f"{what}: bin_adj must be int8")
    nb, ab, ab2 = adj.shape
    rows, A = x.shape
    want = want if want is not None else sw.D if E is None else E
    if ab != ab2 or ab % 64 or A != nb * ab or rows != want or (E is not None and E % 16):
        raise ValueError(
            f"{what}: input {tuple(x.shape)}, bin_adj {tuple(adj.shape)}, D={sw.D}: need "
            "A = nb*ab, ab a multiple of 64, rows matching the weights (E a multiple of 16)")
    return nb, ab, A


def _launch_fwd(what: str, xT: torch.Tensor, bin_adj: torch.Tensor, sw: StackWeights,
                act: str) -> torch.Tensor:
    """Launch the CUDA stack kernel (one block per bin) on the current
    stream.  Raises on any input the kernel does not take and on any
    launch error; never falls back."""
    if xT.dtype != sw.dtype or xT.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: input {xT.dtype}, weights {sw.dtype}")
    nb, ab, A = _check_shapes(what, xT, bin_adj, sw)
    # the kernel reads x and bin_adj in 16-byte vectors, the weights as wmma
    # fragments (32-byte aligned)
    cuda_build.check_cuda(what, xT.device, ("xT", xT, 16), ("bin_adj", bin_adj, 16),
                          ("weights", sw.flat, 32))
    if act.lower() not in ACTIVATION_CODES:
        raise ValueError(f"{what}: unsupported activation {act!r}")
    D = sw.D
    lib = _lib()
    bf16 = int(xT.dtype == torch.bfloat16)
    Dp = sw.Dp
    if _takes_tiles(lib, bf16, Dp, ab, sw.n_blocks, len(sw.layers), 0):
        out = torch.empty(D, A, dtype=xT.dtype, device=xT.device)
        if nb:
            _launch_tiles(what, lib, xT, bin_adj, sw, act, out)
        return out
    limit = lib.mp_stack_smem_limit()
    global_mode = int(lib.mp_stack_smem_bytes(bf16, Dp, ab, sw.n_blocks, 0) > limit)
    if lib.mp_stack_smem_bytes(bf16, Dp, ab, sw.n_blocks, global_mode) > limit:
        raise ValueError(f"{what}: D={D}, ab={ab} exceed one block's shared memory")
    if global_mode:
        out = torch.empty(Dp, A, dtype=xT.dtype, device=xT.device)
        agg = torch.empty(Dp, A, dtype=xT.dtype, device=xT.device)
    else:
        out = torch.empty(D, A, dtype=xT.dtype, device=xT.device)
        agg = out  # unused in shared-memory mode
    n_layers = len(sw.layers)
    if nb:
        _launch_bins(what, lib, lib.mp_stack_fwd, xT.data_ptr(), out.data_ptr(), agg.data_ptr(),
                     bin_adj.data_ptr(), sw.flat.data_ptr(), bf16, D, Dp, A, nb, ab, n_layers,
                     sw.n_blocks, ACTIVATION_CODES[act.lower()], global_mode, _stream(xT.device))
    return out[:D] if global_mode else out


def _launch_bins(what: str, lib, entry, *args) -> None:
    """One launch of ``mp_stack_kernel`` (one block a bin: fp32 and the bf16
    shapes the tiles do not take) through the C ``entry``; raises on a
    launch error."""
    status = entry(*args)
    if status != 0:
        raise RuntimeError(f"{what}: {lib.mp_stack_error_string(status).decode()}")
    _launch_bins.launches += 1


_launch_bins.launches = 0


def mp_stack_fwd(xT: torch.Tensor, bin_adj: torch.Tensor, sw: StackWeights, act: str) -> torch.Tensor:
    """Kernel 1: the stack kernel over every layer of ``sw``."""
    out = _launch_fwd("mp_stack_fwd", xT, bin_adj, sw, act)
    mp_stack_fwd.launches += int(bin_adj.shape[0] > 0)
    return out


mp_stack_fwd.launches = 0


def mp_layer_fwd(xT: torch.Tensor, bin_adj: torch.Tensor, sw: StackWeights, act: str) -> torch.Tensor:
    """Kernel 1d (the TPU op at ``n_layers=1``): the stack kernel launched
    for one layer.  Returns ``layer(x) + x``: the kernel's residual rounds
    as the JAX caller's ``binned_mp_layer_t(x) + x`` does,
    ``rnd(rnd(h + s) + x)``."""
    if len(sw.layers) != 1:
        raise ValueError(f"mp_layer_fwd: one layer's weights, got {len(sw.layers)}")
    out = _launch_fwd("mp_layer_fwd", xT, bin_adj, sw, act)
    mp_layer_fwd.launches += int(bin_adj.shape[0] > 0)
    return out


mp_layer_fwd.launches = 0


def binned_mp_stack_t(xT: torch.Tensor, bin_adj: torch.Tensor, sw: StackWeights, act: str = "silu") -> torch.Tensor:
    """Feature-major stack entry: xT (D, A) in the compute dtype, bin_adj
    (nb, ab, ab) int8 -> (D, A).  CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    if xT.device.type == "cuda":
        return mp_stack_fwd(xT, bin_adj, sw, act)
    if xT.device.type == "cpu":
        return mp_stack_plain(xT, bin_adj, sw, act)
    raise ValueError(f"binned_mp_stack_t: unsupported device {xT.device}")


def binned_mp_layer_t(xT: torch.Tensor, bin_adj: torch.Tensor, sw: StackWeights,
                      act: str = "silu") -> torch.Tensor:
    """One shell-convolution layer with its residual, ``layer(x) + x``
    (the JAX ``binned_mp_layer_t`` plus the caller's residual add): kernel
    1d on CUDA tensors, the plain version (:func:`mp_stack_plain` over one
    layer) on CPU tensors."""
    if xT.device.type == "cuda":
        return mp_layer_fwd(xT, bin_adj, sw, act)
    if xT.device.type == "cpu":
        return mp_stack_plain(xT, bin_adj, sw, act)
    raise ValueError(f"binned_mp_layer_t: unsupported device {xT.device}")


# --------------------------------------------------------------------- #
# Training: dropout hash, projection fold, saved layer inputs, backward
# --------------------------------------------------------------------- #

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 tensors holding uint32 values, without
    leaving int64's range (the constant is split into 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def dropout_keep(rows: int, col0: int, cols: int, rate: float, seed: int, tag: int,
                 device=None) -> torch.Tensor:
    """Keep-mask (rows, cols) of the in-kernel dropout, bit-equal to the JAX
    package's ``_dropout_mask``: murmur3's fmix32 over
    ``i*0x85EBCA6B ^ j*0xC2B2AE35 ^ (seed + tag*0x9E3779B9)`` with ``i`` the
    feature row and ``j = col0 + column`` the global atom column; keep iff
    the hash is at least ``floor(rate * 2**32)``."""
    i = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(col0, col0 + cols, dtype=torch.int64, device=device)[None, :]
    mix = (int(seed) + int(tag) * 0x9E3779B9) & _M32
    x = _mul32(i, 0x85EBCA6B) ^ _mul32(j, 0xC2B2AE35) ^ mix
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= drop_threshold(rate)


def drop_threshold(rate: float) -> int:
    return min(int(rate * 2**32), 2**32 - 1)


def drop_scale(rate: float, dt: torch.dtype) -> float:
    """``1 / (1 - rate)`` rounded to the compute dtype, as JAX applies it."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float64).to(dt))


@dataclasses.dataclass
class ProjWeights:
    """The folded x_other projection ``x0 = act(kb^T emb + bb)`` in the
    kernels' form: ``kbT`` (Dp, E) and ``bb`` (Dp,) in the compute dtype,
    D padded to Dp with zero rows; ``flat`` holds them for the forward
    kernel and ``flat_t`` holds kb (E, Dp) for the backward (tile-major in
    bf16)."""

    kbT: torch.Tensor
    bb: torch.Tensor
    flat: torch.Tensor
    flat_t: torch.Tensor

    @property
    def E(self) -> int:
        return self.kbT.shape[1]


def prep_proj(kb: torch.Tensor, bb: torch.Tensor, dt: torch.dtype, Dp: int) -> ProjWeights:
    """kb (E, D), bb (D,) fp32 masters (flax orientation) -> ProjWeights."""
    E, D = kb.shape
    kbT = kb.new_zeros(Dp, E, dtype=dt)
    kbT[:D] = kb.T.to(dt)
    b = bb.new_zeros(Dp, dtype=dt)
    b[:D] = bb.to(dt)
    tiled = dt == torch.bfloat16
    lay = tile_major if tiled else (lambda w: w.reshape(-1))
    flat = torch.cat([lay(kbT), b]).contiguous()
    flat_t = lay(kbT.T.contiguous()).contiguous()
    return ProjWeights(kbT, b, flat, flat_t)


def stack_weights_t(sw: StackWeights) -> torch.Tensor:
    """The transposed weights the backward walk multiplies by, one flat
    buffer: per layer ``[W_s^T | W_in^T]`` (2Dp, 2Dp), then ``W1^T, W2^T``
    of every block (Dp, Dp); tile-major in bf16."""
    lay = tile_major if sw.dtype == torch.bfloat16 else (lambda w: w.reshape(-1))
    parts = []
    for ws in sw.layers:
        parts.append(lay(torch.cat([ws[2].T, ws[0].T], dim=1).contiguous()))
        for i in range(sw.n_blocks):
            w1, _, w2, _ = ws[4 + 4 * i : 8 + 4 * i]
            parts += [lay(w1.T.contiguous()), lay(w2.T.contiguous())]
    return torch.cat(parts).contiguous()


@dataclasses.dataclass(frozen=True)
class StackSpec:
    """Static configuration of one training call of the stack."""

    act: str
    rate: float = 0.0
    seed: int = 0  # uint32 bits of the step's dropout seed
    n_layers: int = 0  # layers of the autograd function's flat weight list

    def drop(self, l: int, i: int, n_blocks: int):
        """(rate, seed, tag) of block ``i`` of layer ``l``, or None."""
        if self.rate <= 0.0:
            return None
        return self.rate, self.seed, l * n_blocks + i

    def kernel_drop(self, dt: torch.dtype):
        """The forward kernels' dropout arguments: (on, seed bits, mask
        threshold, scale rounded to ``dt``)."""
        return (int(self.rate > 0), self.seed & _M32, drop_threshold(self.rate),
                drop_scale(self.rate, dt) if self.rate > 0 else 1.0)


def _apply_drop(v: torch.Tensor, drop, col0: int = 0) -> torch.Tensor:
    rate, seed, tag = drop
    keep = dropout_keep(v.shape[0], col0, v.shape[1], rate, seed, tag, v.device)
    return torch.where(keep, v * drop_scale(rate, v.dtype), torch.zeros((), dtype=v.dtype))


def _recompute_plain(x, adj, ws, act, n_blocks, spec, l):
    """Layer ``l`` forward from its (padded) input, keeping what the
    backward reads: (xa, t, h, hs, us, vs)."""
    dt = x.dtype
    Dp, A = x.shape
    nb, ab, _ = adj.shape
    xb = x.reshape(Dp, nb, ab).permute(1, 0, 2)
    agg = torch.matmul(xb.float(), adj.float().transpose(1, 2)).permute(1, 0, 2).reshape(Dp, A)
    xa = torch.cat([x, agg.to(dt)], dim=0)
    return (xa,) + _chain_plain(xa, ws, act, n_blocks, spec, l)


def _chain_plain(xa, ws, act, n_blocks, spec, l):
    """The layer's chain after the aggregation, from the padded
    [x ; agg] (2Dp, A): (t, h, hs, us, vs), h before the skip add."""
    dt = xa.dtype
    fn = get_activation_function(act)
    t = _dot(ws[0], xa, dt) + ws[1][:, None]
    h = fn(t)
    hs, us, vs = [], [], []
    for i in range(n_blocks):
        w1, b1, w2, b2 = ws[4 + 4 * i : 8 + 4 * i]
        u = _dot(w1, h, dt) + b1[:, None]
        v = fn(u)
        drop = spec.drop(l, i, n_blocks)
        if drop is not None:
            v = _apply_drop(v, drop)
        hs.append(h)
        us.append(u)
        vs.append(v)
        h = _dot(w2, v, dt) + b2[:, None] + h
    return t, h, hs, us, vs


def _pad_rows(x: torch.Tensor, Dp: int) -> torch.Tensor:
    D = x.shape[0]
    return torch.cat([x, x.new_zeros(Dp - D, x.shape[1])]) if Dp > D else x


def mp_stack_train_plain(x: torch.Tensor, adj: torch.Tensor, sw: StackWeights, spec: StackSpec,
                         pw: Optional[ProjWeights] = None, vt: Optional[VocabTable] = None):
    """Plain PyTorch version of the training forward.  ``x`` is (D, A) in
    the compute dtype, or the embeddings (E, A) when ``pw`` folds the
    projection in, or with ``vt`` too the code rows (F, A) int32 (the
    embedding fold).  Returns (out (D, A), saved layer inputs): the inputs
    of layers 1.. and, under the fold, layer 0's too."""
    dt = sw.dtype
    fn = get_activation_function(spec.act)
    if vt is not None:
        x = embed_from_codes(x, vt)
    if pw is not None:
        x = fn(_dot(pw.kbT, x, dt) + pw.bb[:, None])
    else:
        x = _pad_rows(x, sw.Dp)
    saved = []
    for l, ws in enumerate(sw.layers):
        if pw is not None or l > 0:
            saved.append(x[: sw.D].contiguous())
        xa, t, h, hs, us, vs = _recompute_plain(x, adj, ws, spec.act, sw.n_blocks, spec, l)
        s = _dot(ws[2], xa, dt) + ws[3][:, None]
        x = (h + s) + x
    return x[: sw.D].contiguous(), saved


def _layer_bwd_plain(x, adj, ws, spec, n_blocks, l, g32):
    """Backward of layer ``l`` (``_bwd_xa_from_saved`` + the aggregation
    transpose of the JAX kernel) from its padded input and the fp32
    cotangent of its output; returns (the cotangent of its input, fp32,
    with the residual path added) and the layer's weight grads in the
    prepped (out, in) orientation."""
    dt = x.dtype
    Dp, A = x.shape
    nb, ab, _ = adj.shape
    xa, t, _, hs, us, vs = _recompute_plain(x, adj, ws, spec.act, n_blocks, spec, l)
    dxa, grads = _chain_bwd_plain(xa, t, hs, us, vs, ws, spec, n_blocks, l, g32.to(dt))
    dA = dxa[Dp:].to(dt).float().reshape(Dp, nb, ab).permute(1, 0, 2)
    dagg = torch.matmul(dA, adj.float()).permute(1, 0, 2).reshape(Dp, A)
    return (dxa[:Dp] + dagg) + g32, grads


def _chain_bwd_plain(xa, t, hs, us, vs, ws, spec, n_blocks, l, gd, operands=None):
    """The JAX ``_bwd_xa_from_saved``: from the recomputed chain and the
    compute-dtype cotangent ``gd`` of the layer's output, (dxa (2Dp, A)
    fp32, the layer's weight grads in the prepped orientation).  A dict
    ``operands`` receives the cotangents the weight grads contract:
    ``dh[i]`` (that of h_{i+1}, g for the last block), ``du[i]`` and ``dt``."""
    dt = xa.dtype
    f = lambda a: a.float()  # noqa: E731
    dws = f(gd) @ f(xa).T
    dbs = f(gd).sum(1)
    dxa = f(ws[2]).T @ f(gd)
    dh = gd
    blocks = []
    ops = operands if operands is not None else {}
    ops["dh"], ops["du"] = {}, {}
    for i in range(n_blocks - 1, -1, -1):
        w1, _, w2, _ = ws[4 + 4 * i : 8 + 4 * i]
        ops["dh"][i] = dh
        dw2 = f(dh) @ f(vs[i]).T
        db2 = f(dh).sum(1)
        dv = (f(w2).T @ f(dh)).to(dt)
        drop = spec.drop(l, i, n_blocks)
        if drop is not None:
            dv = _apply_drop(dv, drop)
        du = dv * activation_grad(spec.act, us[i])
        ops["du"][i] = du
        dw1 = f(du) @ f(hs[i]).T
        db1 = f(du).sum(1)
        dh = (f(dh) + f(w1).T @ f(du)).to(dt)
        blocks.append((dw1, db1, dw2, db2))
    dtin = dh * activation_grad(spec.act, t)
    ops["dt"] = dtin
    dwin = f(dtin) @ f(xa).T
    dbin = f(dtin).sum(1)
    dxa = dxa + f(ws[0]).T @ f(dtin)
    grads = [dwin, dbin, dws, dbs]
    for blk in reversed(blocks):
        grads += list(blk)
    return dxa, grads


def _proj_bwd_plain(emb, g32, pw: ProjWeights, act: str):
    """The projection fold's backward from the fp32 cotangent (Dp, A) of
    x0: (demb (E, A) in the compute dtype, dkbT (Dp, E), dbb (Dp,))."""
    dt = pw.kbT.dtype
    t0 = _dot(pw.kbT, emb, dt) + pw.bb[:, None]
    dt0 = g32 * activation_grad(act, t0).float()
    dt0c = dt0.to(dt)
    dkbT = dt0c.float() @ emb.float().T
    demb = (pw.kbT.float().T @ dt0c.float()).to(dt)
    return demb, dkbT, dt0.sum(1)


def mp_stack_bwd_vocab_plain(codes, g32, pw: ProjWeights, vt: VocabTable, act: str):
    """Plain PyTorch version of :func:`mp_stack_bwd_vocab`: from the code
    rows and the walk's fp32 cotangent (Dp, A) of x0, (d_bd (E, sum of V)
    fp32 on the diagonal blocks, dkbT (Dp, E), dbb (Dp,))."""
    demb, dkbT, dbb = _proj_bwd_plain(embed_from_codes(codes, vt), g32, pw, act)
    return table_grad(demb, codes, vt), dkbT, dbb


def mp_stack_bwd_plain(x, adj, sw: StackWeights, spec: StackSpec, saved, g,
                       pw: Optional[ProjWeights] = None, vt: Optional[VocabTable] = None):
    """Plain PyTorch version of the backward.  ``x`` and ``saved`` as the
    forward took and returned them, ``g`` (D, A) the cotangent of its
    output.  Returns (dx (D, A) or demb (E, A) in the compute dtype, or
    d_bd (E, sum of V) fp32 under the embedding fold; per-layer weight
    grads (prepped orientation, fp32); proj grads (dkbT (Dp, E), dbb (Dp,))
    or None)."""
    dt = sw.dtype
    L = len(sw.layers)
    first = 0 if pw is not None else 1
    g32 = _pad_rows(g.float(), sw.Dp)
    layer_grads = [None] * L
    for l in range(L - 1, -1, -1):
        xl = saved[l - first] if l >= first else x
        g32, layer_grads[l] = _layer_bwd_plain(
            _pad_rows(xl, sw.Dp), adj, sw.layers[l], spec, sw.n_blocks, l, g32)
    if pw is None:
        return g32[: sw.D].to(dt), layer_grads, None
    if vt is not None:
        d_bd, dkbT, dbb = mp_stack_bwd_vocab_plain(x, g32, pw, vt, spec.act)
        return d_bd, layer_grads, (dkbT, dbb)
    demb, dkbT, dbb = _proj_bwd_plain(x, g32, pw, spec.act)
    return demb, layer_grads, (dkbT, dbb)


def unprep_layer_grads(sw: StackWeights, lg: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One layer's prepped-orientation grads -> the caller's order and
    orientation ``(w_in0, w_in1, b_in, w_s0, w_s1, b_s, [w1, b1, w2, b2]...)``
    with kernels (in, out), padding dropped."""
    D, Dp = sw.D, sw.Dp
    dwin, dbin, dws, dbs = lg[:4]
    out = [dwin[:D, :D].T, dwin[:D, Dp : Dp + D].T, dbin[:D],
           dws[:D, :D].T, dws[:D, Dp : Dp + D].T, dbs[:D]]
    out += [w[:D, :D].T if w.ndim == 2 else w[:D] for w in lg[4:]]
    return [o.contiguous() for o in out]


# ---- CUDA wrappers of the training kernels -------------------------------- #


def _lib_bwd() -> ctypes.CDLL:
    lib = cuda_build.load("mp_stack_bwd")
    if not getattr(lib, "_typed", False):
        vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.mp_stack_bwd_layer.argtypes = [vp] * 6 + [i] * 10 + [u, u, f, vp]
        lib.mp_stack_bwd_layer.restype = i
        lib.mp_stack_bwd_proj.argtypes = [vp] * 6 + [i] * 7 + [vp]
        lib.mp_stack_bwd_proj.restype = i
        lib.mp_stack_bwd_proj_vocab.argtypes = [vp] * 4 + [i] + [vp] * 4 + [i] * 7 + [vp]
        lib.mp_stack_bwd_proj_vocab.restype = i
        lib.sum_partials.argtypes = [vp, vp, i, ctypes.c_longlong, vp]
        lib.sum_partials.restype = i
        lib.mp_stack_bwd_smem_bytes.argtypes = [i, i, i, i]
        lib.mp_stack_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.mp_stack_bwd_walk.argtypes = [vp] * 5 + [i] * 9 + [u, u, f, vp]
        lib.mp_stack_bwd_walk.restype = i
        lib.mp_stack_bwd_walk_smem_bytes.argtypes = [i, i, i]
        lib.mp_stack_bwd_walk_smem_bytes.restype = ctypes.c_longlong
        lib.mp_stack_bwd_walk_stream_elems.argtypes = [i, i]
        lib.mp_stack_bwd_walk_stream_elems.restype = ctypes.c_longlong
        lib.wgrad_group.argtypes = ([i] + [vp] * 7 + [ctypes.c_longlong] + [i] * 3 + [vp] * 3
                                    + [i, vp])
        lib.wgrad_group.restype = i
        lib.mp_stack_bwd_error_string.argtypes = [i]
        lib.mp_stack_bwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _stream(dev) -> int:
    """The current CUDA stream of ``dev``, as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(
        dev.index if dev.index is not None else torch.cuda.current_device())


def _launch_fwd_train(what: str, x: torch.Tensor, adj: torch.Tensor, sw: StackWeights,
                      spec: StackSpec, pw: Optional[ProjWeights] = None,
                      vt: Optional[VocabTable] = None):
    """Launch the stack kernel in training form: dropout, the projection
    fold when ``pw`` is given (with ``vt`` the embedding fold too: x is the
    code rows), and each layer's input saved.  Returns (out (D, A), saved
    inputs (n, D, A)).  Raises on anything it cannot take."""
    if vt is not None:
        if (pw is None or x.dtype != torch.int32 or x.shape[0] != len(vt.sizes)
                or vt.bd.dtype != sw.dtype or vt.E != pw.E):
            raise TypeError(f"{what}: codes {x.dtype} {tuple(x.shape)}, table "
                            f"{vt.bd.dtype} {tuple(vt.bd.shape)}, weights {sw.dtype}")
    elif x.dtype != sw.dtype:
        raise TypeError(f"{what}: input {x.dtype}, weights {sw.dtype}")
    if sw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: weights {sw.dtype}")
    E = pw.E if pw is not None else None
    nb, ab, A = _check_shapes(what, x, adj, sw, E, len(vt.sizes) if vt is not None else None)
    named = [("x", x, 16), ("bin_adj", adj, 16), ("weights", sw.flat, 32)]
    if pw is not None:
        named.append(("proj", pw.flat, 32))
    if vt is not None:
        named.append(("table", vt.bd, 4))
    cuda_build.check_cuda(what, x.device, *named)
    if spec.act.lower() not in ACTIVATION_CODES:
        raise ValueError(f"{what}: unsupported activation {spec.act!r}")
    lib = _lib()
    dt = sw.dtype
    bf16 = int(dt == torch.bfloat16)
    D, Dp, L = sw.D, sw.Dp, len(sw.layers)
    dev = x.device
    first = 0 if pw is not None else 1
    drop = spec.kernel_drop(dt)
    if _takes_tiles(lib, bf16, Dp, ab, sw.n_blocks, L, E or 0):
        out = torch.empty(D, A, dtype=dt, device=dev)
        xs = torch.empty(L - first, D, A, dtype=dt, device=dev)
        if nb:
            _launch_tiles(what, lib, x, adj, sw, spec.act, out, xs, first, drop, pw, vt)
        return out, list(xs.unbind(0))
    limit = lib.mp_stack_smem_limit()
    global_mode = int(lib.mp_stack_smem_bytes(bf16, Dp, ab, sw.n_blocks, 0) > limit)
    if lib.mp_stack_smem_bytes(bf16, Dp, ab, sw.n_blocks, global_mode) > limit:
        raise ValueError(f"{what}: D={D}, ab={ab} exceed one block's shared memory")
    if vt is not None and E > max(ab, 2 * Dp):
        # the looked-up tile borrows the block's adjacency scratch
        raise ValueError(f"{what}: E={E} exceeds the scratch rows max(ab, 2 Dp)")
    out = torch.empty(Dp if global_mode else D, A, dtype=dt, device=dev)
    agg = torch.empty(Dp, A, dtype=dt, device=dev) if global_mode else out
    xs = torch.empty(L - first, D, A, dtype=dt, device=dev)
    if nb and vt is not None:
        _launch_bins(what, lib, lib.mp_stack_fwd_train_vocab, x.data_ptr(), vt.bd.data_ptr(),
                     _sizes_arg(vt), len(vt.sizes), out.data_ptr(), agg.data_ptr(),
                     adj.data_ptr(), sw.flat.data_ptr(), pw.flat.data_ptr(), xs.data_ptr(), bf16,
                     D, Dp, E, A, nb, ab, L, sw.n_blocks, ACTIVATION_CODES[spec.act.lower()],
                     global_mode, *drop, _stream(dev))
    elif nb:
        _launch_bins(what, lib, lib.mp_stack_fwd_train, x.data_ptr(), out.data_ptr(),
                     agg.data_ptr(), adj.data_ptr(), sw.flat.data_ptr(),
                     pw.flat.data_ptr() if pw is not None else None, xs.data_ptr(), bf16, D, Dp,
                     E or 0, A, nb, ab, L, sw.n_blocks, ACTIVATION_CODES[spec.act.lower()],
                     global_mode, first, *drop, _stream(dev))
    return (out[:D] if global_mode else out), list(xs.unbind(0))


def mp_stack_fwd_train(x: torch.Tensor, adj: torch.Tensor, sw: StackWeights, spec: StackSpec,
                       pw: Optional[ProjWeights] = None):
    """Kernel 1 in training form (with 1c when ``pw`` is given)."""
    out = _launch_fwd_train("mp_stack_fwd_train", x, adj, sw, spec, pw)
    mp_stack_fwd_train.launches += int(adj.shape[0] > 0)
    return out


mp_stack_fwd_train.launches = 0


def _sizes_arg(vt: VocabTable):
    return (ctypes.c_int * len(vt.sizes))(*vt.sizes)


def mp_stack_fwd_train_vocab(codes: torch.Tensor, adj: torch.Tensor, sw: StackWeights,
                             spec: StackSpec, pw: ProjWeights, vt: VocabTable):
    """Kernel 1 in training form with 1c-vocab: the projection fold's
    input looked up from the code rows (F, A) int32 and the table."""
    out = _launch_fwd_train("mp_stack_fwd_train_vocab", codes, adj, sw, spec, pw, vt)
    mp_stack_fwd_train_vocab.launches += int(adj.shape[0] > 0)
    return out


mp_stack_fwd_train_vocab.launches = 0


def mp_layer_fwd_train(x: torch.Tensor, adj: torch.Tensor, sw: StackWeights, spec: StackSpec):
    """Kernel 1d in training form: one layer with dropout (``spec.seed`` is
    the layer's own seed, block tags from 0, as the JAX per-layer op) and
    the residual, ``layer(x) + x``.  Saves nothing: the backward
    recomputes from x."""
    if len(sw.layers) != 1:
        raise ValueError(f"mp_layer_fwd_train: one layer's weights, got {len(sw.layers)}")
    out, _ = _launch_fwd_train("mp_layer_fwd_train", x, adj, sw, spec)
    mp_layer_fwd_train.launches += int(adj.shape[0] > 0)
    return out


mp_layer_fwd_train.launches = 0

WGRAD_CHUNK = 4096  # atoms per split of the weight-gradient contraction


def sum_partials(part: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column sums of a (n, size) fp32 partials array, in a fixed order
    (into ``out``, a contiguous (size,) fp32 array, when given)."""
    lib = _lib_bwd()
    n, size = part.shape
    if out is None:
        out = torch.empty(size, dtype=torch.float32, device=part.device)
    elif out.shape != (size,) or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"sum_partials: out {tuple(out.shape)} {out.dtype} for {size} sums")
    status = lib.sum_partials(part.data_ptr(), out.data_ptr(), n, size, _stream(part.device))
    if status != 0:
        raise RuntimeError(f"sum_partials: {lib.mp_stack_bwd_error_string(status).decode()}")
    return out


# ---- the backward walk's work slabs and weight-gradient products ---------- #


def bwd_slabs(n_blocks: int) -> Dict[str, int]:
    """Indices of the walk's work slabs (Dp, A) in its buffer: xa (two: x
    rows, agg rows), h_i, v_i, dh_i (the cotangent of h_{i+1}; the last is
    g), du_i, dt -- what the weight gradients read; ``n`` slabs in all, and
    ``n_legacy`` with the slabs only the one-block-a-bin walk writes (t,
    u_i, dA)."""
    return dict(XA=0, H=2, V=2 + n_blocks, DH=2 + 2 * n_blocks, DU=2 + 3 * n_blocks,
                DT=2 + 4 * n_blocks, n=3 + 4 * n_blocks, n_legacy=5 + 5 * n_blocks)


def layer_products(wk: torch.Tensor, n_blocks: int):
    """The 2 + 2 n_blocks products of one layer's weight gradients, read
    from the walk's work slabs ``wk`` (n, Dp, A), in the order of the
    layer's grads: (dt, xa) -> W_in, (g, xa) -> W_s, then per block
    (du_i, h_i) -> W1_i and (dh_i, v_i) -> W2_i; each (dY, X, None)."""
    k = bwd_slabs(n_blocks)
    Dp, A = wk.shape[1:]
    xa = wk[k["XA"] : k["XA"] + 2].reshape(2 * Dp, A)
    prods = [(wk[k["DT"]], xa, None), (wk[k["DH"] + n_blocks - 1], xa, None)]
    for i in range(n_blocks):
        prods += [(wk[k["DU"] + i], wk[k["H"] + i], None), (wk[k["DH"] + i], wk[k["V"] + i], None)]
    return prods


def bwd_slabs_plain(x, adj, ws, spec: StackSpec, n_blocks: int, l: int, g32):
    """The work slabs of layer ``l``'s walk (the first ``n`` of
    :func:`bwd_slabs`), formed from the plain backward's own operands: from
    the padded input ``x`` and the fp32 cotangent ``g32`` of the layer's
    output."""
    dt = x.dtype
    Dp = x.shape[0]
    xa, t, _, hs, us, vs = _recompute_plain(x, adj, ws, spec.act, n_blocks, spec, l)
    ops: dict = {}
    _chain_bwd_plain(xa, t, hs, us, vs, ws, spec, n_blocks, l, g32.to(dt), ops)
    slabs = [xa[:Dp], xa[Dp:], *hs, *vs, *(ops["dh"][i] for i in range(n_blocks)),
             *(ops["du"][i] for i in range(n_blocks)), ops["dt"]]
    return torch.stack([a.to(dt) for a in slabs])


def ext_slabs_plain(xa, sw: StackWeights, spec: StackSpec, g, legacy: bool = False):
    """Kernel 5's work slabs (:func:`bwd_slabs`' first ``n``: the walk's
    form), formed from :func:`mp_ext_bwd_plain`'s own operands: from xa
    (2D, A) and the cotangent g (D, A) of the layer's output.  ``legacy``
    appends t and u_i, as ``ext_bwd_kernel`` (the slab route) keeps them."""
    dt, nblk = sw.dtype, sw.n_blocks
    ws = sw.layers[0]
    xp = _pad_xa(xa, sw.D, sw.Dp)
    t, _, hs, us, vs = _chain_plain(xp, ws, spec.act, nblk, spec, 0)
    ops: dict = {}
    _chain_bwd_plain(xp, t, hs, us, vs, ws, spec, nblk, 0, _pad_rows(g.to(dt), sw.Dp), ops)
    slabs = [xp[: sw.Dp], xp[sw.Dp :], *hs, *vs, *(ops["dh"][i] for i in range(nblk)),
             *(ops["du"][i] for i in range(nblk)), ops["dt"]]
    if legacy:
        slabs += [t, *us]
    return torch.stack([a.to(dt) for a in slabs])


@dataclasses.dataclass
class GatheredX:
    """The X of a gathered product of :func:`wgrad_group`: the embeddings
    (E, A) looked up from the code rows (F, A) int32 and the table (the
    embedding fold), never formed on the card."""

    codes: torch.Tensor
    vt: VocabTable

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.vt.E, self.codes.shape[1])


def _x_plain(X) -> torch.Tensor:
    return embed_from_codes(X.codes, X.vt) if isinstance(X, GatheredX) else X


def wgrad_group_plain(products):
    """Plain PyTorch version of :func:`wgrad_group`: per product
    ``(dY, X, bias_src)``, ``(dY @ X^T, rowsum(bias_src or dY))`` in fp32."""
    return [(dY.float() @ _x_plain(X).float().T, (b if b is not None else dY).float().sum(1))
            for dY, X, b in products]


GROUP_MAX = 16  # products of one launch of the grouped contraction


def _group_chunk(bf16: int, A: int, tiles: int, dev) -> int:
    """Atoms per split of the grouped contraction: fp32 WGRAD_CHUNK; bf16
    so that the grid holds about two blocks for each SM (two fit one)."""
    if not bf16:
        return WGRAD_CHUNK
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    steps = A // 64
    n = max(1, min(steps, round(2 * sms / max(tiles, 1))))
    return -(-steps // n) * 64


def _group_plan(products) -> Tuple[int, int, int]:
    """(atoms per chunk, chunks, columns) of the partials array
    :func:`wgrad_group` fills for ``products``."""
    dY0 = products[0][0]
    bf16 = int(dY0.dtype == torch.bfloat16)
    A = dY0.shape[1]
    tiles = sum((-(-dY.shape[0] // 160) if bf16 else dY.shape[0] // 16) * -(-X.shape[0] // 64)
                for dY, X, _ in products)
    total = sum(dY.shape[0] * X.shape[0] + dY.shape[0] for dY, X, _ in products)
    chunk = _group_chunk(bf16, A, tiles, dY0.device)
    return chunk, -(-A // chunk), total


def _group_launcher(products):
    """Check ``products`` for the grouped contraction and prepare its launch
    once: returns ``run(part=None, out=None)``, which launches it on those
    tensors (as they hold then) and returns the (dW, db) pairs.  The walk
    prepares one per call and runs it once a layer, on the same slabs."""
    dY0 = products[0][0]
    dt, dev, A = dY0.dtype, dY0.device, dY0.shape[1]
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wgrad_group: unsupported dtype {dt}")
    named = []
    gathered = [X for _, X, _ in products if isinstance(X, GatheredX)]
    for p, (dY, X, b) in enumerate(products):
        xdt = X.vt.bd.dtype if isinstance(X, GatheredX) else X.dtype
        if dY.dtype != dt or xdt != dt or (b is not None and b.dtype != torch.float32):
            raise TypeError(f"wgrad_group: product {p}: {dY.dtype}, {xdt}, bias source "
                            f"{None if b is None else b.dtype}; want {dt} and fp32")
        if (dY.dim() != 2 or len(X.shape) != 2 or dY.shape[1] != A or X.shape[1] != A
                or dY.shape[0] % 16 or X.shape[0] % 16 or A % 64
                or (b is not None and b.shape != dY.shape)):
            raise ValueError(f"wgrad_group: product {p}: dY {tuple(dY.shape)}, X "
                             f"{tuple(X.shape)}: need rows multiples of 16, A = {A} a multiple "
                             "of 64, the bias source shaped as dY")
        named.append((f"dY[{p}]", dY, 16))
        if not isinstance(X, GatheredX):
            named.append((f"X[{p}]", X, 16))
        if b is not None:
            named.append((f"bias_src[{p}]", b, 16))
    if any(X.codes is not gathered[0].codes or X.vt is not gathered[0].vt for X in gathered):
        raise ValueError("wgrad_group: the gathered products must share one table and code rows")
    if gathered:  # the contraction reads 8 codes at a time
        gx = gathered[0]
        if gx.codes.dtype != torch.int32 or gx.codes.shape[0] != len(gx.vt.sizes):
            raise TypeError(f"wgrad_group: code rows {gx.codes.dtype} {tuple(gx.codes.shape)}")
        named += [("codes", gx.codes, 16), ("table", gx.vt.bd, 4)]
    cuda_build.check_cuda("wgrad_group", dev, *named)
    bf16 = int(dt == torch.bfloat16)
    chunk, nch, total = _group_plan(products)
    shapes = [(dY.shape[0], X.shape[0]) for dY, X, _ in products]
    offs = np.cumsum([0] + [M * N + M for M, N in shapes[:-1]]).tolist()
    lib = _lib_bwd()
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launches = []
    for g0 in range(0, len(products), GROUP_MAX):
        sub = products[g0 : g0 + GROUP_MAX]
        n = len(sub)
        launches.append((n, (vp * n)(*[dY.data_ptr() for dY, _, _ in sub]),
                         (vp * n)(*[None if isinstance(X, GatheredX) else X.data_ptr()
                                    for _, X, _ in sub]),
                         (vp * n)(*[b.data_ptr() if b is not None else None for _, _, b in sub]),
                         (i * n)(*[M for M, _ in shapes[g0 : g0 + n]]),
                         (i * n)(*[N for _, N in shapes[g0 : g0 + n]]),
                         (ll * n)(*offs[g0 : g0 + n])))
    stream = _stream(dev)
    table = ((gathered[0].codes.data_ptr(), gathered[0].vt.bd.data_ptr(),
              _sizes_arg(gathered[0].vt), len(gathered[0].vt.sizes)) if gathered
             else (None, None, None, 0))

    def run(part: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None):
        if part is None:
            part = torch.empty(nch, total, dtype=torch.float32, device=dev)
        if part.shape != (nch, total) or part.dtype != torch.float32 or not part.is_contiguous():
            raise ValueError(f"wgrad_group: partials {tuple(part.shape)}, want ({nch}, {total})")
        for args in launches:
            status = lib.wgrad_group(*args, part.data_ptr(), total, bf16, A, chunk, *table,
                                     stream)
            if status != 0:
                raise RuntimeError(f"wgrad_group: {lib.mp_stack_bwd_error_string(status).decode()}")
        out = sum_partials(part, out)
        wgrad_group.launches += 1
        return [(out[o : o + M * N].view(M, N), out[o + M * N : o + M * N + M])
                for (M, N), o in zip(shapes, offs)]

    return run


def wgrad_group(products, part: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None):
    """The weight gradients of several products at once: per ``(dY (M, A),
    X (N, A) or a :class:`GatheredX`, bias_src (M, A) fp32 or None)``,
    ``(dY @ X^T (M, N), the row sums of bias_src or dY (M,))`` in fp32.  On
    CUDA tensors one launch of the grouped split-K contraction
    (``csrc/wgrad_group.cuh``) per GROUP_MAX products, then one fixed-order
    sum of the chunk partials (``sum_partials``), so reruns are bit-equal;
    ``part`` (the (chunks,
    columns) partials of :func:`_group_plan`) and ``out`` (the flat
    results) may be given to reuse buffers.  On CPU tensors the plain
    version."""
    if products[0][0].device.type == "cpu":
        return wgrad_group_plain(products)
    return _group_launcher(products)(part, out)


wgrad_group.launches = 0


# ---- the bf16 walk's weight stream ---------------------------------------- #


def walk_stream_elems(Dp: int, n_blocks: int) -> int:
    """Elements of one layer's weight stream and biases (the C entry
    ``mp_stack_bwd_walk_stream_elems``)."""
    kp = lambda k: -(-k // 32) * 32  # noqa: E731
    stages = (kp(2 * Dp) + (4 * n_blocks - 1) * kp(Dp) + 2 * kp(2 * Dp)) // 32
    return stages * Dp * 32 + (1 + 2 * n_blocks) * Dp


def frag_stream(w: np.ndarray, pad) -> np.ndarray:
    """(M, K) -> the walk's stream order: K padded to a multiple of 32 with
    ``pad``, then 16 x 16 tiles k-major (each 32-column stage holds its
    tiles one after another), each tile in mma.sync's A-fragment order:
    lane 4g + t holds rows g and g + 8, columns 2t, 2t + 1, 2t + 8 and
    2t + 9, as (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), (g, 2t+8), ...
    -- one 16-byte load a lane."""
    M, K = w.shape
    Kp = -(-K // 32) * 32
    if Kp > K:
        w = np.concatenate([w, np.full((M, Kp - K), pad, w.dtype)], 1)
    return w.reshape(M // 16, 2, 8, Kp // 16, 2, 4, 2).transpose(3, 0, 2, 5, 4, 1, 6).reshape(-1)


def walk_stream_index(Dp: int, n_blocks: int, n_layers: int) -> np.ndarray:
    """Positions in a bf16 ``StackWeights.flat`` (tile-major matrices) of
    every element of the walk's weight streams, layer by layer: W_in, W1_0,
    W2_0, ..., W1_{n-1} (the recompute), W2_{n-1}^T, W1_{n-1}^T, ..., W2_0^T,
    W1_0^T (the walk back), the agg rows and then the x rows of
    [W_s^T | W_in^T] (dxa), each in :func:`frag_stream` order, then the
    biases b_in, b1_0, b2_0, b1_1, ...; ``len(flat)`` marks a zero."""
    layer_sz = 2 * (2 * Dp * Dp + Dp) + n_blocks * 2 * (Dp * Dp + Dp)
    zero = n_layers * layer_sz
    out = []
    for l in range(n_layers):
        o = l * layer_sz
        w_in = _tile_index(Dp, 2 * Dp, o)
        b_in = o + 2 * Dp * Dp + np.arange(Dp)
        w_s = _tile_index(Dp, 2 * Dp, o + 2 * Dp * Dp + Dp)
        o += 2 * (2 * Dp * Dp + Dp)
        w1, b1, w2, b2 = [], [], [], []
        for _ in range(n_blocks):
            w1.append(_tile_index(Dp, Dp, o))
            b1.append(o + Dp * Dp + np.arange(Dp))
            w2.append(_tile_index(Dp, Dp, o + Dp * Dp + Dp))
            b2.append(o + 2 * Dp * Dp + Dp + np.arange(Dp))
            o += 2 * (Dp * Dp + Dp)
        mats = [w_in]
        for i in range(n_blocks):
            mats += [w1[i]] + ([w2[i]] if i + 1 < n_blocks else [])
        for i in reversed(range(n_blocks)):
            mats += [w2[i].T, w1[i].T]
        wt = np.concatenate([w_s.T, w_in.T], 1)
        mats += [wt[Dp:], wt[:Dp]]
        parts = [frag_stream(m, zero) for m in mats] + [b_in]
        for i in range(n_blocks):
            parts += [b1[i], b2[i]]
        out.append(np.concatenate(parts))
    return np.concatenate(out)


_STREAM_INDEX: Dict[Tuple, torch.Tensor] = {}


def walk_weights(sw: StackWeights) -> torch.Tensor:
    """Every layer's weight stream of the bf16 walk, one flat buffer: one
    gather from ``sw.flat`` by :func:`walk_stream_index` (cached per shape
    and device)."""
    L = len(sw.layers)
    key = (sw.Dp, sw.n_blocks, L, sw.flat.device)
    idx = _STREAM_INDEX.get(key)
    if idx is None:
        idx = _STREAM_INDEX[key] = torch.from_numpy(
            walk_stream_index(sw.Dp, sw.n_blocks, L)).to(sw.flat.device)
    return torch.cat([sw.flat, sw.flat.new_zeros(1)])[idx]


_BWD_WALK: Dict[Tuple, bool] = {}  # (bf16, Dp, ab, n_blocks) -> the bf16 walk takes it


def _takes_walk(lib, bf16: int, Dp: int, ab: int, nblk: int) -> bool:
    """Whether the bf16 walk (``bwd_walk_kernel``) takes the shape; else the
    one-block-a-bin walk runs it, and must fit one block's shared memory
    (raises otherwise).  Asked of the library once per shape."""
    key = (bf16, Dp, ab, nblk)
    if key not in _BWD_WALK:
        walk = bool(bf16) and lib.mp_stack_bwd_walk_smem_bytes(Dp, ab, nblk) >= 0
        if walk and lib.mp_stack_bwd_walk_stream_elems(Dp, nblk) != walk_stream_elems(Dp, nblk):
            raise RuntimeError("mp_stack_bwd: the walk's weight-stream length disagrees")
        if not walk and lib.mp_stack_bwd_smem_bytes(bf16, Dp, ab, nblk) > cuda_build.SMEM_LIMIT:
            raise ValueError(f"mp_stack_bwd: Dp={Dp}, ab={ab} exceed one block's shared memory")
        _BWD_WALK[key] = walk
    return _BWD_WALK[key]


def _launch_bwd(what: str, x, adj, sw: StackWeights, spec: StackSpec, saved, g, first: int,
                E: Optional[int] = None, extra=None):
    """Per layer, last to first, the walk (recompute from the saved input,
    walk back, fold the aggregation transpose; ``csrc/mp_stack_bwd.cu``),
    then the layer's weight gradients: one grouped contraction of its
    products and one fixed-order sum (:func:`wgrad_group`).  Layer ``l``
    reads ``saved[l - first]``, or ``x`` for ``l < first``.  ``extra``, a
    function of the finished g32 returning more ``(dY, X, bias_src)``
    products, joins the first layer's contraction launch; their (dW, db)
    follow that layer's grads.  Returns (g32: the fp32 cotangent (Dp, A) of
    the first layer's input, residual path included; the per-layer weight
    grads; the work slabs, :func:`bwd_slabs`)."""
    dt = sw.dtype
    if g.dtype != dt or x.dtype != dt:
        raise TypeError(f"{what}: cotangent {g.dtype}, input {x.dtype}, weights {dt}")
    nb, ab, A = _check_shapes(what, x, adj, sw, E)
    g = g.contiguous()
    cuda_build.check_cuda(what, x.device, ("x", x, 16), ("bin_adj", adj, 16), ("g", g, 16),
                ("weights", sw.flat, 32), *[(f"saved[{i}]", s, 16) for i, s in enumerate(saved)])
    if spec.act.lower() not in ACTIVATION_CODES:
        raise ValueError(f"{what}: unsupported activation {spec.act!r}")
    lib = _lib_bwd()
    bf16 = int(dt == torch.bfloat16)
    D, Dp, L, nblk = sw.D, sw.Dp, len(sw.layers), sw.n_blocks
    walk = _takes_walk(lib, bf16, Dp, ab, nblk)
    dev = x.device
    k = bwd_slabs(nblk)
    wk = torch.empty(k["n"] if walk else k["n_legacy"], Dp, A, dtype=dt, device=dev)
    g32 = torch.zeros(Dp, A, dtype=torch.float32, device=dev)
    g32[:D] = g.float()
    wts = walk_weights(sw) if walk else stack_weights_t(sw)
    per = wts.numel() // L
    layer_sz = sw.flat.numel() // L
    args = (ACTIVATION_CODES[spec.act.lower()], int(spec.rate > 0))
    drop = (spec.seed & _M32, drop_threshold(spec.rate),
            drop_scale(spec.rate, dt) if spec.rate > 0 else 1.0, _stream(dev))
    prods = layer_products(wk, nblk)
    if L > 1 or extra is None:
        contract = _group_launcher(prods)
        part = torch.empty(*_group_plan(prods)[1:], dtype=torch.float32, device=dev)
        flat_grads = torch.empty(L, part.shape[1], dtype=torch.float32, device=dev)
    layer_grads = [None] * L
    for l in range(L - 1, -1, -1):
        xl = saved[l - first] if l >= first else x
        if walk:
            status = lib.mp_stack_bwd_walk(
                xl.data_ptr(), wk.data_ptr(), g32.data_ptr(), adj.data_ptr(),
                wts[l * per :].data_ptr(), D, Dp, A, nb, ab, nblk, *args, l, *drop)
        else:
            status = lib.mp_stack_bwd_layer(
                xl.data_ptr(), wk.data_ptr(), g32.data_ptr(), adj.data_ptr(),
                sw.flat[l * layer_sz :].data_ptr(), wts[l * per :].data_ptr(),
                bf16, D, Dp, A, nb, ab, nblk, *args, l, *drop)
        if status != 0:
            raise RuntimeError(f"{what}: {lib.mp_stack_bwd_error_string(status).decode()}")
        pairs = (contract(part, flat_grads[l]) if l or extra is None
                 else _group_launcher(prods + extra(g32))())
        layer_grads[l] = [t for pair in pairs for t in pair]
    return g32, layer_grads, wk


def mp_stack_bwd(x, adj, sw: StackWeights, spec: StackSpec, saved, g,
                 pw: Optional[ProjWeights] = None, vt: Optional[VocabTable] = None):
    """Launch the backward (kernel 1b), and under the fold the projection's
    backward (1c; with ``vt``, :func:`mp_stack_bwd_vocab`).  Same returns as
    :func:`mp_stack_bwd_plain`."""
    what = "mp_stack_bwd"
    E = pw.E if pw is not None else None
    dtc_slab = bwd_slabs(sw.n_blocks)["DT"]  # the dt slab, free after the last layer
    if vt is not None:
        # every layer reads its saved input; the codes are not the walk's
        g32, layer_grads, wk = _launch_bwd(what, saved[0], adj, sw, spec, saved, g, 0)
        mp_stack_bwd.launches += 1
        d_bd, dkbT, dbb = mp_stack_bwd_vocab(x, g32, pw, vt, spec.act, adj.shape[1], wk[dtc_slab])
        return d_bd, layer_grads, (dkbT, dbb)
    g32, layer_grads, wk = _launch_bwd(what, x, adj, sw, spec, saved, g,
                                       0 if pw is not None else 1, E)
    mp_stack_bwd.launches += 1
    dt, D = sw.dtype, sw.D
    if pw is None:
        return g32[:D].to(dt), layer_grads, None
    dev = x.device
    nb, ab, _ = adj.shape
    A = x.shape[1]
    cuda_build.check_cuda(what, dev, ("proj", pw.flat, 32), ("proj_t", pw.flat_t, 32))
    lib = _lib_bwd()
    dtc = wk[dtc_slab]
    demb = torch.empty(E, A, dtype=dt, device=dev)
    status = lib.mp_stack_bwd_proj(
        x.data_ptr(), g32.data_ptr(), pw.flat.data_ptr(), pw.flat_t.data_ptr(),
        dtc.data_ptr(), demb.data_ptr(), int(dt == torch.bfloat16), sw.Dp, E, A, nb, ab,
        ACTIVATION_CODES[spec.act.lower()], _stream(dev),
    )
    if status != 0:
        raise RuntimeError(f"{what}: {lib.mp_stack_bwd_error_string(status).decode()}")
    # g32 now holds the fp32 cotangent of the projection's pre-activation
    ((dkbT, dbb),) = wgrad_group([(dtc, x, g32)])
    return demb, layer_grads, (dkbT, dbb)


mp_stack_bwd.launches = 0


def mp_stack_bwd_vocab(codes, g32, pw: ProjWeights, vt: VocabTable, act: str, ab: int,
                       dtc: Optional[torch.Tensor] = None):
    """The projection fold's backward under the embedding fold (1c-vocab):
    one block per bin of ``ab`` atoms recomputes t0 from the looked-up embeddings, forms
    dt0 = g32 act'(t0) (written over ``g32``, the walk's fp32 cotangent
    (Dp, A) of x0), rnd(dt0) into ``dtc`` (a (Dp, A) compute-dtype scratch)
    and per-bin partials of d_bd; then d_kb by the gathered contraction.
    Returns (d_bd (E, sum of V) fp32, zero off the diagonal blocks, dkbT
    (Dp, E), dbb (Dp,))."""
    what = "mp_stack_bwd_vocab"
    dt = pw.kbT.dtype
    Dp, A = g32.shape
    E = pw.E
    if codes.dtype != torch.int32 or codes.shape[0] != len(vt.sizes) or vt.E != E or \
            vt.bd.dtype != dt or g32.dtype != torch.float32 or codes.shape[1] != A or \
            ab % 64 or A % ab or E % 16:
        raise TypeError(f"{what}: codes {codes.dtype} {tuple(codes.shape)}, cotangent "
                        f"{g32.dtype} {tuple(g32.shape)}, table {vt.bd.dtype}, weights {dt}")
    dev = codes.device
    if dtc is None:
        dtc = torch.empty(Dp, A, dtype=dt, device=dev)
    cuda_build.check_cuda(what, dev, ("codes", codes, 16), ("g32", g32, 16),
                          ("proj", pw.flat, 32), ("proj_t", pw.flat_t, 32), ("table", vt.bd, 4),
                          ("dtc", dtc, 16))
    nb = A // ab
    n_acc = vt.Df * vt.offsets[-1]
    part = torch.empty(nb, n_acc, dtype=torch.float32, device=dev)
    lib = _lib_bwd()
    status = lib.mp_stack_bwd_proj_vocab(
        codes.data_ptr(), vt.bd.data_ptr(), _sizes_arg(vt), g32.data_ptr(), len(vt.sizes),
        pw.flat.data_ptr(), pw.flat_t.data_ptr(), dtc.data_ptr(), part.data_ptr(),
        int(dt == torch.bfloat16), Dp, E, A, nb, ab, ACTIVATION_CODES[act.lower()], _stream(dev),
    )
    if status != 0:
        raise RuntimeError(f"{what}: {lib.mp_stack_bwd_error_string(status).decode()}")
    d_bd = expand_diag(sum_partials(part), vt)
    ((dkbT, dbb),) = wgrad_group([(dtc, GatheredX(codes, vt), g32)])
    mp_stack_bwd_vocab.launches += 1
    return d_bd, dkbT, dbb


mp_stack_bwd_vocab.launches = 0


def mp_layer_bwd(x, adj, sw: StackWeights, spec: StackSpec, g, extra=None):
    """Kernel 1d backward (kernel 1b launched for one layer): from the
    layer's input ``x`` and the cotangent ``g`` of ``layer(x) + x``, return
    (the fp32 cotangent (Dp, A) of x, residual path included; the layer's
    weight grads, prepped orientation).  ``extra`` (see :func:`_launch_bwd`)
    adds the caller's products to the layer's one contraction launch; their
    (dW, db) pairs follow the layer's grads."""
    if len(sw.layers) != 1:
        raise ValueError(f"mp_layer_bwd: one layer's weights, got {len(sw.layers)}")
    g32, layer_grads, _ = _launch_bwd("mp_layer_bwd", x, adj, sw, spec, [], g, 1, extra=extra)
    mp_layer_bwd.launches += 1
    return g32, layer_grads[0]


mp_layer_bwd.launches = 0


def mp_layer_bwd_plain(x, adj, sw: StackWeights, spec: StackSpec, g):
    """Plain PyTorch version of :func:`mp_layer_bwd`, same returns."""
    return _layer_bwd_plain(_pad_rows(x, sw.Dp), adj, sw.layers[0], spec, sw.n_blocks, 0,
                            _pad_rows(g.float(), sw.Dp))


# ---- autograd ------------------------------------------------------------- #


def _one_layer(spec: StackSpec, pw: Optional[ProjWeights]) -> bool:
    """One layer without the projection fold: kernel 1d's launches."""
    return spec.n_layers == 1 and pw is None


class _StackTrainFn(torch.autograd.Function):
    """``x -> stack(x)`` (or ``emb -> stack(act(kb^T emb + bb))``) with the
    fp32 master weights as differentiable inputs: the forward preps them
    once per call (cast, pad, transpose) and the backward returns their
    fp32 grads in the caller's orientation.  One layer without the fold is
    kernel 1d (``mp_layer_fwd_train`` / ``mp_layer_bwd``).  Under the
    embedding fold (``vocab`` set) x is the code rows, which get no
    gradient (there is no dx, as in JAX), and ``bd``, the fp32
    block-diagonal table, gets d_bd."""

    @staticmethod
    def forward(ctx, x, adj, spec, dt, vocab, bd, kb, bb, *ws):
        per = len(ws) // spec.n_layers
        with torch.no_grad():
            sw = stack_weights([ws[l * per : (l + 1) * per] for l in range(spec.n_layers)], dt)
            pw = prep_proj(kb, bb, dt, sw.Dp) if kb is not None else None
            vt = prep_vocab(bd, vocab, dt) if vocab is not None else None
        if x.device.type == "cuda" and _one_layer(spec, pw):
            out, saved = mp_layer_fwd_train(x, adj, sw, spec), []
        elif x.device.type == "cuda" and vt is not None:
            out, saved = mp_stack_fwd_train_vocab(x, adj, sw, spec, pw, vt)
        elif x.device.type == "cuda":
            out, saved = mp_stack_fwd_train(x, adj, sw, spec, pw)
        elif x.device.type == "cpu":
            out, saved = mp_stack_train_plain(x, adj, sw, spec, pw, vt)
        else:
            raise ValueError(f"binned_mp_stack_train_t: unsupported device {x.device}")
        ctx.save_for_backward(x, adj, *saved)
        ctx.sw, ctx.pw, ctx.vt, ctx.spec = sw, pw, vt, spec
        return out

    @staticmethod
    def backward(ctx, g):
        x, adj, *saved = ctx.saved_tensors
        sw, pw, vt, spec = ctx.sw, ctx.pw, ctx.vt, ctx.spec
        g = g.to(sw.dtype)
        if x.device.type == "cuda" and _one_layer(spec, pw):
            g32, lg = mp_layer_bwd(x, adj, sw, spec, g)
            dx, layer_grads, proj = g32[: sw.D].to(sw.dtype), [lg], None
        else:
            bwd = mp_stack_bwd if x.device.type == "cuda" else mp_stack_bwd_plain
            dx, layer_grads, proj = bwd(x, adj, sw, spec, saved, g, pw, vt)
        grads = [w for lg in layer_grads for w in unprep_layer_grads(sw, lg)]
        dkb = dbb = None
        if proj is not None:
            dkbT, dbb_p = proj
            dkb, dbb = dkbT[: sw.D].T.contiguous(), dbb_p[: sw.D].contiguous()
        d_bd = None
        if vt is not None:
            dx, d_bd = None, dx
        return (dx, None, None, None, None, d_bd, dkb, dbb, *grads)


def binned_mp_stack_train_t(
    x: torch.Tensor,
    bin_adj: torch.Tensor,
    layers_ws: Sequence[Sequence[torch.Tensor]],
    dtype: torch.dtype,
    act: str = "silu",
    dropout: float = 0.0,
    seed: int = 0,
    proj_weights: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    embed_spec=None,
) -> torch.Tensor:
    """Differentiable stack for training (the JAX ``binned_mp_stack_t`` in
    a train step).  ``layers_ws``: every layer's fp32 master weights, as
    ``ShellConvolutionLayer.stack_weights`` gives them.  With
    ``proj_weights=(kb (E, D), bb (D,))`` x is the embedding array (E, A)
    and the x_other projection runs inside the kernel.  With additionally
    ``embed_spec=(codes (F, A) int32, blockdiag_t (E, sum of V) fp32,
    vocab_sizes)`` x is ignored (may be None) and the embedding lookup runs
    inside the kernels too (the fold), the table taking the gradient.
    ``seed`` is the step's dropout seed (its low 32 bits are used).  CUDA
    tensors go through the kernels, CPU tensors through the plain
    versions."""
    kb, bb = proj_weights if proj_weights is not None else (None, None)
    flat = [w for lw in layers_ws for w in lw]
    spec = StackSpec(act.lower(), float(dropout), int(seed) & _M32, len(layers_ws))
    if embed_spec is not None:
        if proj_weights is None:
            raise ValueError("binned_mp_stack_train_t: the embedding fold needs proj_weights")
        codes, bd_t, vocab = embed_spec
        return _StackTrainFn.apply(codes.to(torch.int32).contiguous(), bin_adj, spec, dtype,
                                   tuple(int(v) for v in vocab), bd_t, kb, bb, *flat)
    return _StackTrainFn.apply(x.to(dtype).contiguous(), bin_adj, spec, dtype, None, None, kb, bb,
                               *flat)


def binned_mp_layer_train_t(x: torch.Tensor, bin_adj: torch.Tensor,
                            layer_ws: Sequence[torch.Tensor], dtype: torch.dtype,
                            act: str = "silu", dropout: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Differentiable single layer with its residual for training,
    ``layer(x) + x`` (the JAX ``binned_mp_layer_t`` in a train step plus the
    caller's residual): kernel 1d on CUDA tensors, the plain versions on CPU
    tensors.  ``seed`` is the layer's own dropout seed
    (:func:`layer_drop_seed`)."""
    return binned_mp_stack_train_t(x, bin_adj, [layer_ws], dtype, act, dropout, seed)


def layer_drop_seed(base_seed: int, l: int) -> int:
    """Per-layer dropout seed of the single-layer entry points, the JAX
    ``models/gnn.py::_layer_drop_seed``: ``base + tag_l`` in int32 with
    wrap-around, ``tag_l = (l + 1) * 0x27D4EB2F`` (an odd constant other than
    the block tag's, so layer l / block i and layer l+1 / block i-1 draw
    different masks)."""
    s = (int(base_seed) + (l + 1) * 0x27D4EB2F) & _M32
    return s - (1 << 32) if s >= (1 << 31) else s


# --------------------------------------------------------------------- #
# Kernel 5: one layer on a pre-aggregated [x ; agg] (halo graph shards)
# --------------------------------------------------------------------- #
#
# The JAX op ``binned_mp_layer_ext_t`` (``_make_ext_layer_op``): the caller
# builds xa = [x ; agg] (2D, A), the local per-bin aggregation plus the halo
# rows' contribution (ops/halo.py), and adds the residual itself.  The layer
# arithmetic is the stack's (:func:`_chain_plain`, :func:`_chain_bwd_plain`
# for the plain versions; ``csrc/mp_ext.cu`` for the kernels), with dropout
# tags 0..n_blocks-1 and the rank's local atom columns, as the JAX kernel
# draws them.


def _pad_xa(xa: torch.Tensor, D: int, Dp: int) -> torch.Tensor:
    """(2D, A) [x ; agg] -> (2Dp, A), each half padded with zero rows."""
    if Dp == D:
        return xa
    z = xa.new_zeros(Dp - D, xa.shape[1])
    return torch.cat([xa[:D], z, xa[D:], z])


def _unpad_xa(dxa: torch.Tensor, D: int, Dp: int) -> torch.Tensor:
    return torch.cat([dxa[:D], dxa[Dp : Dp + D]]) if Dp > D else dxa


def mp_ext_plain(xa: torch.Tensor, sw: StackWeights, spec: StackSpec) -> torch.Tensor:
    """Plain PyTorch version of :func:`mp_ext_fwd`: xa (2D, A) in the
    compute dtype -> the layer's output (D, A), residual not added."""
    dt = sw.dtype
    ws = sw.layers[0]
    xp = _pad_xa(xa, sw.D, sw.Dp)
    _, h, _, _, _ = _chain_plain(xp, ws, spec.act, sw.n_blocks, spec, 0)
    s = _dot(ws[2], xp, dt) + ws[3][:, None]
    return (h + s)[: sw.D].contiguous()


def mp_ext_bwd_plain(xa: torch.Tensor, sw: StackWeights, spec: StackSpec, g: torch.Tensor):
    """Plain PyTorch version of :func:`mp_ext_bwd`: from xa and the cotangent
    g (D, A) of the layer's output, (dxa (2D, A) in the compute dtype, the
    layer's fp32 weight grads in the prepped orientation)."""
    dt = sw.dtype
    ws = sw.layers[0]
    xp = _pad_xa(xa, sw.D, sw.Dp)
    t, _, hs, us, vs = _chain_plain(xp, ws, spec.act, sw.n_blocks, spec, 0)
    dxa, grads = _chain_bwd_plain(xp, t, hs, us, vs, ws, spec, sw.n_blocks, 0,
                                  _pad_rows(g.to(dt), sw.Dp))
    return _unpad_xa(dxa.to(dt), sw.D, sw.Dp).contiguous(), grads


def _lib_ext() -> ctypes.CDLL:
    lib = cuda_build.load("mp_ext")
    if not getattr(lib, "_typed", False):
        vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.mp_ext_fwd.argtypes = [vp] * 3 + [i] * 7 + [u, u, f, vp]
        lib.mp_ext_fwd.restype = i
        lib.mp_ext_bwd.argtypes = [vp] * 6 + [i] * 7 + [u, u, f, vp]
        lib.mp_ext_bwd.restype = i
        lib.mp_ext_fwd_smem_bytes.argtypes = [i, i, i]
        lib.mp_ext_fwd_smem_bytes.restype = ctypes.c_longlong
        lib.mp_ext_bwd_walk.argtypes = [vp] * 5 + [i] * 6 + [u, u, f, vp]
        lib.mp_ext_bwd_walk.restype = i
        lib.mp_ext_bwd_walk_smem_bytes.argtypes = [i, i]
        lib.mp_ext_bwd_walk_smem_bytes.restype = ctypes.c_longlong
        lib.mp_ext_bwd_walk_stream_elems.argtypes = [i, i]
        lib.mp_ext_bwd_walk_stream_elems.restype = ctypes.c_longlong
        lib.mp_ext_fwd_wg.argtypes = [vp] * 3 + [i] * 6 + [u, u, f, vp]
        lib.mp_ext_fwd_wg.restype = i
        lib.mp_ext_fwd_wg_smem_bytes.argtypes = [i, i]
        lib.mp_ext_fwd_wg_smem_bytes.restype = ctypes.c_longlong
        lib.mp_ext_fwd_wg_stream_elems.argtypes = [i, i]
        lib.mp_ext_fwd_wg_stream_elems.restype = ctypes.c_longlong
        lib.mp_ext_error_string.argtypes = [i]
        lib.mp_ext_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_ext(what: str, xa: torch.Tensor, sw: StackWeights, spec: StackSpec, *named):
    """Raise unless xa (2D, A) and the named tensors fit kernel 5; returns
    the launch's dropout arguments."""
    dt = sw.dtype
    if len(sw.layers) != 1 or dt not in (torch.float32, torch.bfloat16) or xa.dtype != dt:
        raise TypeError(f"{what}: input {xa.dtype}, {len(sw.layers)} layers of {dt} weights")
    if xa.dim() != 2 or xa.shape[0] != 2 * sw.D or xa.shape[1] % 64:
        raise ValueError(f"{what}: xa {tuple(xa.shape)}: need (2D, A), D={sw.D}, A a multiple of 64")
    if spec.act.lower() not in ACTIVATION_CODES:
        raise ValueError(f"{what}: unsupported activation {spec.act!r}")
    cuda_build.check_cuda(what, xa.device, ("xa", xa, 16), ("weights", sw.flat, 32), *named)
    return spec.kernel_drop(dt)


# ---- kernel 5's bf16 forward on wgmma: its weight stream ----------------- #
#
# ``ext_fwd_wg_kernel`` multiplies with the atoms as rows: out^T = xa^T W^T.
# Its B operand, W^T (K x Dp), arrives in stages of 32 K-rows, each stage
# K-major without swizzle: core matrices of 8 outputs x 8 inputs (64
# contiguous elements), the stage's four input groups of an output group
# one after another, then the next output group.

WG_KC = 32  # K of a weight stage


def ext_wg_stream_elems(Dp: int, n_blocks: int) -> int:
    """Elements of the wgmma forward's weight stream (the C entry
    ``mp_ext_fwd_wg_stream_elems``): the stages, then the biases."""
    return (4 * Dp + 2 * n_blocks * Dp) * Dp + (2 + 2 * n_blocks) * Dp


def wg_stage(idx: np.ndarray) -> np.ndarray:
    """An (Dp, K) array of positions (a matrix W, rows the outputs) -> its
    K / 32 stages in the kernel's order, flattened: stage s holds columns
    32s..32s+31, element (n, k) at (n/8)*256 + (k/8)*64 + (n%8)*8 + k%8."""
    Dp, K = idx.shape
    st = idx.reshape(Dp // 8, 8, K // WG_KC, WG_KC // 8, 8)  # (ng, n8, s, kg, k8)
    return st.transpose(2, 0, 3, 1, 4).reshape(-1)


def ext_wg_stream_index(Dp: int, n_blocks: int) -> np.ndarray:
    """Positions in ``sw.flat`` (bf16, one layer, tile-major matrices) of
    every element of the wgmma forward's weight stream, in the order the
    kernel uses it: W_s's stages, W_in's, then W1_i's and W2_i's of each
    block (:func:`wg_stage`), then the biases b_in, b_s, b1_0, b2_0, ...
    Dp is a multiple of 32."""
    w_in = _tile_index(Dp, 2 * Dp, 0)
    w_s = _tile_index(Dp, 2 * Dp, 2 * Dp * Dp + Dp)
    parts, biases = [wg_stage(w_s), wg_stage(w_in)], [2 * Dp * Dp + np.arange(Dp),
                                                      4 * Dp * Dp + Dp + np.arange(Dp)]
    o = 2 * (2 * Dp * Dp + Dp)
    for _ in range(n_blocks):
        parts += [wg_stage(_tile_index(Dp, Dp, o)), wg_stage(_tile_index(Dp, Dp, o + Dp * Dp + Dp))]
        biases += [o + Dp * Dp + np.arange(Dp), o + 2 * Dp * Dp + Dp + np.arange(Dp)]
        o += 2 * (Dp * Dp + Dp)
    return np.concatenate(parts + biases)


_WG_INDEX: Dict[Tuple, torch.Tensor] = {}


def ext_wg_weights(sw: StackWeights) -> torch.Tensor:
    """The wgmma forward's weight stream (bf16): one gather from ``sw.flat``
    by :func:`ext_wg_stream_index`, the index cached per shape and device."""
    key = (sw.Dp, sw.n_blocks, sw.flat.device)
    idx = _WG_INDEX.get(key)
    if idx is None:
        idx = _WG_INDEX[key] = torch.from_numpy(
            ext_wg_stream_index(sw.Dp, sw.n_blocks)).to(sw.flat.device)
    return sw.flat[idx]


_EXT_WG: Dict[Tuple, bool] = {}  # (bf16, Dp, n_blocks) -> the wgmma forward takes it


def _ext_takes_wg(lib, bf16: int, Dp: int, nblk: int) -> bool:
    """Whether kernel 5's forward runs on ``ext_fwd_wg_kernel`` (bf16, Dp a
    multiple of 32 up to 160, at least one block, its buffers in one
    block's shared memory); else on ``ext_fwd_kernel``.  Asked of the
    library once per shape, which also checks the stream's length."""
    key = (bf16, Dp, nblk)
    if key not in _EXT_WG:
        wg = bool(bf16) and lib.mp_ext_fwd_wg_smem_bytes(Dp, nblk) >= 0
        if wg and lib.mp_ext_fwd_wg_stream_elems(Dp, nblk) != ext_wg_stream_elems(Dp, nblk):
            raise RuntimeError("mp_ext_fwd: the wgmma forward's stream length disagrees")
        _EXT_WG[key] = wg
    return _EXT_WG[key]


def mp_ext_fwd(xa: torch.Tensor, sw: StackWeights, spec: StackSpec) -> torch.Tensor:
    """Kernel 5's forward (``csrc/mp_ext.cu``): xa (2D, A) -> the layer's
    output (D, A), with dropout when ``spec.rate`` > 0.  In bf16, where the
    shape fits it, the warp-specialised wgmma kernel with the layer's weight
    stream (:func:`ext_wg_weights`); fp32 and the other shapes one block per
    64-atom tile.  The route is chosen by shape and counted in
    ``mp_ext_fwd.routes``.  Raises on anything it cannot take."""
    what = "mp_ext_fwd"
    drop = _check_ext(what, xa, sw, spec)
    lib = _lib_ext()
    bf16 = int(sw.dtype == torch.bfloat16)
    wg = _ext_takes_wg(lib, bf16, sw.Dp, sw.n_blocks)
    if not wg and lib.mp_ext_fwd_smem_bytes(bf16, sw.Dp, sw.n_blocks) > cuda_build.SMEM_LIMIT:
        raise ValueError(f"{what}: D={sw.D} exceeds one block's shared memory")
    A = xa.shape[1]
    out = torch.empty(sw.D, A, dtype=sw.dtype, device=xa.device)
    if A:
        act = ACTIVATION_CODES[spec.act.lower()]
        if wg:
            ws = ext_wg_weights(sw)
            status = lib.mp_ext_fwd_wg(xa.data_ptr(), out.data_ptr(), ws.data_ptr(), sw.D, sw.Dp, A,
                                       sw.n_blocks, act, *drop, _stream(xa.device))
        else:
            status = lib.mp_ext_fwd(xa.data_ptr(), out.data_ptr(), sw.flat.data_ptr(), bf16, sw.D,
                                    sw.Dp, A, sw.n_blocks, act, *drop, _stream(xa.device))
        if status != 0:
            raise RuntimeError(f"{what}: {lib.mp_ext_error_string(status).decode()}")
        mp_ext_fwd.launches += 1
        mp_ext_fwd.routes["wgmma" if wg else "tiles"] += 1
    return out


mp_ext_fwd.launches = 0
mp_ext_fwd.routes = {"wgmma": 0, "tiles": 0}  # launches of ext_fwd_wg_kernel, of ext_fwd_kernel


_EXT_WALK: Dict[Tuple, bool] = {}  # (bf16, Dp, n_blocks) -> kernel 5's walk takes it


def _ext_takes_walk(lib, bf16: int, Dp: int, nblk: int) -> bool:
    """Whether kernel 5's backward runs on the stack's bf16 walk
    (``bwd_walk_kernel`` without aggregation, transpose or cluster); else on
    ``ext_bwd_kernel``'s slabs.  Asked of the library once per shape."""
    key = (bf16, Dp, nblk)
    if key not in _EXT_WALK:
        walk = bool(bf16) and lib.mp_ext_bwd_walk_smem_bytes(Dp, nblk) >= 0
        if walk and lib.mp_ext_bwd_walk_stream_elems(Dp, nblk) != walk_stream_elems(Dp, nblk):
            raise RuntimeError("mp_ext_bwd: the walk's weight-stream length disagrees")
        _EXT_WALK[key] = walk
    return _EXT_WALK[key]


def mp_ext_bwd(xa: torch.Tensor, sw: StackWeights, spec: StackSpec, g: torch.Tensor):
    """Kernel 5's backward: the walk (recompute, walk back, dxa and the
    gradient operands in the work slabs of :func:`bwd_slabs`) -- in bf16 the
    stack's walk kernel with the layer's weight stream (:func:`walk_weights`),
    in fp32 and past the walk's shapes ``ext_bwd_kernel`` -- then the layer's
    weight gradients in one grouped contraction (:func:`wgrad_group`).  The
    route is chosen by shape.  Same returns as :func:`mp_ext_bwd_plain`."""
    what = "mp_ext_bwd"
    g = g.to(sw.dtype).contiguous()
    if g.shape != (sw.D, xa.shape[1]):
        raise ValueError(f"{what}: cotangent {tuple(g.shape)} for xa {tuple(xa.shape)}")
    drop = _check_ext(what, xa, sw, spec, ("g", g, 16))
    lib = _lib_ext()
    dt, D, Dp, nblk = sw.dtype, sw.D, sw.Dp, sw.n_blocks
    bf16 = int(dt == torch.bfloat16)
    walk = _ext_takes_walk(lib, bf16, Dp, nblk)
    A = xa.shape[1]
    dev = xa.device
    k = bwd_slabs(nblk)
    # the slab route also keeps t and u_i, past the walk's slabs
    wk = torch.empty(k["n"] + (0 if walk else 1 + nblk), Dp, A, dtype=dt, device=dev)
    dxa = torch.empty(2 * D, A, dtype=dt, device=dev)
    act = ACTIVATION_CODES[spec.act.lower()]
    prods = layer_products(wk, nblk)
    if not A:
        return dxa, [t for pair in wgrad_group_plain(prods) for t in pair]
    if walk:
        status = lib.mp_ext_bwd_walk(xa.data_ptr(), g.data_ptr(), dxa.data_ptr(), wk.data_ptr(),
                                     walk_weights(sw).data_ptr(), D, Dp, A, nblk, act, *drop,
                                     _stream(dev))
    else:
        status = lib.mp_ext_bwd(xa.data_ptr(), g.data_ptr(), dxa.data_ptr(), wk.data_ptr(),
                                sw.flat.data_ptr(), stack_weights_t(sw).data_ptr(), bf16, D, Dp,
                                A, nblk, act, *drop, _stream(dev))
    if status != 0:
        raise RuntimeError(f"{what}: {lib.mp_ext_error_string(status).decode()}")
    mp_ext_bwd.launches += 1
    return dxa, [t for pair in wgrad_group(prods) for t in pair]


mp_ext_bwd.launches = 0


class _ExtLayerFn(torch.autograd.Function):
    """``xa -> layer(xa)`` with one layer's fp32 master weights as
    differentiable inputs: the forward preps them once per call and the
    backward returns dxa and their fp32 grads in the caller's orientation.
    CUDA tensors launch kernel 5, CPU tensors take its plain versions."""

    @staticmethod
    def forward(ctx, xa, spec, dt, *ws):
        with torch.no_grad():
            sw = stack_weights([ws], dt)
        if xa.device.type == "cuda":
            out = mp_ext_fwd(xa, sw, spec)
        elif xa.device.type == "cpu":
            out = mp_ext_plain(xa, sw, spec)
        else:
            raise ValueError(f"binned_mp_layer_ext_t: unsupported device {xa.device}")
        ctx.save_for_backward(xa)
        ctx.sw, ctx.spec = sw, spec
        return out

    @staticmethod
    def backward(ctx, g):
        (xa,) = ctx.saved_tensors
        bwd = mp_ext_bwd if xa.device.type == "cuda" else mp_ext_bwd_plain
        dxa, lg = bwd(xa, ctx.sw, ctx.spec, g)
        return (dxa, None, None, *unprep_layer_grads(ctx.sw, lg))


def binned_mp_layer_ext_t(xa: torch.Tensor, layer_ws: Sequence[torch.Tensor], dtype: torch.dtype,
                          act: str = "silu", dropout: float = 0.0, seed: int = 0) -> torch.Tensor:
    """One shell-convolution layer on a pre-aggregated feature-major input
    (the JAX ``binned_mp_layer_ext_t``): xa (2D, A) = [x ; agg] -> (D, A) in
    ``dtype``, the residual not added.  ``layer_ws`` is one layer's fp32
    masters (``ShellConvolutionLayer.stack_weights``); ``seed`` the layer's
    own dropout seed (:func:`layer_drop_seed`; its low 32 bits are used).
    Kernel 5 on CUDA tensors, the plain versions on CPU tensors."""
    spec = StackSpec(act.lower(), float(dropout), int(seed) & _M32, 1)
    return _ExtLayerFn.apply(xa.to(dtype).contiguous(), spec, dtype, *layer_ws)
