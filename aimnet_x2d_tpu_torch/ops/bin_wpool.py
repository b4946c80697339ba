"""Weighted per-molecule pooling over the flat feature-major layout, forward
and backward (counterpart of aimnet_x2d_tpu/ops/bin_wpool.py::binned_wpool_t).

``pooled[d, b*mb + m] = sum_a x[d, b*ab + a] * w[b*ab + a] * pm[b, m, a]``:
the attention-weighted (or plain, w = 1) molecule pool of a feature-major
atom array.  The weight is cast to x's dtype and the product rounded in it;
the sum accumulates in fp32 and the output is fp32.

The backward is the JAX custom VJP's: the fp32 cotangent g is rounded to
x's dtype, ``gatom = g @ pm`` per bin in fp32, ``dx = gatom * w`` (fp32 w)
cast to x's dtype, and ``dw = sum_d gatom * x`` in fp32.  No model path of
the port needs dw yet: mean and sum pooling pass a constant w, and attention
training runs its own fused kernel (``bin_attnpool.py``); only the tests and
``chip_smoke.py`` ask the kernel for it.

On a CUDA tensor :func:`binned_wpool_t` launches the hand-written kernels
(``csrc/wpool.cu``: ``wpool_fwd``, and ``wpool_bwd`` in the backward),
which take every (nb, mb) the binned loader emits and any int8 pool matrix
(ab a multiple of 8, x and w on 16-byte boundaries, pool_mat on 8: the
wrappers check); on a CPU tensor it runs :func:`wpool_plain` and
:func:`wpool_bwd_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build


def wpool_plain(xT: torch.Tensor, w: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: xT (D, A), w (A,) fp32, pool_mat (nb, mb, ab)
    int8 -> (D, nb*mb) fp32."""
    D = xT.shape[0]
    nb, mb, ab = pool_mat.shape
    xw = xT * w.reshape(-1).to(xT.dtype)[None, :]
    out = torch.einsum("dba,bma->dbm", xw.float().reshape(D, nb, ab), pool_mat.float())
    return out.reshape(D, nb * mb)


def wpool_bwd_plain(xT: torch.Tensor, w: torch.Tensor, pool_mat: torch.Tensor, g: torch.Tensor,
                    need_dw: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward: g (D, nb*mb) fp32 -> dx (D, A)
    in x's dtype and dw (A,) fp32 (None unless ``need_dw``)."""
    D = xT.shape[0]
    nb, mb, ab = pool_mat.shape
    gg = g.to(xT.dtype).float().reshape(D, nb, mb)
    gatom = torch.einsum("dbm,bma->dba", gg, pool_mat.float()).reshape(D, nb * ab)
    dx = (gatom * w.reshape(1, -1).float()).to(xT.dtype)
    dw = (gatom * xT.float()).sum(0) if need_dw else None
    return dx, dw


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("wpool")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.wpool_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.wpool_fwd.restype = i
        lib.wpool_bwd.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.wpool_bwd.restype = i
        for fn in (lib.wpool_smem_bytes, lib.wpool_bwd_smem_bytes):
            fn.argtypes = [i, i, i]
            fn.restype = ctypes.c_longlong
        lib.wpool_error_string.argtypes = [i]
        lib.wpool_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


_SMEM: Dict[Tuple[str, int, int, int], int] = {}  # (entry, bf16, mb, ab) -> bytes


def _check(what: str, xT: torch.Tensor, w: torch.Tensor, pool_mat: torch.Tensor, smem_fn: str):
    """Raise on any input the kernels do not take; return (lib, bf16, D, A,
    nb, mb, ab).  The shared-memory size of a shape is asked once."""
    if xT.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: unsupported dtype {xT.dtype}")
    if w.dtype != torch.float32 or pool_mat.dtype != torch.int8:
        raise TypeError(f"{what}: w must be float32 and pool_mat int8")
    cuda_build.check_cuda(what, xT.device, ("xT", xT, 16), ("w", w, 16), ("pool_mat", pool_mat, 8))
    D, A = xT.shape
    nb, mb, ab = pool_mat.shape
    if A != nb * ab or w.shape[0] != A or ab % 8:
        raise ValueError(
            f"{what}: xT {tuple(xT.shape)}, w {tuple(w.shape)}, pool_mat "
            f"{tuple(pool_mat.shape)}: need A = nb*ab and ab a multiple of 8"
        )
    lib = _lib()
    bf16 = int(xT.dtype == torch.bfloat16)
    key = (smem_fn, bf16, mb, ab)
    smem = _SMEM.get(key)
    if smem is None:
        smem = _SMEM[key] = getattr(lib, smem_fn)(bf16, mb, ab)
    if smem > cuda_build.SMEM_LIMIT:
        raise ValueError(f"{what}: mb={mb}, ab={ab} exceed one block's shared memory")
    return lib, bf16, D, A, nb, mb, ab


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def wpool_fwd(xT: torch.Tensor, w: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA pool kernel on the current stream.  Raises on any
    input the kernel does not take and on any launch error."""
    if w.dim() != 1:
        w = w.reshape(-1)
    lib, bf16, D, A, nb, mb, ab = _check("wpool_fwd", xT, w, pool_mat, "wpool_smem_bytes")
    out = xT.new_empty((D, nb * mb), dtype=torch.float32)
    if D and nb and mb:
        status = lib.wpool_fwd(xT.data_ptr(), w.data_ptr(), pool_mat.data_ptr(), out.data_ptr(),
                               bf16, D, A, nb, mb, ab, _stream(xT))
        if status != 0:
            raise RuntimeError(f"wpool_fwd: {lib.wpool_error_string(status).decode()}")
        wpool_fwd.launches += 1
    return out


wpool_fwd.launches = 0


def wpool_bwd(xT: torch.Tensor, w: torch.Tensor, pool_mat: torch.Tensor, g: torch.Tensor,
              need_dw: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA backward kernel on the current stream (one launch;
    dw, when asked, is summed inside it in a fixed order).  Same returns as
    :func:`wpool_bwd_plain`.  Raises on any input the kernel does not take
    and on any launch error."""
    if w.dim() != 1:
        w = w.reshape(-1)
    lib, bf16, D, A, nb, mb, ab = _check("wpool_bwd", xT, w, pool_mat, "wpool_bwd_smem_bytes")
    if g.dtype != torch.float32 or g.shape != (D, nb * mb):
        raise ValueError(f"wpool_bwd: g {g.dtype} {tuple(g.shape)}, need float32 ({D}, {nb * mb})")
    cuda_build.check_cuda("wpool_bwd", xT.device, ("g", g, 4))
    dx = torch.empty_like(xT)
    dw = torch.empty(A, dtype=torch.float32, device=xT.device) if need_dw else None
    if D and nb:
        status = lib.wpool_bwd(xT.data_ptr(), w.data_ptr(), pool_mat.data_ptr(), g.data_ptr(),
                               dx.data_ptr(), dw.data_ptr() if need_dw else None,
                               bf16, D, A, nb, mb, ab, _stream(xT))
        if status != 0:
            raise RuntimeError(f"wpool_bwd: {lib.wpool_error_string(status).decode()}")
        wpool_bwd.launches += 1
    elif need_dw:
        dw.zero_()
    return dx, dw


wpool_bwd.launches = 0


class _WPoolFn(torch.autograd.Function):
    """The pool with the JAX package's VJP: kernels on CUDA tensors, plain
    versions on CPU tensors.  dw is computed only when w needs a gradient
    (mean and sum pooling pass a constant w)."""

    @staticmethod
    def forward(ctx, xT, w, pool_mat):
        if xT.device.type == "cuda":
            out = wpool_fwd(xT, w, pool_mat)
        elif xT.device.type == "cpu":
            out = wpool_plain(xT, w, pool_mat)
        else:
            raise ValueError(f"binned_wpool_t: unsupported device {xT.device}")
        ctx.save_for_backward(xT, w, pool_mat)
        return out

    @staticmethod
    def backward(ctx, g):
        xT, w, pool_mat = ctx.saved_tensors
        bwd = wpool_bwd if xT.device.type == "cuda" else wpool_bwd_plain
        dx, dw = bwd(xT, w, pool_mat, g.float().contiguous(), need_dw=ctx.needs_input_grad[1])
        return dx, dw, None


def binned_wpool_t(xT: torch.Tensor, wbar: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """Weighted pool: xT (D, A), wbar (A,) or (1, A) fp32, pool_mat
    (nb, mb, ab) int8 -> pooled (D, nb*mb) fp32, differentiable in xT and
    wbar.  CUDA tensors go through the kernels, CPU tensors through the
    plain versions."""
    w = wbar.reshape(-1).float().contiguous()
    return _WPoolFn.apply(xT.contiguous(), w, pool_mat.contiguous())
