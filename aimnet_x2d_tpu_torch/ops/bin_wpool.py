"""Weighted per-molecule pooling over the flat feature-major layout, forward
(counterpart of aimnet_x2d_tpu/ops/bin_wpool.py::binned_wpool_t).

``pooled[d, b*mb + m] = sum_a x[d, b*ab + a] * w[b*ab + a] * pm[b, m, a]``:
the attention-weighted (or plain, w = 1) molecule pool of a feature-major
atom array.  The weight is cast to x's dtype and the product rounded in it;
the sum accumulates in fp32 and the output is fp32.

On a CUDA tensor :func:`binned_wpool_t` launches the hand-written kernel
(``csrc/wpool.cu``), which takes every (nb, mb) the binned loader emits; on
a CPU tensor it runs :func:`wpool_plain`.
"""

from __future__ import annotations

import ctypes

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


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("wpool")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.wpool_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.wpool_fwd.restype = i
        lib.wpool_smem_bytes.argtypes = [i, i]
        lib.wpool_smem_bytes.restype = ctypes.c_longlong
        lib.wpool_error_string.argtypes = [i]
        lib.wpool_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def wpool_fwd(xT: torch.Tensor, w: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA pool kernel on the current stream.  Raises on any
    input the kernel does not take and on any launch error."""
    if xT.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wpool_fwd: unsupported dtype {xT.dtype}")
    w = w.reshape(-1)
    if w.dtype != torch.float32 or pool_mat.dtype != torch.int8:
        raise TypeError("wpool_fwd: w must be float32 and pool_mat int8")
    cuda_build.check_cuda("wpool_fwd", xT.device, ("xT", xT, 1), ("w", w, 1),
                          ("pool_mat", pool_mat, 1))
    D, A = xT.shape
    nb, mb, ab = pool_mat.shape
    if A != nb * ab or w.shape[0] != A:
        raise ValueError(
            f"wpool_fwd: xT {tuple(xT.shape)}, w {tuple(w.shape)}, pool_mat "
            f"{tuple(pool_mat.shape)}: need A = nb*ab"
        )
    lib = _lib()
    if lib.wpool_smem_bytes(mb, ab) > cuda_build.SMEM_LIMIT:
        raise ValueError(f"wpool_fwd: mb={mb}, ab={ab} exceed one block's shared memory")
    out = torch.empty(D, nb * mb, dtype=torch.float32, device=xT.device)
    if D and nb and mb:
        status = lib.wpool_fwd(
            xT.data_ptr(), w.data_ptr(), pool_mat.data_ptr(), out.data_ptr(),
            int(xT.dtype == torch.bfloat16), D, A, nb, mb, ab,
            torch.cuda.current_stream(xT.device).cuda_stream,
        )
        if status != 0:
            raise RuntimeError(f"wpool_fwd: {lib.wpool_error_string(status).decode()}")
        wpool_fwd.launches += 1
    return out


wpool_fwd.launches = 0


def binned_wpool_t(xT: torch.Tensor, wbar: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """Weighted pool: xT (D, A), wbar (A,) or (1, A) fp32, pool_mat
    (nb, mb, ab) int8 -> pooled (D, nb*mb) fp32.  CUDA tensors go through
    the kernel, CPU tensors through the plain version."""
    w = wbar.reshape(-1).float()
    if xT.device.type == "cuda":
        return wpool_fwd(xT.contiguous(), w.contiguous(), pool_mat)
    if xT.device.type == "cpu":
        return wpool_plain(xT, w, pool_mat)
    raise ValueError(f"binned_wpool_t: unsupported device {xT.device}")
