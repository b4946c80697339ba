"""Binned attention pooling of row-major atom arrays, forward and backward
(counterpart of aimnet_x2d_tpu/ops/bin_pool.py::binned_attention_pool_fused,
kernel 6).

Per bin, with the bin's rows xs (ab, Ds) and xo (ab, Do):

    s    = xs ks + xo ko + b                       (ab, H) fp32
    attn = per-molecule masked softmax of s        (-1e30 mask, max shift,
                                                    exp on covered atoms only,
                                                    1e-16 floor)
    w    = mean over heads of attn                 fp32
    pooled_self  = sum over each molecule's atoms of rnd(xs * rnd(w))   (mb, Ds) fp32
    pooled_other = the same for xo                                       (mb, Do) fp32
    coverage     = sum over each molecule's atoms of w                   (mb,) fp32

with the JAX cast points: ks and ko rounded to the compute dtype, b in fp32,
fp32 sums; in the backward the softmax cotangent ds is rounded to the
compute dtype before the dx and weight-gradient products and before d_b's
sum, and dx is summed in fp32 and cast once.  The temperature and
concat_self_other folds stay outside, in plain autograd (models/pooling.py).

On CUDA tensors :func:`binned_attention_pool_fused` launches the
hand-written kernels (``csrc/bin_pool.cu``) through :func:`bin_pool_fwd`
and :func:`bin_pool_bwd`, each with its launch count; on CPU tensors it
runs :func:`pool_fwd_plain` and :func:`pool_bwd_plain`.  Both directions
run on 64-atom tiles, a cluster of tiles a bin, where the shape fits them
(:func:`takes_tiles`, :func:`takes_bwd_tiles`), else one block a bin,
chosen by shape and counted in ``bin_pool_fwd.routes`` and
``bin_pool_bwd.routes``.  The kernels take any (nb, mb, ab) and never fall
back; they assume what the loaders build: each atom belongs to at most one
molecule of its bin (``bin_attnpool.check_one_owner``, which the CPU path
runs).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import bin_mp, cuda_build
from .bin_attnpool import _softmax_plain, check_one_owner


def _to_atoms(g: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
    """(nb*mb, D) per-molecule rows -> (nb*ab, D): each atom takes its
    molecule's row (0 for atoms of no molecule)."""
    nb, mb, ab = pm.shape
    out = torch.einsum("bma,bmd->bad", pm.float(), g.float().reshape(nb, mb, -1))
    return out.reshape(nb * ab, -1)


def _pool_rows(x: torch.Tensor, wdt: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
    nb, mb, ab = pm.shape
    xw = (x * wdt[:, None]).float().reshape(nb, ab, -1)
    return torch.einsum("bma,bad->bmd", pm.float(), xw).reshape(nb * mb, -1)


def pool_fwd_plain(xs, xo, pm, ks, ko, b):
    """Plain PyTorch version of the forward (the JAX ``_softmax_fwd`` and
    ``fwd_kernel`` over every bin): xs (A, Ds) and xo (A, Do) in the compute
    dtype, ks (Ds, H) and ko (Do, H) in it, b (H,) fp32.  Returns
    (pooled_self (B, Ds), pooled_other (B, Do), coverage (B,), attn (H, A)),
    all fp32."""
    nb, mb, ab = pm.shape
    s = (xs.float() @ ks.float() + xo.float() @ ko.float()) + b.float()
    attn = _softmax_plain(s.T.contiguous(), pm)
    wbar = attn.mean(dim=0)
    wdt = wbar.to(xs.dtype)
    cov = torch.einsum("bma,ba->bm", pm.float(), wbar.reshape(nb, ab)).reshape(-1)
    return _pool_rows(xs, wdt, pm), _pool_rows(xo, wdt, pm), cov, attn


def pool_bwd_plain(xs, xo, pm, ks, ko, attn, gps, gpo, gcov):
    """Plain PyTorch version of the backward (the JAX ``bwd_kernel``), from
    the forward's attn (H, A) and the fp32 cotangents gps (B, Ds), gpo
    (B, Do), gcov (B,).  Returns (dxs, dxo) in the compute dtype and the fp32
    (dks (Ds, H), dko (Do, H), db (H,))."""
    dt = xs.dtype
    nb, mb, ab = pm.shape
    H = attn.shape[0]
    gs, go = _to_atoms(gps, pm), _to_atoms(gpo, pm)
    wbar = attn.mean(dim=0)
    dwbar = ((gs * xs.float()).sum(1) + (go * xo.float()).sum(1)
             + _to_atoms(gcov.reshape(-1, 1), pm)[:, 0])
    at = attn.T  # (A, H)
    ad = at * (dwbar / H)[:, None]
    pmf = pm.float()
    t_mol = torch.einsum("bma,bah->bmh", pmf, ad.reshape(nb, ab, H))
    t_atom = torch.einsum("bma,bmh->bah", pmf, t_mol).reshape(nb * ab, H)
    ds = (ad - at * t_atom).to(dt).float()
    dxs = (gs * wbar[:, None] + ds @ ks.float().T).to(dt)
    dxo = (go * wbar[:, None] + ds @ ko.float().T).to(dt)
    return dxs, dxo, (xs.float().T @ ds, xo.float().T @ ds, ds.sum(0))


# ---- CUDA wrappers -------------------------------------------------------- #


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("bin_pool")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bin_pool_fwd.argtypes = [vp] * 8 + [i] * 7 + [vp]
        lib.bin_pool_fwd.restype = i
        lib.bin_pool_bwd.argtypes = [vp] * 11 + [i] * 7 + [vp]
        lib.bin_pool_bwd.restype = i
        lib.bin_pool_sum_partials.argtypes = [vp, vp, i, ctypes.c_longlong, vp]
        lib.bin_pool_sum_partials.restype = i
        lib.bin_pool_fwd_tiles.argtypes = [vp] * 8 + [i] * 7 + [vp]
        lib.bin_pool_fwd_tiles.restype = i
        lib.bin_pool_tiles_smem_bytes.argtypes = [i] * 6
        lib.bin_pool_tiles_smem_bytes.restype = ctypes.c_longlong
        lib.bin_pool_bwd_tiles.argtypes = [vp] * 11 + [i] * 7 + [vp]
        lib.bin_pool_bwd_tiles.restype = i
        lib.bin_pool_bwd_tiles_smem_bytes.argtypes = [i] * 6
        lib.bin_pool_bwd_tiles_smem_bytes.restype = ctypes.c_longlong
        lib.bin_pool_smem_bytes.argtypes = [i, i, i]
        lib.bin_pool_smem_bytes.restype = ctypes.c_longlong
        lib.bin_pool_error_string.argtypes = [i]
        lib.bin_pool_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _score(ks, ko, b=None) -> torch.Tensor:
    """[ks, ko, b] as one fp32 buffer (ks and ko hold compute-dtype values;
    the backward reads no b)."""
    parts = [ks.float().reshape(-1), ko.float().reshape(-1)]
    return torch.cat(parts + ([b.float()] if b is not None else [])).contiguous()


def _check(what, xs, xo, pm, ks, ko):
    dt = xs.dtype
    if dt not in (torch.float32, torch.bfloat16) or xo.dtype != dt:
        raise TypeError(f"{what}: x_self {xs.dtype}, x_other {xo.dtype}")
    if pm.dtype != torch.int8:
        raise TypeError(f"{what}: pool_mat must be int8")
    nb, mb, ab = pm.shape
    A, Ds = xs.shape
    Do, H = xo.shape[1], ks.shape[1]
    if A != nb * ab or xo.shape[0] != A or ks.shape[0] != Ds or ko.shape != (Do, H):
        raise ValueError(f"{what}: x_self {tuple(xs.shape)}, x_other {tuple(xo.shape)}, pool_mat "
                         f"{tuple(pm.shape)}, ks {tuple(ks.shape)}, ko {tuple(ko.shape)}: need "
                         f"A = nb*ab and score weights (Ds, H), (Do, H)")
    cuda_build.check_cuda(what, xs.device, ("x_self", xs, 2), ("x_other", xo, 2),
                          ("pool_mat", pm, 1))
    lib = _lib()
    if lib.bin_pool_smem_bytes(H, mb, ab) > cuda_build.SMEM_LIMIT:
        raise ValueError(f"{what}: H={H}, mb={mb}, ab={ab} exceed one block's shared memory "
                         f"or the kernel's 8 heads")
    return lib, nb, mb, ab, A, Ds, Do, H, int(dt == torch.bfloat16)


_TILES: dict = {}  # (bf16, Ds, Do, H, mb, ab) -> the forward on tiles takes it


def takes_tiles(lib, bf16: int, Ds: int, Do: int, H: int, mb: int, ab: int) -> bool:
    """Whether the forward runs on 64-atom tiles (``bin_pool_fwd_tile_kernel``,
    a cluster a bin: H <= 8, ab a multiple of 64 up to 512, the tile's rows
    in one block's shared memory); else on the kernel of one block a bin.
    Asked of the library once per shape."""
    key = (bf16, Ds, Do, H, mb, ab)
    if key not in _TILES:
        _TILES[key] = lib.bin_pool_tiles_smem_bytes(*key) >= 0
    return _TILES[key]


def bin_pool_fwd(xs, xo, pm, ks, ko, b):
    """Launch the forward kernel: on 64-atom tiles where the shape fits them
    (:func:`takes_tiles`; xs and xo must then start on 16-byte boundaries,
    for the tiles' bulk copies), else one block per bin; the route chosen
    by shape and counted in ``bin_pool_fwd.routes``.  Same arguments and
    returns as :func:`pool_fwd_plain`."""
    lib, nb, mb, ab, A, Ds, Do, H, bf16 = _check("bin_pool_fwd", xs, xo, pm, ks, ko)
    dev = xs.device
    tiles = takes_tiles(lib, bf16, Ds, Do, H, mb, ab)
    if tiles:
        cuda_build.check_cuda("bin_pool_fwd", dev, ("x_self", xs, 16), ("x_other", xo, 16))
    ps = torch.empty(nb * mb, Ds, dtype=torch.float32, device=dev)
    po = torch.empty(nb * mb, Do, dtype=torch.float32, device=dev)
    cov = torch.empty(nb * mb, dtype=torch.float32, device=dev)
    attn = torch.empty(H, A, dtype=torch.float32, device=dev)
    if nb:
        entry = lib.bin_pool_fwd_tiles if tiles else lib.bin_pool_fwd
        status = entry(
            xs.data_ptr(), xo.data_ptr(), pm.data_ptr(), _score(ks, ko, b).data_ptr(),
            ps.data_ptr(), po.data_ptr(), cov.data_ptr(), attn.data_ptr(), bf16, Ds, Do, H,
            nb, mb, ab, bin_mp._stream(dev))
        if status != 0:
            raise RuntimeError(f"bin_pool_fwd: {lib.bin_pool_error_string(status).decode()}")
        bin_pool_fwd.launches += 1
        bin_pool_fwd.routes["tiles" if tiles else "bins"] += 1
    return ps, po, cov, attn


bin_pool_fwd.launches = 0
bin_pool_fwd.routes = {"tiles": 0, "bins": 0}  # launches on tiles, of one block a bin


_BWD_TILES: dict = {}  # (bf16, Ds, Do, H, mb, ab) -> the backward on tiles takes it


def takes_bwd_tiles(lib, bf16: int, Ds: int, Do: int, H: int, mb: int, ab: int) -> bool:
    """Whether the backward runs on 64-atom tiles (``bin_pool_bwd_tile_kernel``,
    a cluster a bin: H <= 8, ab a multiple of 64 up to 512, the tile's rows
    in one block's shared memory); else on the kernel of one block a bin.
    Asked of the library once per shape."""
    key = (bf16, Ds, Do, H, mb, ab)
    if key not in _BWD_TILES:
        _BWD_TILES[key] = lib.bin_pool_bwd_tiles_smem_bytes(*key) >= 0
    return _BWD_TILES[key]


def bin_pool_bwd(xs, xo, pm, ks, ko, attn, gps, gpo, gcov):
    """Launch the backward kernel -- on 64-atom tiles where the shape fits
    them (:func:`takes_bwd_tiles`; xs and xo must then start on 16-byte
    boundaries, for the tiles' bulk copies), else one block per bin; the
    route chosen by shape and counted in ``bin_pool_bwd.routes`` -- and the
    fixed-order sum of its per-bin weight-gradient partials.  Same
    arguments and returns as :func:`pool_bwd_plain`."""
    lib, nb, mb, ab, A, Ds, Do, H, bf16 = _check("bin_pool_bwd", xs, xo, pm, ks, ko)
    dev = xs.device
    gps, gpo, gcov = (g.float().contiguous() for g in (gps, gpo, gcov))
    attn = attn.contiguous()
    cuda_build.check_cuda("bin_pool_bwd", dev, ("attn", attn, 4), ("g_self", gps, 4),
                          ("g_other", gpo, 4), ("g_cov", gcov, 4))
    tiles = takes_bwd_tiles(lib, bf16, Ds, Do, H, mb, ab)
    if tiles:
        cuda_build.check_cuda("bin_pool_bwd", dev, ("x_self", xs, 16), ("x_other", xo, 16))
    dxs = torch.empty_like(xs)
    dxo = torch.empty_like(xo)
    psize = (Ds + Do) * H + H
    part = torch.empty(nb, psize, dtype=torch.float32, device=dev)
    red = torch.zeros(psize, dtype=torch.float32, device=dev)
    if nb:
        stream = bin_mp._stream(dev)
        entry = lib.bin_pool_bwd_tiles if tiles else lib.bin_pool_bwd
        status = entry(
            xs.data_ptr(), xo.data_ptr(), pm.data_ptr(), _score(ks, ko).data_ptr(), attn.data_ptr(),
            gps.data_ptr(), gpo.data_ptr(), gcov.data_ptr(), dxs.data_ptr(), dxo.data_ptr(),
            part.data_ptr(), bf16, Ds, Do, H, nb, mb, ab, stream)
        if status == 0:
            status = lib.bin_pool_sum_partials(part.data_ptr(), red.data_ptr(), nb, psize, stream)
        if status != 0:
            raise RuntimeError(f"bin_pool_bwd: {lib.bin_pool_error_string(status).decode()}")
        bin_pool_bwd.launches += 1
        bin_pool_bwd.routes["tiles" if tiles else "bins"] += 1
    return dxs, dxo, (red[: Ds * H].view(Ds, H), red[Ds * H : (Ds + Do) * H].view(Do, H),
                      red[(Ds + Do) * H :])


bin_pool_bwd.launches = 0
bin_pool_bwd.routes = {"tiles": 0, "bins": 0}  # launches on tiles, of one block a bin


class _PoolFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, xo, pm, k_self, k_other, b):
        dt = xs.dtype
        ks, ko, b32 = k_self.to(dt), k_other.to(dt), b.float()
        if xs.device.type == "cuda":
            ps, po, cov, attn = bin_pool_fwd(xs, xo, pm, ks, ko, b32)
        elif xs.device.type == "cpu":
            check_one_owner(pm)  # free here; on the card it would cost a sync per step
            ps, po, cov, attn = pool_fwd_plain(xs, xo, pm, ks, ko, b32)
        else:
            raise ValueError(f"binned_attention_pool_fused: unsupported device {xs.device}")
        ctx.save_for_backward(xs, xo, pm, ks, ko, attn)
        ctx.mark_non_differentiable(attn)
        return ps, po, cov, attn

    @staticmethod
    def backward(ctx, gps, gpo, gcov, _gattn):
        xs, xo, pm, ks, ko, attn = ctx.saved_tensors
        B = pm.shape[0] * pm.shape[1]
        zeros = lambda *n: torch.zeros(*n, dtype=torch.float32, device=xs.device)  # noqa: E731
        gps = gps if gps is not None else zeros(B, xs.shape[1])
        gpo = gpo if gpo is not None else zeros(B, xo.shape[1])
        gcov = gcov if gcov is not None else zeros(B)
        bwd = bin_pool_bwd if xs.device.type == "cuda" else pool_bwd_plain
        dxs, dxo, (dks, dko, db) = bwd(xs, xo, pm, ks, ko, attn, gps, gpo, gcov)
        return dxs, dxo, None, dks, dko, db


def binned_attention_pool_fused(
    x_self: torch.Tensor,
    x_other: torch.Tensor,
    pool_mat: torch.Tensor,
    score_k: torch.Tensor,
    score_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scores -> per-molecule softmax -> pools over the binned layout,
    differentiable.  x_self (A, Ds) in the compute dtype, x_other (A, Do)
    (cast to it); pool_mat (nb, mb, ab) int8, 0/1 with at most one molecule
    per atom; score_k (Ds + Do, H) and score_b (H,) fp32 with the
    concat_self_other and temperature folds applied.  score_k's two row
    blocks are rounded to the compute dtype, score_b stays fp32, and their
    gradients come back in fp32.  Returns (pooled_self (B, Ds), pooled_other
    (B, Do), coverage (B,), attn (H, A)), all fp32, B = nb*mb; attn carries
    no gradient."""
    dt = x_self.dtype
    Ds = x_self.shape[1]
    return _PoolFn.apply(x_self.contiguous(), x_other.to(dt).contiguous(),
                         pool_mat.contiguous(), score_k[:Ds], score_k[Ds:], score_b)
