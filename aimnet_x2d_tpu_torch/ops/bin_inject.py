"""One config-3 message-passing round, forward and backward (counterpart of
aimnet_x2d_tpu/ops/bin_inject.py::binned_inject_mp_layer_t, kernel 4).

Per bin, feature-major (features on rows, atoms on columns):

    x'   = x with rows 0/1 (charge q, electronegativity f) equilibrated per
           molecule: f0 = clip(f, 1e-6), F = clip(sum f0 + 1e-6, 1e-6),
           f' = f0 / F, q' = q + f' (Q_total - sum q)        (padding: f' = 0)
    cct  = x' + x' S^T                 S the signed int8 cis/trans adjacency
    tet  = m * (x' + delta)            the tetrahedral polynomial of every
           centre of the bin's table, added into its four neighbours;
           m = 0 off the neighbours when any centre is in the batch
    pre  = kb^T [x'; cct; tet] + b     one fp32 sum, one cast, bias in dt
    out  = layer(pre) + pre            kernel 1d

with the JAX op's cast points and numerics (|e| floored at 1e-8, the
tanh(sum|e| / 12) scale, the zero gradient where clip(f, 1e-6) binds, padded
table slots (-1) contributing nothing).  The backward walks back through the
layer (kernel 1d's backward gives the fp32 cotangent of ``pre``, residual
included), the projection, the polynomial and the equilibration, and returns
dx with fp32 gradients of kb, b and the layer's weights.

On CUDA tensors the forward launches ``csrc/inject.cu`` (``inject_fwd``, x',
cct, tet and ``pre``: in bf16 one block per 64-atom tile with the three on
chip, in fp32 and past its shapes one block per bin, chosen by shape) and
then kernel 1d; the backward
launches kernel 1d's backward, whose one grouped contraction
(``csrc/wgrad_group.cuh``) also forms kb's and b's gradients, and then
``inject_bwd`` (dx): in bf16 the tiled kernel (a cluster of 64-atom tiles per
bin, the cotangents on chip), in fp32 and past its shapes the kernel of one
block per bin, chosen by shape.  On CPU tensors the plain versions here run
the same arithmetic.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import bin_attnpool, bin_mp, cuda_build


@dataclasses.dataclass
class InjectWeights:
    """The stereo projection in the kernels' form, with the layer's
    prepped weights: ``kbT`` (Dp, 3Dp) = [k0^T | k1^T | k2^T] and ``b``
    (Dp,) in the compute dtype, D padded to Dp with zeros; ``flat`` holds
    [kbT, b] for the forward kernel and ``flat_t`` holds kb (3Dp, Dp) for the
    backward (tile-major in bf16)."""

    kbT: torch.Tensor
    b: torch.Tensor
    flat: torch.Tensor
    flat_t: torch.Tensor
    sw: bin_mp.StackWeights

    @property
    def dtype(self) -> torch.dtype:
        return self.kbT.dtype


def prep_inject(kb: torch.Tensor, b: torch.Tensor, layer_ws: Sequence[torch.Tensor],
                dt: torch.dtype) -> InjectWeights:
    """kb (3D, D) and b (D,) fp32 masters (flax orientation) and one
    layer's fp32 weights -> InjectWeights."""
    D = kb.shape[1]
    Dp = bin_mp.padded_dim(D)
    kbT = kb.new_zeros(Dp, 3 * Dp, dtype=dt)
    for i in range(3):
        kbT[:D, i * Dp : i * Dp + D] = kb[i * D : (i + 1) * D].T.to(dt)
    bb = b.new_zeros(Dp, dtype=dt)
    bb[:D] = b.to(dt)
    lay = bin_mp.tile_major if dt == torch.bfloat16 else (lambda w: w.reshape(-1))
    flat = torch.cat([lay(kbT), bb]).contiguous()
    flat_t = lay(kbT.T.contiguous()).contiguous()
    return InjectWeights(kbT, bb, flat, flat_t, bin_mp.stack_weights([layer_ws], dt))


# ---- plain PyTorch versions ------------------------------------------------ #


def _charge_fwd(x, tca, pool):
    """Equilibrated rows (q', f') fp32 (nb, ab) and what the backward reads."""
    nb, mb, ab = pool.shape
    poolf = pool.float()
    q = x[0].float().view(nb, ab)
    f0 = x[1].float().clamp(min=1e-6).view(nb, ab)
    QFq = torch.einsum("bma,ba->bm", poolf, q)
    F_u = (torch.einsum("bma,ba->bm", poolf, f0) + 1e-6).clamp(min=1e-6)
    inv_atom = torch.einsum("bm,bma->ba", 1.0 / F_u, poolf)
    dQ_atom = tca.view(nb, ab) - torch.einsum("bm,bma->ba", QFq, poolf)
    f_new = f0 * inv_atom
    q_new = q + f_new * dQ_atom
    return q_new, f_new, (poolf, f0, F_u, inv_atom, dQ_atom, f_new)


def charge_rows(x, tca, pool):
    """x' of x (D, A): rows 0/1 equilibrated per molecule in fp32 and cast
    to x's dtype, the other rows as they are (the JAX ``_charge_rows_t``).
    Differentiable; the model's route with charges but no stereochemistry
    runs it as plain PyTorch, as JAX runs it as XLA."""
    q_new, f_new, _ = _charge_fwd(x, tca, pool)
    return torch.cat([q_new.reshape(1, -1).to(x.dtype), f_new.reshape(1, -1).to(x.dtype), x[2:]])


def _charge_bwd(x, saved, dxp32):
    """dx32 from the cotangent of x' (fp32, all rows)."""
    poolf, f0, F_u, inv_atom, dQ_atom, f_new = saved
    nb, _, ab = poolf.shape
    dqn, dfn = dxp32[0].view(nb, ab), dxp32[1].view(nb, ab)
    df_new = dfn + dqn * dQ_atom
    d_QFq = -torch.einsum("ba,bma->bm", dqn * f_new, poolf)
    d_F = -torch.einsum("ba,bma->bm", df_new * f0, poolf) / (F_u * F_u)
    dq = dqn + torch.einsum("bm,bma->ba", d_QFq, poolf)
    df = df_new * inv_atom + torch.einsum("bm,bma->ba", d_F, poolf)
    # the clip binds where f < 1e-6: no gradient there (F's clip never binds)
    df = torch.where(x[1].float().view(nb, ab) >= 1e-6, df, torch.zeros((), device=df.device))
    return torch.cat([dq.reshape(1, -1), df.reshape(1, -1), dxp32[2:]])


def _agg(v, adj, dt):
    """Per bin ``v adj^T`` of v (rows, A) rounded to dt, fp32."""
    nb, ab, _ = adj.shape
    vb = v.to(dt).float().reshape(v.shape[0], nb, ab).permute(1, 0, 2)
    return torch.matmul(vb, adj.float().transpose(1, 2)).permute(1, 0, 2).reshape(v.shape)


def _agg_t(v, adj, dt):
    """Per bin ``v adj`` (the aggregation's transpose) of v rounded to dt, fp32."""
    nb, ab, _ = adj.shape
    vb = v.to(dt).float().reshape(v.shape[0], nb, ab).permute(1, 0, 2)
    return torch.matmul(vb, adj.float()).permute(1, 0, 2).reshape(v.shape)


def _tet_parts(xp, tet_bin, anyt):
    """The polynomial of every centre slot: per neighbour k the gather
    index, validity, eN, sq, P, and |e|, clip(|e|), scale, the mask m of
    each column."""
    D, A = xp.shape
    nb, _, tc = tet_bin.shape
    ab = A // nb
    xb = xp.float().view(D, nb, ab)
    valid = (tet_bin >= 0).float()  # (nb, 4, Tc)
    idx = tet_bin.clamp(min=0).long()
    es = [torch.gather(xb, 2, idx[:, k][None].expand(D, nb, tc)) * valid[:, k][None]
          for k in range(4)]
    mags = [torch.sqrt((e * e).sum(0)) for e in es]
    mcl = [m.clamp(min=1e-8) for m in mags]
    eN = [e / m for e, m in zip(es, mcl)]
    sq = [e * e for e in eN]
    u = (mags[0] + mags[1] + mags[2] + mags[3]) * (1.0 / 12.0)
    scale = torch.tanh(u) * anyt
    P = []
    for k in range(4):
        a1, a2, a3 = (k + 1) % 4, (k + 2) % 4, (k + 3) % 4
        P.append(sq[a1] * (eN[a2] - eN[a3]) + sq[a2] * (eN[a3] - eN[a1])
                 + sq[a3] * (eN[a1] - eN[a2]))
    count = torch.zeros(nb, ab, device=xp.device).scatter_add_(1, idx.reshape(nb, -1),
                                                               valid.reshape(nb, -1))
    m = anyt * (count > 0).float() + (1.0 - anyt)  # (nb, ab)
    return idx, valid, eN, sq, P, mags, mcl, u, scale, m


def _scatter(parts, idx, valid, D, nb, ab):
    """(D, nb, ab) fp32 sum of each part (D, nb, Tc) into its columns."""
    out = torch.zeros(D, nb, ab, device=parts[0].device)
    for k, p in enumerate(parts):
        out.scatter_add_(2, idx[:, k][None].expand(D, nb, -1), p * valid[:, k][None])
    return out


def _tet_fwd(xp, tet_bin, anyt, dt):
    D, A = xp.shape
    nb = tet_bin.shape[0]
    idx, valid, _, _, P, _, _, _, scale, m = _tet_parts(xp, tet_bin, anyt)
    delta = _scatter([p * scale for p in P], idx, valid, D, nb, A // nb).view(D, A)
    return (xp + delta.to(dt)) * m.to(dt).view(1, A)


def _tet_bwd(xp, tet_bin, anyt, dtet32):
    """dx' (fp32) from the tet part's cotangent."""
    D, A = xp.shape
    nb, _, tc = tet_bin.shape
    idx, valid, eN, sq, P, mags, mcl, u, scale, m = _tet_parts(xp, tet_bin, anyt)
    dDelta = (dtet32.view(D, nb, -1) * m[None])  # the direct path has the same value
    dchir = [torch.gather(dDelta, 2, idx[:, k][None].expand(D, nb, tc)) * valid[:, k][None]
             for k in range(4)]
    dscale = sum((dchir[k] * P[k]).sum(0) for k in range(4))
    d_eN = [torch.zeros_like(eN[0]) for _ in range(4)]
    d_sq = [torch.zeros_like(eN[0]) for _ in range(4)]
    for k in range(4):
        a1, a2, a3 = (k + 1) % 4, (k + 2) % 4, (k + 3) % 4
        dP = dchir[k] * scale
        d_sq[a1] = d_sq[a1] + dP * (eN[a2] - eN[a3])
        d_sq[a2] = d_sq[a2] + dP * (eN[a3] - eN[a1])
        d_sq[a3] = d_sq[a3] + dP * (eN[a1] - eN[a2])
        d_eN[a2] = d_eN[a2] + dP * sq[a1] - dP * sq[a3]
        d_eN[a3] = d_eN[a3] - dP * sq[a1] + dP * sq[a2]
        d_eN[a1] = d_eN[a1] - dP * sq[a2] + dP * sq[a3]
    du = dscale * (1.0 - torch.tanh(u) ** 2) * anyt * (1.0 / 12.0)
    d_e = []
    for k in range(4):
        dEt = d_eN[k] + 2.0 * eN[k] * d_sq[k]
        dmclip = -(dEt * eN[k]).sum(0) / mcl[k]
        dmags = torch.where(mags[k] >= 1e-8, dmclip, torch.zeros((), device=xp.device)) + du
        d_e.append(dEt / mcl[k] + dmags * eN[k])
    return dDelta.reshape(D, A) + _scatter(d_e, idx, valid, D, nb, A // nb).view(D, A)


def inject_fwd_plain(x, tca, pool, tet_bin, any_tet, sadj, iw: InjectWeights):
    """Plain version of the inject kernel: (pre (D, A), xct (3Dp, A) =
    [x'; cct; tet] with zero padded rows), both in the compute dtype."""
    bin_attnpool.check_one_owner(pool)
    dt = iw.dtype
    D, Dp = x.shape[0], iw.sw.Dp
    anyt = any_tet.float().reshape(())
    xp = charge_rows(x, tca, pool)
    cct = xp + _agg(xp, sadj, dt).to(dt)
    tet = _tet_fwd(xp, tet_bin, anyt, dt)
    xct = torch.cat([bin_mp._pad_rows(p, Dp) for p in (xp, cct, tet)])
    pre = (iw.kbT.float() @ xct.float()).to(dt) + iw.b[:, None]
    return pre[:D].contiguous(), xct


def inject_bwd_plain(x, tca, pool, tet_bin, any_tet, sadj, iw: InjectWeights, xct, dpre):
    """Plain version of the inject backward kernel: from the layer input x,
    the forward's xct and ``dpre`` (Dp, A), the cotangent of ``pre`` rounded
    to the compute dtype, return dx (D, A) in the compute dtype."""
    dt = iw.dtype
    D, Dp = x.shape[0], iw.sw.Dp
    anyt = any_tet.float().reshape(())
    _, _, saved = _charge_fwd(x, tca, pool)
    dX = iw.kbT.float().T @ dpre.float()  # (3Dp, A): x', cct, tet parts
    dxp, dcct, dtet = dX[:D], dX[Dp : Dp + D], dX[2 * Dp : 2 * Dp + D]
    dxp32 = dxp + dcct + _agg_t(dcct, sadj, dt)
    dxp32 = dxp32 + _tet_bwd(xct[:D], tet_bin, anyt, dtet)
    return _charge_bwd(x, saved, dxp32).to(dt)


# ---- CUDA wrappers ---------------------------------------------------------- #


def _lib() -> ctypes.CDLL:
    return type_lib(cuda_build.load("inject"))


def type_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the inject library's entry
    points (once)."""
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.inject_fwd.argtypes = [vp] * 10 + [i] * 8 + [vp]
        lib.inject_fwd.restype = i
        lib.inject_bwd.argtypes = [vp] * 13 + [i] * 8 + [vp]
        lib.inject_bwd.restype = i
        lib.inject_bwd_tiles.argtypes = [vp] * 11 + [i] * 7 + [vp]
        lib.inject_bwd_tiles.restype = i
        lib.inject_bwd_tiles_smem_bytes.argtypes = [i] * 4
        lib.inject_bwd_tiles_smem_bytes.restype = ctypes.c_longlong
        lib.inject_fwd_tiles.argtypes = [vp] * 10 + [i] * 7 + [vp]
        lib.inject_fwd_tiles.restype = i
        lib.inject_fwd_tiles_smem_bytes.argtypes = [i] * 4
        lib.inject_fwd_tiles_smem_bytes.restype = ctypes.c_longlong
        lib.inject_smem_bytes.argtypes = [i] * 5
        lib.inject_smem_bytes.restype = ctypes.c_longlong
        lib.inject_error_string.argtypes = [i]
        lib.inject_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(what, x, tca, pool, tet_bin, any_tet, sadj, iw: InjectWeights):
    dt = iw.dtype
    if x.dtype != dt or dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: input {x.dtype}, weights {dt}")
    if (tca.dtype, pool.dtype, tet_bin.dtype, any_tet.dtype, sadj.dtype) != (
            torch.float32, torch.int8, torch.int32, torch.float32, torch.int8):
        raise TypeError(f"{what}: need tca fp32, pool_mat int8, tet_bin int32, any_tet fp32, "
                        "stereo_adj int8")
    D, A = x.shape
    nb, ab, _ = sadj.shape
    if (D != iw.sw.D or D < 2 or ab % 64 or A != nb * ab or tca.numel() != A
            or pool.shape[0] != nb or pool.shape[2] != ab or tet_bin.shape[:2] != (nb, 4)
            or any_tet.numel() != 1):
        raise ValueError(f"{what}: x {tuple(x.shape)}, stereo_adj {tuple(sadj.shape)}, "
                         f"pool_mat {tuple(pool.shape)}, tet_bin {tuple(tet_bin.shape)}: need "
                         "A = nb*ab, ab a multiple of 64, 2 <= D matching the weights")
    cuda_build.check_cuda(what, x.device, ("x", x, 16), ("tca", tca, 4), ("pool_mat", pool, 4),
                          ("tet_bin", tet_bin, 4), ("any_tet", any_tet, 4),
                          ("stereo_adj", sadj, 16), ("proj", iw.flat, 32),
                          ("proj_t", iw.flat_t, 32))
    lib = _lib()
    mb, tc = pool.shape[1], tet_bin.shape[2]
    if lib.inject_smem_bytes(int(dt == torch.bfloat16), iw.sw.Dp, mb, ab, tc) > cuda_build.SMEM_LIMIT:
        raise ValueError(f"{what}: ab={ab}, mb={mb}, Tc={tc} exceed one block's shared memory")
    return lib, nb, mb, ab, tc


def inject_fwd(x, tca, pool, tet_bin, any_tet, sadj, iw: InjectWeights, keep_xct: bool = True):
    """Launch the inject kernel: (pre (D, A), xct (3Dp, A)), as
    :func:`inject_fwd_plain`: in bf16 the tiled kernel (one block per
    64-atom tile, x', cct and tet on chip), in fp32 and past its shapes the
    kernel of one block per bin, chosen by shape.  ``keep_xct`` False (a
    caller that saves nothing for a backward) lets the tiled kernel skip
    writing xct, which is then None."""
    what = "inject_fwd"
    lib, nb, mb, ab, tc = _check(what, x, tca, pool, tet_bin, any_tet, sadj, iw)
    D, A = x.shape
    Dp, dev = iw.sw.Dp, x.device
    pre = torch.empty(D, A, dtype=x.dtype, device=dev)
    tiled = _takes_fwd_tiles(lib, int(x.dtype == torch.bfloat16), Dp, mb, ab, tc)
    xct = torch.empty(3 * Dp, A, dtype=x.dtype, device=dev) if keep_xct or not tiled else None
    if nb:
        args = (x.data_ptr(), tca.data_ptr(), pool.data_ptr(), tet_bin.data_ptr(),
                any_tet.data_ptr(), sadj.data_ptr())
        if tiled:
            status = lib.inject_fwd_tiles(
                *args, kbT_stream(iw).data_ptr(), iw.b.data_ptr(), pre.data_ptr(),
                xct.data_ptr() if xct is not None else None, D, Dp, A, nb, mb, ab, tc,
                bin_mp._stream(dev))
        else:
            ch = torch.empty(nb * 4 * tc * Dp, dtype=torch.float32, device=dev)
            status = lib.inject_fwd(*args, iw.flat.data_ptr(), pre.data_ptr(), xct.data_ptr(),
                                    ch.data_ptr(), int(x.dtype == torch.bfloat16), D, Dp, A, nb,
                                    mb, ab, tc, bin_mp._stream(dev))
        if status != 0:
            raise RuntimeError(f"{what}: {lib.inject_error_string(status).decode()}")
        inject_fwd.launches += 1
    return pre, xct


inject_fwd.launches = 0


_KBT_INDEX: Dict[Tuple, torch.Tensor] = {}


def kbT_stream(iw: InjectWeights) -> torch.Tensor:
    """kb^T (Dp, 3Dp) as the tiled forward's weight ring reads it: the
    walk's fragment order (``bin_mp.frag_stream``, K = 3Dp padded to a
    multiple of 32 with zeros); one gather by an index cached per shape and
    device."""
    Dp, dev = iw.sw.Dp, iw.kbT.device
    idx = _KBT_INDEX.get((Dp, dev))
    if idx is None:
        n = 3 * Dp * Dp
        idx = _KBT_INDEX[(Dp, dev)] = torch.from_numpy(
            bin_mp.frag_stream(np.arange(n).reshape(Dp, 3 * Dp), n)).to(dev)
    return torch.cat([iw.kbT.reshape(-1), iw.kbT.new_zeros(1)])[idx]


_FWD_TILES: Dict[Tuple, bool] = {}  # (bf16, Dp, mb, ab, Tc) -> the tiled forward takes it


def _takes_fwd_tiles(lib, bf16: int, Dp: int, mb: int, ab: int, tc: int) -> bool:
    """Whether the tiled bf16 forward takes the shape (else the kernel of
    one block per bin runs it); asked of the library once per shape."""
    key = (bf16, Dp, mb, ab, tc)
    if key not in _FWD_TILES:
        _FWD_TILES[key] = bool(bf16) and lib.inject_fwd_tiles_smem_bytes(Dp, mb, ab, tc) >= 0
    return _FWD_TILES[key]


_KB_INDEX: Dict[Tuple, torch.Tensor] = {}


def kb_stream(iw: InjectWeights) -> torch.Tensor:
    """kb (3Dp, Dp) as the tiled backward's weight ring reads it: its x',
    cct and tet parts (Dp, Dp) one after another, each in the walk's
    fragment order (``bin_mp.frag_stream``); one gather by an index cached
    per shape and device."""
    Dp, dev = iw.sw.Dp, iw.kbT.device
    idx = _KB_INDEX.get((Dp, dev))
    if idx is None:
        n = 3 * Dp * Dp
        rows = np.arange(n).reshape(3 * Dp, Dp)
        idx = _KB_INDEX[(Dp, dev)] = torch.from_numpy(np.concatenate(
            [bin_mp.frag_stream(rows[j * Dp : (j + 1) * Dp], n) for j in range(3)])).to(dev)
    kb = iw.kbT.T.contiguous().reshape(-1)
    return torch.cat([kb, kb.new_zeros(1)])[idx]


_BWD_TILES: Dict[Tuple, bool] = {}  # (bf16, Dp, mb, ab, Tc) -> the tiled backward takes it


def _takes_tiles(lib, bf16: int, Dp: int, mb: int, ab: int, tc: int) -> bool:
    """Whether the tiled bf16 backward takes the shape (else the kernel of
    one block per bin runs it); asked of the library once per shape."""
    key = (bf16, Dp, mb, ab, tc)
    if key not in _BWD_TILES:
        _BWD_TILES[key] = bool(bf16) and lib.inject_bwd_tiles_smem_bytes(Dp, mb, ab, tc) >= 0
    return _BWD_TILES[key]


def inject_bwd(x, tca, pool, tet_bin, any_tet, sadj, iw: InjectWeights, xct, dpre):
    """Launch the inject backward kernel: dx (D, A), as
    :func:`inject_bwd_plain`."""
    what = "inject_bwd"
    lib, nb, mb, ab, tc = _check(what, x, tca, pool, tet_bin, any_tet, sadj, iw)
    D, A = x.shape
    Dp, dev, dt = iw.sw.Dp, x.device, x.dtype
    if xct.shape != (3 * Dp, A) or dpre.shape != (Dp, A) or xct.dtype != dt or dpre.dtype != dt:
        raise ValueError(f"{what}: xct {tuple(xct.shape)}, dpre {tuple(dpre.shape)}")
    cuda_build.check_cuda(what, dev, ("xct", xct, 16), ("dpre", dpre, 16))
    dx = torch.empty(D, A, dtype=dt, device=dev)
    ch = torch.empty(nb * 4 * tc * Dp, dtype=torch.float32, device=dev)
    if not nb:
        return dx
    args = (x.data_ptr(), tca.data_ptr(), pool.data_ptr(), tet_bin.data_ptr(), any_tet.data_ptr(),
            sadj.data_ptr())
    if _takes_tiles(lib, int(dt == torch.bfloat16), Dp, mb, ab, tc):
        status = lib.inject_bwd_tiles(*args, kb_stream(iw).data_ptr(), xct.data_ptr(),
                                      dpre.data_ptr(), ch.data_ptr(), dx.data_ptr(), D, Dp, A, nb,
                                      mb, ab, tc, bin_mp._stream(dev))
    else:
        w32 = torch.empty(3 * Dp, A, dtype=torch.float32, device=dev)
        dcct = torch.empty(Dp, A, dtype=dt, device=dev)
        status = lib.inject_bwd(*args, iw.flat_t.data_ptr(), xct.data_ptr(), dpre.data_ptr(),
                                w32.data_ptr(), dcct.data_ptr(), ch.data_ptr(), dx.data_ptr(),
                                int(dt == torch.bfloat16), D, Dp, A, nb, mb, ab, tc,
                                bin_mp._stream(dev))
    if status != 0:
        raise RuntimeError(f"{what}: {lib.inject_error_string(status).decode()}")
    inject_bwd.launches += 1
    return dx


inject_bwd.launches = 0


# ---- the whole round: inject + layer, forward and backward ------------------ #


def inject_layer_fwd(x, tca, pool, tet_bin, any_tet, sadj, adj, iw: InjectWeights,
                     spec: bin_mp.StackSpec, train: bool):
    """Kernel 4 forward: (out = layer(pre) + pre, (pre, xct) for the
    backward).  ``train`` takes the layer's training form (dropout per
    ``spec``); serving takes its serving form."""
    if x.device.type == "cuda":
        pre, xct = inject_fwd(x, tca, pool, tet_bin, any_tet, sadj, iw, keep_xct=train)
        if train:
            out = bin_mp.mp_layer_fwd_train(pre, adj, iw.sw, spec)
        else:
            out = bin_mp.mp_layer_fwd(pre, adj, iw.sw, spec.act)
    elif x.device.type == "cpu":
        pre, xct = inject_fwd_plain(x, tca, pool, tet_bin, any_tet, sadj, iw)
        out = bin_mp.mp_stack_train_plain(pre, adj, iw.sw, spec)[0]
    else:
        raise ValueError(f"inject_layer_fwd: unsupported device {x.device}")
    return out, (pre, xct)


def inject_layer_bwd(x, tca, pool, tet_bin, any_tet, sadj, adj, iw: InjectWeights,
                     spec: bin_mp.StackSpec, saved, g):
    """Kernel 4 backward from the cotangent ``g`` of the output: (dx in the
    compute dtype, dkbT (Dp, 3Dp) fp32, db (Dp,) fp32, the layer's grads in
    the prepped orientation)."""
    pre, xct = saved
    g = g.to(iw.dtype).contiguous()
    if x.device.type == "cuda":
        dpre = []

        def inject_product(g32):  # d_kb, d_b: in the layer's one contraction launch
            dpre.append(g32.to(iw.dtype))
            return [(dpre[0], xct, g32)]

        g32, lg = bin_mp.mp_layer_bwd(pre, adj, iw.sw, spec, g, extra=inject_product)
        lg, (dkbT, db) = lg[:-2], lg[-2:]
        dx = inject_bwd(x, tca, pool, tet_bin, any_tet, sadj, iw, xct, dpre[0])
    else:
        g32, lg = bin_mp.mp_layer_bwd_plain(pre, adj, iw.sw, spec, g)
        dpre = g32.to(iw.dtype)
        dx = inject_bwd_plain(x, tca, pool, tet_bin, any_tet, sadj, iw, xct, dpre)
        dkbT, db = dpre.float() @ xct.float().T, g32.sum(1)
    return dx, dkbT, db, lg


class _InjectTrainFn(torch.autograd.Function):
    """Kernel 4 with the fp32 masters (kb, b, the layer's weights) as
    differentiable inputs, prepped once per call."""

    @staticmethod
    def forward(ctx, x, tca, pool, tet_bin, any_tet, sadj, adj, spec, dt, kb, b, *lws):
        with torch.no_grad():
            iw = prep_inject(kb, b, lws, dt)
        out, saved = inject_layer_fwd(x, tca, pool, tet_bin, any_tet, sadj, adj, iw, spec, True)
        ctx.save_for_backward(x, tca, pool, tet_bin, any_tet, sadj, adj, *saved)
        ctx.iw, ctx.spec = iw, spec
        return out

    @staticmethod
    def backward(ctx, g):
        x, tca, pool, tet_bin, any_tet, sadj, adj, pre, xct = ctx.saved_tensors
        iw = ctx.iw
        dx, dkbT, db, lg = inject_layer_bwd(x, tca, pool, tet_bin, any_tet, sadj, adj, iw,
                                            ctx.spec, (pre, xct), g)
        D, Dp = iw.sw.D, iw.sw.Dp
        dkb = torch.cat([dkbT[:D, i * Dp : i * Dp + D].T for i in range(3)]).contiguous()
        grads = bin_mp.unprep_layer_grads(iw.sw, lg)
        return (dx, None, None, None, None, None, None, None, None, dkb, db[:D].contiguous(),
                *grads)


def binned_inject_mp_layer_t(x, tca, pool, tet_bin, any_tet, sadj, adj, iw: InjectWeights,
                             act: str = "silu") -> torch.Tensor:
    """Serving form of one config-3 round: x (D, A) in the compute dtype,
    ``tca`` the (A,) fp32 per-atom total charge (0 on padding), ``any_tet``
    a 1-element fp32 tensor (1 when the batch has any tetrahedral centre)
    -> the next x (D, A)."""
    return inject_layer_fwd(x, tca, pool, tet_bin, any_tet, sadj, adj, iw,
                            bin_mp.StackSpec(act.lower()), False)[0]


def binned_inject_mp_layer_train_t(x, tca, pool, tet_bin, any_tet, sadj, adj, kb, b,
                                   layer_ws: Sequence[torch.Tensor], dtype: torch.dtype,
                                   act: str = "silu", dropout: float = 0.0,
                                   seed: int = 0) -> torch.Tensor:
    """Differentiable config-3 round for training (the JAX
    ``binned_inject_mp_layer_t`` in a train step): ``kb`` (3D, D) and ``b``
    (D,) the shared stereo projection, ``layer_ws`` the layer's fp32 masters,
    ``seed`` the layer's own dropout seed (``bin_mp.layer_drop_seed``)."""
    spec = bin_mp.StackSpec(act.lower(), float(dropout), int(seed) & 0xFFFFFFFF, 1)
    return _InjectTrainFn.apply(x.to(dtype).contiguous(), tca, pool, tet_bin, any_tet, sadj, adj,
                                spec, dtype, kb, b, *layer_ws)
