"""Fused attention pooling with the x_self projection folded in, forward and
backward (counterpart of aimnet_x2d_tpu/ops/bin_attnpool.py::
binned_attnpool_proj_t, kernel 3).

Per bin, feature-major (atoms on columns):

    x_self = act(kb^T emb + bb)                    (Ds rows)
    s      = sb + ks^T x_self + ko^T x_other       (H, ab) fp32
    attn   = per-molecule masked softmax of s      (-1e30 mask, 1e-16 floor)
    w      = mean over heads of attn
    pooled_self  = (x_self  * w) @ pm^T            (Ds, mb) fp32
    pooled_other = (x_other * w) @ pm^T            (Do, mb) fp32
    coverage     = w @ pm^T                        (mb,)    fp32

with the JAX cast points: fp32 accumulation -> compute-dtype cast -> bias
add in the compute dtype -> activation; the score weights rounded to the
compute dtype and the score bias kept in fp32; pool products rounded to the
compute dtype and summed in fp32.  The backward reads the forward's
attention weights instead of recomputing the softmax, recomputes x_self,
and returns demb, dx_other and the fp32 grads of kb, bb, ks, ko and sb.
The temperature and concat_self_other folds stay outside, in plain
autograd (models/pooling.py), as in the JAX package.

On CUDA tensors :func:`binned_attnpool_proj_t` launches the hand-written
kernels (``csrc/attnpool.cu``); on CPU tensors it runs the plain versions
here.  The kernels take any (nb, mb) with ab a multiple of 64 and never
fall back; they assume what the loaders build: each atom belongs to at
most one molecule of its bin (one 1 per column of ``pool_mat``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from ..utils.activation import ACTIVATION_CODES, activation_grad, get_activation_function
from . import bin_mp, cuda_build


@dataclasses.dataclass
class AttnPoolWeights:
    """The op's weights in the kernels' form: ``kbT`` (Dsp, E) and ``bb``
    (Dsp,) in the compute dtype, Ds padded to Dsp (a multiple of 16) with
    zero rows; ``ks`` (Ds, H) and ``ko`` (Do, H) rounded to the compute
    dtype; ``sb`` (H,) fp32.  ``flat``/``flat_t`` hold [kbT, bb] and kb
    (E, Dsp) for the kernels (tile-major in bf16), ``score`` holds
    [ks, ko, sb] as fp32 values."""

    kbT: torch.Tensor
    bb: torch.Tensor
    ks: torch.Tensor
    ko: torch.Tensor
    sb: torch.Tensor
    flat: torch.Tensor
    flat_t: torch.Tensor
    score: torch.Tensor
    Ds: int

    @property
    def dtype(self) -> torch.dtype:
        return self.kbT.dtype


def prep_weights(kb, bb, ks, ko, sb, dt: torch.dtype) -> AttnPoolWeights:
    pw = bin_mp.prep_proj(kb, bb, dt, bin_mp.padded_dim(kb.shape[1]))
    ksd, kod = ks.to(dt), ko.to(dt)
    score = torch.cat([ksd.float().reshape(-1), kod.float().reshape(-1), sb.float()]).contiguous()
    return AttnPoolWeights(pw.kbT, pw.bb, ksd, kod, sb.float(), pw.flat, pw.flat_t, score,
                           kb.shape[1])


def check_one_owner(pm: torch.Tensor) -> None:
    """Raise unless ``pm`` (nb, mb, ab) holds only 0 and 1 and puts each
    atom in at most one molecule of its bin: the kernels read the first
    molecule that holds an atom and nothing else."""
    if bool(((pm != 0) & (pm != 1)).any()) or bool((pm.sum(dim=1, dtype=torch.int32) > 1).any()):
        raise ValueError("pool_mat must hold 0/1 and give each atom at most one molecule")


def _softmax_plain(s: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's ``_softmax_bin`` over every bin: s (H, A) fp32."""
    nb, mb, ab = pm.shape
    H = s.shape[0]
    pmf = pm.float()
    sb = s.reshape(H, nb, ab)
    cover = pmf.sum(dim=1) > 0  # (nb, ab)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=s.device)
    smax = torch.where(pm[None] > 0, sb[:, :, None, :], neg).amax(dim=3)  # (H, nb, mb)
    satom = torch.einsum("hbm,bma->hba", smax, pmf)
    e = torch.where(cover[None], torch.exp(sb - satom), torch.zeros((), device=s.device))
    denom = torch.einsum("hba,bma->hbm", e, pmf)
    denom_atom = torch.einsum("hbm,bma->hba", denom, pmf)
    return (e / denom_atom.clamp(min=1e-16)).reshape(H, nb * ab)


def _pool(xT: torch.Tensor, w: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
    nb, mb, ab = pm.shape
    xw = (xT * w.to(xT.dtype)[None, :]).float()
    return torch.einsum("dba,bma->dbm", xw.reshape(xT.shape[0], nb, ab), pm.float()).reshape(
        xT.shape[0], nb * mb)


def _to_atoms(gT: torch.Tensor, pm: torch.Tensor) -> torch.Tensor:
    """(rows, nb*mb) per-molecule values -> (rows, A): each atom takes its
    molecule's value (0 for atoms of no molecule)."""
    nb, mb, ab = pm.shape
    out = torch.einsum("dbm,bma->dba", gT.reshape(gT.shape[0], nb, mb), pm.float())
    return out.reshape(gT.shape[0], nb * ab)


def attnpool_fwd_plain(emb, xo, pm, w: AttnPoolWeights, act: str):
    """Plain PyTorch version of the forward: returns (pooled_self (Ds, B),
    pooled_other (Do, B), coverage (B,), attn (H, A)), all fp32."""
    dt = w.dtype
    fn = get_activation_function(act)
    v = fn(bin_mp._dot(w.kbT, emb, dt) + w.bb[:, None])[: w.Ds]
    s = w.sb[:, None] + w.ks.float().T @ v.float() + w.ko.float().T @ xo.float()
    attn = _softmax_plain(s, pm)
    wbar = attn.mean(dim=0)
    nb, mb, ab = pm.shape
    cov = torch.einsum("ba,bma->bm", wbar.reshape(nb, ab), pm.float()).reshape(-1)
    return _pool(v, wbar, pm), _pool(xo, wbar, pm), cov, attn


def attnpool_bwd_plain(emb, xo, pm, w: AttnPoolWeights, act: str, attn, gps, gpo, gcov):
    """Plain PyTorch version of the backward (the JAX ``bwd_kernel``):
    returns (demb, dx_other) in the compute dtype and the fp32 grads
    (dkbT (Dsp, E), dbb (Dsp,), dks (Ds, H), dko (Do, H), dsb (H,))."""
    dt = w.dtype
    H = attn.shape[0]
    nb, mb, ab = pm.shape
    t = bin_mp._dot(w.kbT, emb, dt) + w.bb[:, None]
    v = get_activation_function(act)(t)
    Ds = w.Ds
    gs = _to_atoms(gps.to(dt).float(), pm)  # (Ds, A)
    go = _to_atoms(gpo.to(dt).float(), pm)
    wbar = attn.mean(dim=0)
    dv = gs * wbar
    dxo = go * wbar
    dwbar = ((gs * v[:Ds].float()).sum(0) + (go * xo.float()).sum(0)
             + _to_atoms(gcov.reshape(1, -1).float(), pm)[0])
    dattn = dwbar / H
    pmf = pm.float()
    t_mol = torch.einsum("hba,bma->hbm", (attn * dattn).reshape(H, nb, ab), pmf)
    t_atom = torch.einsum("hbm,bma->hba", t_mol, pmf).reshape(H, -1)
    dsc = (attn * dattn - attn * t_atom).to(dt).float()
    dv = dv + w.ks.float() @ dsc
    dxo = (dxo + w.ko.float() @ dsc).to(dt)
    dks = v[:Ds].float() @ dsc.T
    dko = xo.float() @ dsc.T
    dsb = dsc.sum(1)
    dv = torch.cat([dv, dv.new_zeros(w.kbT.shape[0] - Ds, dv.shape[1])])
    dt32 = dv * activation_grad(act, t).float()
    dtc = dt32.to(dt)
    dkbT = dtc.float() @ emb.float().T
    demb = (w.kbT.float().T @ dtc.float()).to(dt)
    return demb, dxo, (dkbT, dt32.sum(1), dks, dko, dsb)


# ---- CUDA wrappers -------------------------------------------------------- #


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("attnpool")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.attnpool_fwd.argtypes = [vp] * 10 + [i] * 10 + [vp]
        lib.attnpool_fwd.restype = i
        lib.attnpool_bwd.argtypes = [vp] * 14 + [i] * 10 + [vp]
        lib.attnpool_bwd.restype = i
        lib.attnpool_smem_bytes.argtypes = [i, i, i, i]
        lib.attnpool_smem_bytes.restype = ctypes.c_longlong
        lib.attnpool_error_string.argtypes = [i]
        lib.attnpool_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(what, emb, xo, pm, w: AttnPoolWeights, act):
    if emb.dtype != w.dtype or xo.dtype != w.dtype or w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: emb {emb.dtype}, x_other {xo.dtype}, weights {w.dtype}")
    if pm.dtype != torch.int8:
        raise TypeError(f"{what}: pool_mat must be int8")
    if act.lower() not in ACTIVATION_CODES:
        raise ValueError(f"{what}: unsupported activation {act!r}")
    nb, mb, ab = pm.shape
    E, A = emb.shape
    if ab % 64 or A != nb * ab or xo.shape[1] != A or E != w.kbT.shape[1] or E % 16:
        raise ValueError(f"{what}: emb {tuple(emb.shape)}, x_other {tuple(xo.shape)}, pool_mat "
                         f"{tuple(pm.shape)}: need A = nb*ab, ab a multiple of 64, E a multiple of 16")
    cuda_build.check_cuda(what, emb.device, ("emb", emb, 16), ("x_other", xo, 16), ("pool_mat", pm, 1),
                          ("weights", w.flat, 32), ("weights_t", w.flat_t, 32), ("score", w.score, 4))
    lib = _lib()
    H = w.sb.shape[0]
    bf16 = int(w.dtype == torch.bfloat16)
    if lib.attnpool_smem_bytes(w.kbT.shape[0], H, mb, ab) > cuda_build.SMEM_LIMIT:
        raise ValueError(f"{what}: mb={mb}, ab={ab} exceed one block's shared memory")
    return lib, nb, mb, ab, E, A, H, bf16


def attnpool_fwd(emb, xo, pm, w: AttnPoolWeights, act: str):
    """Launch the forward kernel (one block per bin).  Same returns as
    :func:`attnpool_fwd_plain`."""
    lib, nb, mb, ab, E, A, H, bf16 = _check("attnpool_fwd", emb, xo, pm, w, act)
    dev = emb.device
    Dsp, Do = w.kbT.shape[0], xo.shape[0]
    ps = torch.empty(w.Ds, nb * mb, dtype=torch.float32, device=dev)
    po = torch.empty(Do, nb * mb, dtype=torch.float32, device=dev)
    cov = torch.empty(nb * mb, dtype=torch.float32, device=dev)
    attn = torch.empty(H, A, dtype=torch.float32, device=dev)
    vbuf = torch.empty(Dsp, A, dtype=w.dtype, device=dev)
    if nb:
        status = lib.attnpool_fwd(
            emb.data_ptr(), xo.data_ptr(), pm.data_ptr(), w.flat.data_ptr(), w.score.data_ptr(),
            vbuf.data_ptr(), ps.data_ptr(), po.data_ptr(), cov.data_ptr(), attn.data_ptr(),
            bf16, w.Ds, Dsp, Do, E, H, nb, mb, ab, ACTIVATION_CODES[act.lower()],
            bin_mp._stream(dev),
        )
        if status != 0:
            raise RuntimeError(f"attnpool_fwd: {lib.attnpool_error_string(status).decode()}")
        attnpool_fwd.launches += 1
    return ps, po, cov, attn


attnpool_fwd.launches = 0


def attnpool_bwd(emb, xo, pm, w: AttnPoolWeights, act: str, attn, gps, gpo, gcov):
    """Launch the backward kernel (one block per bin) and the
    weight-gradient contractions.  Same returns as :func:`attnpool_bwd_plain`."""
    lib, nb, mb, ab, E, A, H, bf16 = _check("attnpool_bwd", emb, xo, pm, w, act)
    dev = emb.device
    gps, gpo, gcov = gps.float().contiguous(), gpo.float().contiguous(), gcov.float().contiguous()
    attn = attn.contiguous()
    cuda_build.check_cuda("attnpool_bwd", dev, ("attn", attn, 4), ("g_self", gps, 4),
                          ("g_other", gpo, 4), ("g_cov", gcov, 4))
    Dsp, Do, Ds = w.kbT.shape[0], xo.shape[0], w.Ds
    work = torch.empty(3, Dsp, A, dtype=w.dtype, device=dev)  # t, x_self, dt
    demb = torch.empty(E, A, dtype=w.dtype, device=dev)
    dxo = torch.empty(Do, A, dtype=w.dtype, device=dev)
    # per-bin fp32 partials: dbb (Dsp), dks (Ds*H), dko (Do*H), dsb (H)
    psize = Dsp + Ds * H + Do * H + H
    part = torch.empty(nb, psize, dtype=torch.float32, device=dev)
    status = lib.attnpool_bwd(
        emb.data_ptr(), xo.data_ptr(), pm.data_ptr(), w.flat.data_ptr(), w.flat_t.data_ptr(),
        w.score.data_ptr(), attn.data_ptr(), gps.data_ptr(), gpo.data_ptr(), gcov.data_ptr(),
        work.data_ptr(), part.data_ptr(), demb.data_ptr(), dxo.data_ptr(), bf16, Ds, Dsp, Do, E, H, nb, mb, ab, ACTIVATION_CODES[act.lower()], bin_mp._stream(dev),
    )
    if status != 0:
        raise RuntimeError(f"attnpool_bwd: {lib.attnpool_error_string(status).decode()}")
    red = bin_mp.sum_partials(part)
    dbb = red[:Dsp]
    dks = red[Dsp : Dsp + Ds * H].view(Ds, H)
    dko = red[Dsp + Ds * H : Dsp + Ds * H + Do * H].view(Do, H)
    dsb = red[Dsp + Ds * H + Do * H :]
    dkbT, _ = bin_mp.wgrad(work[2], emb)
    attnpool_bwd.launches += 1
    return demb, dxo, (dkbT, dbb, dks, dko, dsb)


attnpool_bwd.launches = 0


class _AttnPoolFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, xo, pm, act, kb, bb, ks, ko, sb):
        with torch.no_grad():
            w = prep_weights(kb, bb, ks, ko, sb, emb.dtype)
        if emb.device.type == "cuda":
            ps, po, cov, attn = attnpool_fwd(emb, xo, pm, w, act)
        elif emb.device.type == "cpu":
            check_one_owner(pm)  # free here; on the card it would cost a sync per step
            ps, po, cov, attn = attnpool_fwd_plain(emb, xo, pm, w, act)
        else:
            raise ValueError(f"binned_attnpool_proj_t: unsupported device {emb.device}")
        ctx.save_for_backward(emb, xo, pm, attn)
        ctx.w, ctx.act = w, act
        ctx.mark_non_differentiable(attn)
        return ps, po, cov, attn

    @staticmethod
    def backward(ctx, gps, gpo, gcov, _gattn):
        emb, xo, pm, attn = ctx.saved_tensors
        w = ctx.w
        zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=emb.device)  # noqa: E731
        gps = gps if gps is not None else zeros((w.Ds, pm.shape[0] * pm.shape[1]))
        gpo = gpo if gpo is not None else zeros((xo.shape[0], pm.shape[0] * pm.shape[1]))
        gcov = gcov if gcov is not None else zeros(pm.shape[0] * pm.shape[1])
        bwd = attnpool_bwd if emb.device.type == "cuda" else attnpool_bwd_plain
        demb, dxo, (dkbT, dbb, dks, dko, dsb) = bwd(emb, xo, pm, w, ctx.act, attn, gps, gpo, gcov)
        Ds = w.Ds
        return (demb, dxo, None, None, dkbT[:Ds].T.contiguous(), dbb[:Ds].contiguous(),
                dks, dko, dsb)


def binned_attnpool_proj_t(
    embT: torch.Tensor,
    k_blk: torch.Tensor,
    b_blk: torch.Tensor,
    act_name: str,
    xoT: torch.Tensor,
    pool_mat: torch.Tensor,
    score_k_self: torch.Tensor,
    score_k_other: torch.Tensor,
    score_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused projection -> scores -> softmax -> pools, differentiable.
    embT (E, A) in the compute dtype; k_blk (E, Ds) / b_blk (Ds,) fp32, the
    x_self block of embedding_projection; xoT (Do, A) post-MP x_other;
    pool_mat (nb, mb, ab) int8, 0/1 with at most one molecule per atom (as
    the loaders build it; :func:`check_one_owner`, which the CPU path runs and
    the kernels do not); score_k_self (Ds, H) / score_k_other (Do, H) /
    score_b (H,) fp32 with the concat and temperature folds applied.
    Returns (pooled_self (Ds, B), pooled_other (Do, B), coverage (B,),
    attn (H, A)), all fp32, B = nb*mb; attn carries no gradient."""
    dt = embT.dtype
    return _AttnPoolFn.apply(embT.contiguous(), xoT.to(dt).contiguous(), pool_mat.contiguous(),
                             act_name.lower(), k_blk, b_blk, score_k_self, score_k_other, score_b)
