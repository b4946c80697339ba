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

With the embedding fold (``embed_spec``, :func:`embed_fold_enabled`; kernel
1c-vocab) the op takes the code rows (F, A) int32 and the fp32
block-diagonal table (E, sum of V) instead of emb: the kernels look up
emb = rnd(bd) one-hot per atom themselves, the backward saves the codes
instead of emb and returns the table's fp32 cotangent d_bd = rnd(kb dt)
one-hot^T (its diagonal blocks) instead of demb (``attnpool_fwd_vocab``,
``attnpool_bwd_vocab``).

On CUDA tensors :func:`binned_attnpool_proj_t` launches the hand-written
kernels (``csrc/attnpool.cu``: forward and backward in bf16 on a cluster of
64-atom tiles per bin with v, t and dt on chip, in fp32 and past their
shapes one block per bin, chosen by shape; d_kb from the grouped
contraction, ``bin_mp.wgrad_group``; in bf16 the tiled kernels' weight
stream, :func:`pool_stream`, is gathered once a step for both); on CPU
tensors it runs the plain versions here.
The kernels take any (nb, mb) with ab a multiple of 64 and never fall
back; they assume what the loaders build: each atom belongs to at most one
molecule of its bin (one 1 per column of ``pool_mat``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.activation import ACTIVATION_CODES, activation_grad, get_activation_function
from . import bin_mp, cuda_build
from .embed import VocabTable, embed_from_codes, expand_diag, prep_vocab, table_grad


def embed_fold_enabled() -> bool:
    """The JAX package's embedding-fold switch, read on each training
    forward: ``AIMNET_EMBED_FOLD`` set to ``1``, ``on`` or ``true`` folds
    the embedding lookup into the stack's and the attention pool's kernels
    where the JAX package folds it (models/gnn.py); default off."""
    return os.environ.get("AIMNET_EMBED_FOLD", "").lower() in ("1", "on", "true")


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


def attnpool_fwd_vocab_plain(codes, xo, pm, w: AttnPoolWeights, act: str, vt: VocabTable):
    """Plain PyTorch version of the folded forward: the forward on
    emb = :func:`embed_from_codes`; same returns."""
    return attnpool_fwd_plain(embed_from_codes(codes, vt), xo, pm, w, act)


def attnpool_bwd_vocab_plain(codes, xo, pm, w: AttnPoolWeights, act: str, attn, gps, gpo, gcov,
                             vt: VocabTable):
    """Plain PyTorch version of the folded backward: returns (d_bd (E, sum
    of V) fp32 on the diagonal blocks, dx_other, the fp32 weight grads as
    :func:`attnpool_bwd_plain`)."""
    demb, dxo, grads = attnpool_bwd_plain(embed_from_codes(codes, vt), xo, pm, w, act, attn,
                                          gps, gpo, gcov)
    return table_grad(demb, codes, vt), dxo, grads


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
        lib.attnpool_fwd_vocab.argtypes = [vp, vp, vp] + [i] + [vp] * 9 + [i] * 10 + [vp]
        lib.attnpool_fwd_vocab.restype = i
        lib.attnpool_bwd_vocab.argtypes = [vp, vp, vp] + [i] + [vp] * 12 + [i] * 10 + [vp]
        lib.attnpool_bwd_vocab.restype = i
        lib.attnpool_vocab_smem_bytes.argtypes = [i] * 7
        lib.attnpool_vocab_smem_bytes.restype = ctypes.c_longlong
        lib.attnpool_bwd_tiles.argtypes = [vp, vp, vp, vp, i] + [vp] * 13 + [i] * 9 + [vp]
        lib.attnpool_bwd_tiles.restype = i
        lib.attnpool_bwd_tiles_smem_bytes.argtypes = [i] * 8
        lib.attnpool_bwd_tiles_smem_bytes.restype = ctypes.c_longlong
        lib.attnpool_bwd_tiles_stream_elems.argtypes = [i, i]
        lib.attnpool_bwd_tiles_stream_elems.restype = ctypes.c_longlong
        lib.attnpool_fwd_tiles.argtypes = [vp, vp, vp, vp, i] + [vp] * 9 + [i] * 9 + [vp]
        lib.attnpool_fwd_tiles.restype = i
        lib.attnpool_fwd_tiles_smem_bytes.argtypes = [i] * 7
        lib.attnpool_fwd_tiles_smem_bytes.restype = ctypes.c_longlong
        lib.attnpool_error_string.argtypes = [i]
        lib.attnpool_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(what, emb, xo, pm, w: AttnPoolWeights, act, vt: Optional[VocabTable] = None,
           n_acc: int = 0):
    """Validate the operands; ``emb`` is the code rows (F, A) int32 when
    ``vt`` is given (the fold), whose d_bd partials take ``n_acc`` floats."""
    if vt is not None:
        if emb.dtype != torch.int32 or emb.shape[0] != len(vt.sizes) or vt.bd.dtype != w.dtype:
            raise TypeError(f"{what}: codes {emb.dtype} {tuple(emb.shape)}, table {vt.bd.dtype}, "
                            f"weights {w.dtype}")
    elif emb.dtype != w.dtype:
        raise TypeError(f"{what}: emb {emb.dtype}, weights {w.dtype}")
    if xo.dtype != w.dtype or w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x_other {xo.dtype}, weights {w.dtype}")
    if pm.dtype != torch.int8:
        raise TypeError(f"{what}: pool_mat must be int8")
    if act.lower() not in ACTIVATION_CODES:
        raise ValueError(f"{what}: unsupported activation {act!r}")
    nb, mb, ab = pm.shape
    A = emb.shape[1]
    E = vt.E if vt is not None else emb.shape[0]
    if ab % 64 or A != nb * ab or xo.shape[1] != A or E != w.kbT.shape[1] or E % 16:
        raise ValueError(f"{what}: emb {tuple(emb.shape)}, x_other {tuple(xo.shape)}, pool_mat "
                         f"{tuple(pm.shape)}: need A = nb*ab, ab a multiple of 64, E a multiple of 16")
    named = [("emb", emb, 16), ("x_other", xo, 16), ("pool_mat", pm, 1), ("weights", w.flat, 32),
             ("weights_t", w.flat_t, 32), ("score", w.score, 4)]
    if vt is not None:
        named.append(("table", vt.bd, 4))
    cuda_build.check_cuda(what, emb.device, *named)
    lib = _lib()
    H = w.sb.shape[0]
    bf16 = int(w.dtype == torch.bfloat16)
    Dsp = w.kbT.shape[0]
    smem = (lib.attnpool_smem_bytes(Dsp, H, mb, ab) if vt is None else
            lib.attnpool_vocab_smem_bytes(bf16, Dsp, H, mb, ab, E, n_acc))
    if smem > cuda_build.SMEM_LIMIT:
        raise ValueError(f"{what}: mb={mb}, ab={ab} exceed one block's shared memory")
    return lib, nb, mb, ab, E, A, H, bf16


def _launch_fwd(what, emb, xo, pm, w: AttnPoolWeights, act: str, vt: Optional[VocabTable],
                ws: Optional[torch.Tensor]):
    """The forward kernel on emb, or under the fold (``vt``) on the code
    rows: bf16 on the tiled kernel (a cluster of 64-atom tiles per bin, v on
    chip; ``ws`` the weight stream, :func:`pool_stream`, gathered here when
    not given), fp32 and shapes past it on the kernel of one block per bin,
    chosen by shape, each route counted in ``_launch_fwd.routes``.  Returns
    (ps, po, cov, attn) and whether it launched (nothing to do for nb = 0)."""
    lib, nb, mb, ab, E, A, H, bf16 = _check(what, emb, xo, pm, w, act, vt)
    dev = emb.device
    Dsp, Do, Ds = w.kbT.shape[0], xo.shape[0], w.Ds
    ps = torch.empty(Ds, nb * mb, dtype=torch.float32, device=dev)
    po = torch.empty(Do, nb * mb, dtype=torch.float32, device=dev)
    cov = torch.empty(nb * mb, dtype=torch.float32, device=dev)
    attn = torch.empty(H, A, dtype=torch.float32, device=dev)
    if not nb:
        return (ps, po, cov, attn), False
    outs = (ps.data_ptr(), po.data_ptr(), cov.data_ptr(), attn.data_ptr())
    dims = (Ds, Dsp, Do, E, H, nb, mb, ab, ACTIVATION_CODES[act.lower()], bin_mp._stream(dev))
    tiles = _takes_fwd_tiles(lib, bf16, Dsp, E, H, Ds, Do, mb, ab)
    if tiles:
        ws = _stream_arg(what, lib, w, ws)
        table = ((None, None, None, 0) if vt is None else
                 (emb.data_ptr(), vt.bd.data_ptr(), bin_mp._sizes_arg(vt), len(vt.sizes)))
        status = lib.attnpool_fwd_tiles(
            emb.data_ptr() if vt is None else None, *table, xo.data_ptr(), pm.data_ptr(),
            w.flat.data_ptr(), ws.data_ptr(), w.score.data_ptr(), *outs, *dims)
    else:
        vbuf = torch.empty(Dsp, A, dtype=w.dtype, device=dev)  # x_self, written and read back
        tail = (xo.data_ptr(), pm.data_ptr(), w.flat.data_ptr(), w.score.data_ptr(),
                vbuf.data_ptr(), *outs, bf16, *dims)
        if vt is None:
            status = lib.attnpool_fwd(emb.data_ptr(), *tail)
        else:
            status = lib.attnpool_fwd_vocab(emb.data_ptr(), vt.bd.data_ptr(),
                                            bin_mp._sizes_arg(vt), len(vt.sizes), *tail)
    if status != 0:
        raise RuntimeError(f"{what}: {lib.attnpool_error_string(status).decode()}")
    _launch_fwd.routes["tiles" if tiles else "bins"] += 1
    return (ps, po, cov, attn), True


_launch_fwd.routes = {"tiles": 0, "bins": 0}  # launches of the tiled kernel, of one block a bin


def attnpool_fwd(emb, xo, pm, w: AttnPoolWeights, act: str, ws: Optional[torch.Tensor] = None):
    """Launch the forward kernel (bf16: the tiled one, reading ``ws`` where
    the caller has gathered :func:`pool_stream`).  Same returns as
    :func:`attnpool_fwd_plain`."""
    out, launched = _launch_fwd("attnpool_fwd", emb, xo, pm, w, act, None, ws)
    attnpool_fwd.launches += int(launched)
    return out


attnpool_fwd.launches = 0


def attnpool_fwd_vocab(codes, xo, pm, w: AttnPoolWeights, act: str, vt: VocabTable,
                       ws: Optional[torch.Tensor] = None):
    """Launch the folded forward kernel (1c-vocab at the pool's site): the
    forward of :func:`attnpool_fwd` with each atom's embedding looked up
    from the code rows (F, A) int32 and the table.  Same returns."""
    out, launched = _launch_fwd("attnpool_fwd_vocab", codes, xo, pm, w, act, vt, ws)
    attnpool_fwd_vocab.launches += int(launched)
    return out


attnpool_fwd_vocab.launches = 0


_POOL_INDEX: Dict[Tuple, torch.Tensor] = {}


def pool_stream_index(Dsp: int, E: int) -> np.ndarray:
    """Positions in kb^T (Dsp, E) flattened of every element of the tiled
    backward's weight stream (``pos == Dsp * E`` marks a zero): kb^T in row
    blocks of at most 160 (the recompute, K = E), then kb = (kb^T)^T the same
    way (demb, K = Dsp), each block in the walk's fragment order
    (``bin_mp.frag_stream``, K padded to a multiple of 32) and each of its
    32-column stages padded to 160 rows' worth (``csrc/attnpool.cu``
    pool_stages)."""
    n = Dsp * E
    pos = np.arange(n).reshape(Dsp, E)
    parts = []
    for mat in (pos, pos.T):
        for r0 in range(0, mat.shape[0], 160):
            R = min(160, mat.shape[0] - r0)
            st = bin_mp.frag_stream(mat[r0 : r0 + R], n).reshape(-1, R * 32)
            parts.append(np.concatenate([st, np.full((st.shape[0], (160 - R) * 32), n)], 1))
    return np.concatenate(parts).reshape(-1)


def pool_stream(w: AttnPoolWeights) -> torch.Tensor:
    """kb^T and kb as the tiled kernels' weight ring reads them
    (:func:`pool_stream_index`; the forward reads kb^T's head); one gather by
    an index cached per shape and device."""
    Dsp, E = w.kbT.shape
    dev = w.kbT.device
    idx = _POOL_INDEX.get((Dsp, E, dev))
    if idx is None:
        idx = _POOL_INDEX[(Dsp, E, dev)] = torch.from_numpy(pool_stream_index(Dsp, E)).to(dev)
    return torch.cat([w.kbT.reshape(-1), w.kbT.new_zeros(1)])[idx]


_BWD_TILES: Dict[Tuple, bool] = {}  # (bf16, Dsp, E, H, Ds, Do, mb, ab, n_acc) -> tiles take it
_FWD_TILES: Dict[Tuple, bool] = {}  # (bf16, Dsp, E, H, Ds, Do, mb, ab) -> tiles take it


def _takes_fwd_tiles(lib, bf16: int, Dsp: int, E: int, H: int, Ds: int, Do: int, mb: int,
                     ab: int) -> bool:
    """Whether the tiled bf16 forward takes the shape (else the kernel of
    one block per bin runs it); asked of the library once per shape."""
    key = (bf16, Dsp, E, H, Ds, Do, mb, ab)
    if key not in _FWD_TILES:
        _FWD_TILES[key] = (bool(bf16)
                           and lib.attnpool_fwd_tiles_smem_bytes(Dsp, E, H, Ds, Do, mb, ab) >= 0)
    return _FWD_TILES[key]


def _stream_arg(what, lib, w: AttnPoolWeights, ws: Optional[torch.Tensor]) -> torch.Tensor:
    """``ws``, checked, or :func:`pool_stream` gathered where it is None."""
    if ws is None:
        return pool_stream(w)
    Dsp, E = w.kbT.shape
    if ws.dtype != w.dtype or ws.shape != (lib.attnpool_bwd_tiles_stream_elems(Dsp, E),):
        raise ValueError(f"{what}: the weight stream must be pool_stream(w)")
    cuda_build.check_cuda(what, w.kbT.device, ("weight stream", ws, 16))
    return ws


def _takes_tiles(lib, bf16: int, Dsp: int, E: int, H: int, Ds: int, Do: int, mb: int, ab: int,
                 n_acc: int) -> bool:
    """Whether the tiled bf16 backward takes the shape (else the kernel of
    one block per bin runs it); asked of the library once per shape."""
    key = (bf16, Dsp, E, H, Ds, Do, mb, ab, n_acc)
    if key not in _BWD_TILES:
        tiles = bool(bf16) and lib.attnpool_bwd_tiles_smem_bytes(
            Dsp, E, H, Ds, Do, mb, ab, n_acc) >= 0
        if tiles and lib.attnpool_bwd_tiles_stream_elems(Dsp, E) != pool_stream_index(Dsp, E).size:
            raise RuntimeError("attnpool_bwd: the tiled kernel's weight-stream length disagrees")
        _BWD_TILES[key] = tiles
    return _BWD_TILES[key]


def _step_stream(xo, pm, w: AttnPoolWeights, vt: Optional[VocabTable]) -> Optional[torch.Tensor]:
    """:func:`pool_stream` where a tiled kernel, forward or backward, takes
    the shape (bf16), else None: the one gather a training step makes."""
    if w.dtype != torch.bfloat16:
        return None
    lib = _lib()
    (Dsp, E), H, Ds, Do, (_, mb, ab) = w.kbT.shape, w.sb.shape[0], w.Ds, xo.shape[0], pm.shape
    n_acc = vt.Df * vt.offsets[-1] if vt is not None else 0
    if (_takes_fwd_tiles(lib, 1, Dsp, E, H, Ds, Do, mb, ab)
            or _takes_tiles(lib, 1, Dsp, E, H, Ds, Do, mb, ab, n_acc)):
        return pool_stream(w)
    return None


def _launch_bwd(what, emb, xo, pm, w: AttnPoolWeights, act: str, attn, gps, gpo, gcov,
                vt: Optional[VocabTable], ws: Optional[torch.Tensor]):
    """The backward kernel, the fixed-order sum of its per-bin partials and
    the d_kb contraction (``bin_mp.wgrad_group``: (dt, emb), or under the fold
    dt and the embeddings gathered from the code rows), on emb or under the
    fold on the code rows.  bf16 runs the tiled kernel (a cluster of 64-atom
    tiles per bin, t and dt on chip), fp32 and shapes past it the kernel of
    one block per bin, chosen by shape.  Returns (demb, or d_bd under the
    fold; dx_other; the fp32 weight grads).  ``ws`` as :func:`_launch_fwd`'s."""
    n_acc = vt.Df * vt.offsets[-1] if vt is not None else 0
    lib, nb, mb, ab, E, A, H, bf16 = _check(what, emb, xo, pm, w, act, vt, n_acc)
    dev = emb.device
    gps, gpo, gcov = gps.float().contiguous(), gpo.float().contiguous(), gcov.float().contiguous()
    attn = attn.contiguous()
    cuda_build.check_cuda(what, dev, ("attn", attn, 4), ("g_self", gps, 4),
                          ("g_other", gpo, 4), ("g_cov", gcov, 4))
    Dsp, Do, Ds = w.kbT.shape[0], xo.shape[0], w.Ds
    dxo = torch.empty(Do, A, dtype=w.dtype, device=dev)
    demb = torch.empty(E, A, dtype=w.dtype, device=dev) if vt is None else None
    # per-bin fp32 partials: dbb (Dsp), dks (Ds*H), dko (Do*H), dsb (H), then
    # under the fold the diagonal blocks of d_bd (n_acc)
    head = Dsp + Ds * H + Do * H + H
    part = torch.empty(nb, head + n_acc, dtype=torch.float32, device=dev)
    mid = (w.score.data_ptr(), attn.data_ptr(), gps.data_ptr(), gpo.data_ptr(), gcov.data_ptr())
    dims = (Ds, Dsp, Do, E, H, nb, mb, ab, ACTIVATION_CODES[act.lower()], bin_mp._stream(dev))
    demb_p = demb.data_ptr() if demb is not None else None
    if _takes_tiles(lib, bf16, Dsp, E, H, Ds, Do, mb, ab, n_acc):
        dtc = torch.empty(Dsp, A, dtype=w.dtype, device=dev)  # dt for the contraction
        table = ((None, None, None, 0) if vt is None else
                 (emb.data_ptr(), vt.bd.data_ptr(), bin_mp._sizes_arg(vt), len(vt.sizes)))
        status = lib.attnpool_bwd_tiles(
            emb.data_ptr() if vt is None else None, *table, xo.data_ptr(), pm.data_ptr(),
            w.flat.data_ptr(), _stream_arg(what, lib, w, ws).data_ptr(), *mid, dtc.data_ptr(),
            part.data_ptr(),
            demb_p, dxo.data_ptr(), *dims)
    else:
        work = torch.empty(3, Dsp, A, dtype=w.dtype, device=dev)  # t, x_self, dt
        dtc = work[2]
        operands = (xo.data_ptr(), pm.data_ptr(), w.flat.data_ptr(), w.flat_t.data_ptr(), *mid,
                    work.data_ptr(), part.data_ptr())
        if vt is None:
            status = lib.attnpool_bwd(emb.data_ptr(), *operands, demb_p, dxo.data_ptr(), bf16,
                                      *dims)
        else:
            status = lib.attnpool_bwd_vocab(emb.data_ptr(), vt.bd.data_ptr(),
                                            bin_mp._sizes_arg(vt), len(vt.sizes), *operands,
                                            dxo.data_ptr(), bf16, *dims)
    if status != 0:
        raise RuntimeError(f"{what}: {lib.attnpool_error_string(status).decode()}")
    red = bin_mp.sum_partials(part)
    dbb = red[:Dsp]
    dks = red[Dsp : Dsp + Ds * H].view(Ds, H)
    dko = red[Dsp + Ds * H : Dsp + Ds * H + Do * H].view(Do, H)
    dsb = red[Dsp + Ds * H + Do * H : head]
    X = emb if vt is None else bin_mp.GatheredX(emb, vt)
    ((dkbT, _),) = bin_mp.wgrad_group([(dtc, X, None)])
    d_emb = demb if vt is None else expand_diag(red[head:], vt)
    return d_emb, dxo, (dkbT, dbb, dks, dko, dsb)


def attnpool_bwd(emb, xo, pm, w: AttnPoolWeights, act: str, attn, gps, gpo, gcov,
                 ws: Optional[torch.Tensor] = None):
    """Launch the backward kernel (bf16: the tiled one, reading ``ws`` as
    :func:`attnpool_fwd` does) and the weight-gradient contraction.  Same
    returns as :func:`attnpool_bwd_plain`."""
    out = _launch_bwd("attnpool_bwd", emb, xo, pm, w, act, attn, gps, gpo, gcov, None, ws)
    attnpool_bwd.launches += 1
    return out


attnpool_bwd.launches = 0


def attnpool_bwd_vocab(codes, xo, pm, w: AttnPoolWeights, act: str, attn, gps, gpo, gcov,
                       vt: VocabTable, ws: Optional[torch.Tensor] = None):
    """Launch the folded backward kernel, the gathered d_kb contraction and
    the fixed-order sum of the per-bin partials.  Same returns as
    :func:`attnpool_bwd_vocab_plain`."""
    out = _launch_bwd("attnpool_bwd_vocab", codes, xo, pm, w, act, attn, gps, gpo, gcov, vt, ws)
    attnpool_bwd_vocab.launches += 1
    return out


attnpool_bwd_vocab.launches = 0


class _AttnPoolFn(torch.autograd.Function):
    """``emb`` is the embeddings (E, A), or under the fold (``vocab`` set)
    the code rows (F, A) int32 with ``bd`` the fp32 block-diagonal table,
    which then gets the gradient in place of emb."""

    @staticmethod
    def forward(ctx, emb, xo, pm, act, vocab, bd, kb, bb, ks, ko, sb):
        dt = xo.dtype
        with torch.no_grad():
            w = prep_weights(kb, bb, ks, ko, sb, dt)
            vt = prep_vocab(bd, vocab, dt) if vocab is not None else None
        ws = None
        if emb.device.type == "cuda":
            ws = _step_stream(xo, pm, w, vt)  # the tiled kernels' weight stream, once for both
            ps, po, cov, attn = (attnpool_fwd(emb, xo, pm, w, act, ws) if vt is None
                                 else attnpool_fwd_vocab(emb, xo, pm, w, act, vt, ws))
        elif emb.device.type == "cpu":
            check_one_owner(pm)  # free here; on the card it would cost a sync per step
            ps, po, cov, attn = (attnpool_fwd_plain(emb, xo, pm, w, act) if vt is None
                                 else attnpool_fwd_vocab_plain(emb, xo, pm, w, act, vt))
        else:
            raise ValueError(f"binned_attnpool_proj_t: unsupported device {emb.device}")
        ctx.save_for_backward(emb, xo, pm, attn)
        ctx.w, ctx.act, ctx.vt, ctx.ws = w, act, vt, ws
        ctx.mark_non_differentiable(attn)
        return ps, po, cov, attn

    @staticmethod
    def backward(ctx, gps, gpo, gcov, _gattn):
        emb, xo, pm, attn = ctx.saved_tensors
        w, vt = ctx.w, ctx.vt
        zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=emb.device)  # noqa: E731
        gps = gps if gps is not None else zeros((w.Ds, pm.shape[0] * pm.shape[1]))
        gpo = gpo if gpo is not None else zeros((xo.shape[0], pm.shape[0] * pm.shape[1]))
        gcov = gcov if gcov is not None else zeros(pm.shape[0] * pm.shape[1])
        args = (emb, xo, pm, w, ctx.act, attn, gps, gpo, gcov)
        cuda = emb.device.type == "cuda"
        demb = d_bd = None
        if vt is None and cuda:
            demb, dxo, (dkbT, dbb, dks, dko, dsb) = attnpool_bwd(*args, ctx.ws)
        elif vt is None:
            demb, dxo, (dkbT, dbb, dks, dko, dsb) = attnpool_bwd_plain(*args)
        elif cuda:
            d_bd, dxo, (dkbT, dbb, dks, dko, dsb) = attnpool_bwd_vocab(*args, vt, ctx.ws)
        else:
            d_bd, dxo, (dkbT, dbb, dks, dko, dsb) = attnpool_bwd_vocab_plain(*args, vt)
        Ds = w.Ds
        return (demb, dxo, None, None, None, d_bd, dkbT[:Ds].T.contiguous(),
                dbb[:Ds].contiguous(), dks, dko, dsb)


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
    embed_spec=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused projection -> scores -> softmax -> pools, differentiable.
    embT (E, A) in the compute dtype; k_blk (E, Ds) / b_blk (Ds,) fp32, the
    x_self block of embedding_projection; xoT (Do, A) post-MP x_other;
    pool_mat (nb, mb, ab) int8, 0/1 with at most one molecule per atom (as
    the loaders build it; :func:`check_one_owner`, which the CPU path runs and
    the kernels do not); score_k_self (Ds, H) / score_k_other (Do, H) /
    score_b (H,) fp32 with the concat and temperature folds applied.
    Returns (pooled_self (Ds, B), pooled_other (Do, B), coverage (B,),
    attn (H, A)), all fp32, B = nb*mb; attn carries no gradient.

    With ``embed_spec=(codes (F, A) int32, blockdiag_t (E, sum of V) fp32,
    vocab_sizes)`` the lookup runs in the kernels (the fold): embT is
    ignored (may be None), the compute dtype is xoT's, and the table takes
    the gradient."""
    if embed_spec is not None:
        codes, bd_t, vocab = embed_spec
        return _AttnPoolFn.apply(codes.to(torch.int32).contiguous(), xoT.contiguous(),
                                 pool_mat.contiguous(), act_name.lower(),
                                 tuple(int(v) for v in vocab), bd_t, k_blk, b_blk, score_k_self,
                                 score_k_other, score_b)
    dt = embT.dtype
    return _AttnPoolFn.apply(embT.contiguous(), xoT.to(dt).contiguous(), pool_mat.contiguous(),
                             act_name.lower(), None, None, k_blk, b_blk, score_k_self,
                             score_k_other, score_b)
