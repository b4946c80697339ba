"""The decompositions the tiled Hopper kernels of kernel 4's forward and the
attention pool's backward rest on, on the CPU (the kernels run only on the
card: see tests/test_torch_cuda.py).

- The pool's backward (kernel 3, and 1c-vocab at the pool's site) on
  64-atom tiles: every reduction over a bin's atoms -- the softmax
  backward's per-molecule t_mol, d_bb, d_ks, d_ko, d_sb and the fold's d_bd
  -- as per-tile partials added in rank order, then over bins in order,
  gives ``attnpool_bwd_plain``'s and ``attnpool_bwd_vocab_plain``'s outputs:
  fp32, rtol 1e-6 (the same fp32 terms summed in another order), on bins
  whose molecules span tile borders.
- d_kb from the grouped contraction's plain version on (dt, emb), and on
  dt and the embeddings gathered from the code rows (``GatheredX``), equals
  the plain backward's.
- The weight streams: ``kbT_stream`` holds kb^T, and ``pool_stream`` kb^T's
  and kb's row blocks (stages padded to 160 rows), where the ring's
  fragment loads read them, exactly.
- Kernel 4's forward on tiles: each 64-atom tile forms the bin's x' chunks
  and its centres' neighbours from x and the bin's per-molecule sums alone,
  each centre that touches it (a centre across a tile border in both), and
  its columns' tet by walking their table entries last to first; this gives
  ``inject_fwd_plain``'s xct and pre bit for bit in fp32.
"""

import numpy as np
import pytest
import torch

from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_inject, bin_mp, embed
from aimnet_x2d_tpu_torch.utils.activation import activation_grad, get_activation_function
from test_torch_stack_bwd_group import _read_fragments, _weights

RTOL = 1e-6
TILE = 64


def _close(got, want, what, scale=None):
    scale = float(want.abs().max()) if scale is None else scale
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


# ---- the attention pool's backward on tiles -------------------------------- #


def _owners(rng, nb, ab, mb):
    """Whole molecules of 5-40 atoms laid along each bin (a few padding atoms
    between some), so that molecules cross the 64-atom tile borders."""
    owner = np.full((nb, ab), -1)
    for b in range(nb):
        a = int(rng.integers(0, 3))
        for m in range(mb):
            n = int(rng.integers(5, 41))
            if a + n > ab:
                break
            owner[b, a : a + n] = m
            a += n + int(rng.integers(0, 2))
    return owner


def _pool_case(ab, seed, vocab=None):
    rng = np.random.default_rng(seed)
    nb, mb, E, Ds, Do, H = 3, 10, 32, 21, 13, 4
    A = nb * ab
    owner = _owners(rng, nb, ab, mb)
    if ab > TILE:  # a molecule across a tile border
        assert any(owner[b, TILE - 1] >= 0 and owner[b, TILE - 1] == owner[b, TILE]
                   for b in range(nb))
    pm = torch.from_numpy((owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8))
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    r = lambda *s: torch.from_numpy(((rng.random(s) - 0.5) * 0.4).astype(np.float32))  # noqa: E731
    w = bin_attnpool.prep_weights(r(E, Ds), r(Ds), r(Ds, H), r(Do, H), r(H), torch.float32)
    xo = t(Do, A)
    if vocab is None:
        emb, codes, vt = t(E, A), None, None
    else:
        codes = torch.from_numpy(np.stack([rng.integers(0, v, A) for v in vocab]).astype(np.int32))
        tables = [t(v, E // len(vocab)) * 0.5 for v in vocab]
        vt = embed.prep_vocab(embed.blockdiag_table_t(tables), vocab, torch.float32)
        emb = embed.embed_from_codes(codes, vt)
    attn = bin_attnpool.attnpool_fwd_plain(emb, xo, pm, w, "silu")[3]
    g = (t(Ds, nb * mb) * 1e-3, t(Do, nb * mb) * 1e-3, t(nb * mb) * 1e-3)
    return emb, codes, vt, xo, pm, w, attn, g


def _rank_order(nb, C, part):
    """sum over bins in order of (sum over the bin's tiles in rank order of
    part(columns of the tile))."""
    total = None
    for b in range(nb):
        row = None
        for r in range(C):
            p = part(slice((b * C + r) * TILE, (b * C + r + 1) * TILE))
            row = p if row is None else row + p
        total = row if total is None else total + row
    return total


def _pool_bwd_tiles(emb, xo, pm, w, act, attn, gps, gpo, gcov, codes=None, vt=None):
    """The pool backward as the tiled kernel splits it (fp32): returns
    (demb or d_bd, dx_other, (dkbT, dbb, dks, dko, dsb), dt, dsc)."""
    dt = w.dtype
    nb, mb, ab = pm.shape
    C, H, Ds = ab // TILE, attn.shape[0], w.Ds
    t = bin_mp._dot(w.kbT, emb, dt) + w.bb[:, None]
    v = get_activation_function(act)(t)[:Ds]
    gs = bin_attnpool._to_atoms(gps.to(dt).float(), pm)
    go = bin_attnpool._to_atoms(gpo.to(dt).float(), pm)
    wbar = attn.mean(dim=0)
    dat = ((gs * v).sum(0) + (go * xo).sum(0)
           + bin_attnpool._to_atoms(gcov.reshape(1, -1), pm)[0]) / H
    # t_mol: each tile's partial over its atoms, the bin's tiles in rank order
    pmf = pm.float()
    ad = (attn * dat).reshape(H, nb, C, TILE)
    pmt = pmf.reshape(nb, mb, C, TILE)
    t_mol = sum(torch.einsum("hba,bma->hbm", ad[:, :, r], pmt[:, :, r]) for r in range(C))
    t_atom = torch.einsum("hbm,bma->hba", t_mol, pmf).reshape(H, -1)
    dsc = (attn * dat - attn * t_atom).to(dt).float()
    dv = gs * wbar + w.ks.float() @ dsc
    dv = torch.cat([dv, dv.new_zeros(w.kbT.shape[0] - Ds, dv.shape[1])])
    dt32 = dv * activation_grad(act, t).float()
    dxo = (go * wbar + w.ko.float() @ dsc).to(dt)
    dtc = dt32.to(dt)
    demb = (w.kbT.float().T @ dtc.float()).to(dt)
    dbb = _rank_order(nb, C, lambda c: dt32[:, c].sum(1))
    dks = _rank_order(nb, C, lambda c: v[:, c] @ dsc[:, c].T)
    dko = _rank_order(nb, C, lambda c: xo[:, c] @ dsc[:, c].T)
    dsb = _rank_order(nb, C, lambda c: dsc[:, c].sum(1))
    X = emb if vt is None else bin_mp.GatheredX(codes, vt)
    ((dkbT, _),) = bin_mp.wgrad_group_plain([(dtc, X, None)])
    if vt is not None:
        demb = _rank_order(nb, C, lambda c: embed.table_grad(demb[:, c], codes[:, c], vt))
    return demb, dxo, (dkbT, dbb, dks, dko, dsb), dtc, dsc


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("ab", [64, 128, 256])
def test_pool_bwd_reductions_by_tile_give_the_plain_backward(ab, fold):
    vocab = (11, 5, 7, 3) if fold else None
    emb, codes, vt, xo, pm, w, attn, g = _pool_case(ab, ab + fold, vocab)
    got = _pool_bwd_tiles(emb, xo, pm, w, "silu", attn, *g, codes, vt)
    if fold:
        want = bin_attnpool.attnpool_bwd_vocab_plain(codes, xo, pm, w, "silu", attn, *g, vt)
    else:
        want = bin_attnpool.attnpool_bwd_plain(emb, xo, pm, w, "silu", attn, *g)
    _close(got[0], want[0], "d_bd" if fold else "demb")
    _close(got[1], want[1], "dx_other")
    names = ("dkbT", "dbb", "dks", "dko", "dsb")
    for i, (a, r) in enumerate(zip(got[2], want[2])):
        # d_sb is a sum of terms that cancel to 0: held to the sum of their
        # magnitudes, which bounds the error of either order
        _close(a, r, names[i], float(got[4].abs().sum(1).max()) if i == 4 else None)


@pytest.mark.parametrize("fold", [False, True])
def test_grouped_contraction_gives_the_pool_d_kb(fold):
    vocab = (11, 5, 7, 3) if fold else None
    emb, codes, vt, xo, pm, w, attn, g = _pool_case(128, 7 + fold, vocab)
    dtc = _pool_bwd_tiles(emb, xo, pm, w, "silu", attn, *g, codes, vt)[3]
    if fold:
        want = bin_attnpool.attnpool_bwd_vocab_plain(codes, xo, pm, w, "silu", attn, *g, vt)
        X = bin_mp.GatheredX(codes, vt)
        assert X.shape == (vt.E, codes.shape[1])
    else:
        want = bin_attnpool.attnpool_bwd_plain(emb, xo, pm, w, "silu", attn, *g)
        X = emb
    ((dkbT, db),) = bin_mp.wgrad_group([(dtc, X, None)])  # CPU tensors: the plain version
    _close(dkbT, want[2][0], "d_kb")
    _close(db, dtc.float().sum(1), "row sums")


@pytest.mark.parametrize("D", [13, 153])
def test_kbT_stream_holds_kbT_in_fragment_order(D):
    rng = np.random.default_rng(D)
    kb = torch.from_numpy(rng.uniform(-1, 1, (3 * D, D)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, D).astype(np.float32))
    iw = bin_inject.prep_inject(kb, b, _weights(rng, D, 1, 1)[0], torch.bfloat16)
    Dp = iw.sw.Dp
    got, rest = _read_fragments(bin_inject.kbT_stream(iw).float().numpy(), Dp, 3 * Dp)
    np.testing.assert_array_equal(got, iw.kbT.float().numpy())
    assert rest.size == 0


@pytest.mark.parametrize("shape", [(368, 256), (32, 32), (176, 48)])
def test_pool_stream_holds_kbT_then_kb_in_row_blocks(shape):
    Dsp, E = shape
    rng = np.random.default_rng(Dsp)
    kbT = rng.uniform(-1, 1, (Dsp, E)).astype(np.float32)
    stream = bin_attnpool.pool_stream_index(Dsp, E)
    flat = np.concatenate([kbT.reshape(-1), [0.0]])[stream]
    rest = flat
    for mat in (kbT, kbT.T):
        K = mat.shape[1]
        stages = -(-K // 32)
        for r0 in range(0, mat.shape[0], 160):
            R = min(160, mat.shape[0] - r0)
            n = stages * 160 * 32
            block, rest = rest[:n].reshape(stages, 160 * 32), rest[n:]
            assert not block[:, R * 32 :].any(), "a stage's rows past the block must be zero"
            got, left = _read_fragments(block[:, : R * 32].reshape(-1), R, K)
            assert left.size == 0
            np.testing.assert_array_equal(got, mat[r0 : r0 + R])
    assert rest.size == 0


# ---- kernel 4's forward on tiles ------------------------------------------- #


def _c3_bins(seed, D, nb=3, ab=256, mb=20, tc=16):
    """Config-3 bins: whole molecules of 4-14 atoms, a tetrahedral centre on
    four atoms of most; a bin's last centre slot on a molecule across the
    64/128 tile border with neighbours on both sides (no atom neighbours more
    than two centres); signed cis/trans adjacency within molecules."""
    rng = np.random.default_rng(seed)
    A = nb * ab
    owner = np.full((nb, ab), -1)
    tet = np.full((nb, 4, tc), -1, np.int32)
    sadj = np.zeros((nb, ab, ab), np.int8)
    for b in range(nb):
        a = t = 0
        for m in range(mb):
            n = int(rng.integers(4, 15))
            if a + n > ab - 2:
                break
            owner[b, a : a + n] = m
            if t < tc - 1 and rng.random() < 0.8:
                tet[b, :, t] = a + rng.choice(n, 4, replace=False)
                t += 1
            i, j = a + rng.choice(n, 2, replace=False)
            sadj[b, i, j] = sadj[b, j, i] = rng.choice([-1, 1])
            a += n
        mol = owner[b, 2 * TILE - 1]
        assert mol >= 0 and owner[b, 2 * TILE] == mol
        rest = [i for i in np.flatnonzero(owner[b] == mol) if i not in (2 * TILE - 1, 2 * TILE)]
        tet[b, :, tc - 1] = [2 * TILE - 1, 2 * TILE, *rng.choice(rest, 2, replace=False)]
    assert max(np.bincount(tet[b][tet[b] >= 0]).max() for b in range(nb)) <= 2
    x = rng.normal(size=(D, A)).astype(np.float32)
    x[1] = np.abs(x[1]) + 0.05
    x[1, ::7] = -0.2  # the 1e-6 clip binds
    q = rng.integers(-1, 2, (nb, mb)).astype(np.float32)
    tca = np.where(owner >= 0, q[np.arange(nb)[:, None], np.maximum(owner, 0)], 0)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    tables = (f(tca.astype(np.float32).reshape(-1)),
              f((owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)), f(tet),
              f(np.array([1.0], np.float32)), f(sadj))
    kb = f(rng.uniform(-1, 1, (3 * D, D)).astype(np.float32) / np.sqrt(3 * D))
    b = f(rng.uniform(-1, 1, D).astype(np.float32) / np.sqrt(3 * D))
    iw = bin_inject.prep_inject(kb, b, _weights(rng, D, 2, 1)[0], torch.float32)
    return f(x), tables, iw


def _inject_fwd_tiles(x, tca, pool, tet_bin, any_tet, sadj, iw):
    """inject_fwd's arithmetic as the tiled kernel derives it (fp32): per
    64-atom tile, from x and the bin's per-molecule sums alone.  Returns
    (pre, xct)."""
    D, A = x.shape
    Dp = iw.sw.Dp
    nb, _, ab = pool.shape
    tc = tet_bin.shape[2]
    anyt = float(any_tet)
    q_new, f_new, _ = bin_inject._charge_fwd(x, tca, pool)  # what each block forms (setup_bin)
    q_new, f_new = q_new.reshape(-1), f_new.reshape(-1)

    def xp_cols(b, cols):  # x' of bin b's columns, from x and the bin's sums
        o = b * ab + np.asarray(cols)
        return torch.cat([q_new[o][None], f_new[o][None], x[2:, o]])

    xct = torch.zeros(3 * Dp, A)
    for b in range(nb):
        tb = tet_bin[b].numpy()
        xbin = torch.cat([xp_cols(b, range(c0, c0 + TILE)) for c0 in range(0, ab, TILE)], 1)
        for r in range(ab // TILE):
            cols = np.arange(r * TILE, (r + 1) * TILE)
            xp = xp_cols(b, cols)
            cct = xp + xbin @ sadj[b][cols].float().T
            # the centres touching the tile: norms and scale
            mine = [t for t in range(tc) if any(tb[k, t] // TILE == r for k in range(4)
                                                if tb[k, t] >= 0)]
            cen = {}
            if mine:
                # the norms over the D rows, reduced in the plain version's
                # layout (D, nb, Tc), so that fp32 sums them in its order
                es = [torch.zeros(D, nb, tc) for _ in range(4)]
                for t in mine:
                    for k in range(4):
                        if tb[k, t] >= 0:
                            es[k][:, b, t] = xp_cols(b, [tb[k, t]])[:, 0]
                mags = [torch.sqrt((e * e).sum(0))[b] for e in es]
                mcl = [m.clamp(min=1e-8) for m in mags]
                scale = torch.tanh((mags[0] + mags[1] + mags[2] + mags[3]) * (1.0 / 12.0)) * anyt
                for t in mine:
                    eN = [es[k][:, b, t] / mcl[k][t] for k in range(4)]
                    sq = [e * e for e in eN]
                    P = []
                    for k in range(4):
                        a1, a2, a3 = (k + 1) % 4, (k + 2) % 4, (k + 3) % 4
                        P.append(sq[a1] * (eN[a2] - eN[a3]) + sq[a2] * (eN[a3] - eN[a1])
                                 + sq[a3] * (eN[a1] - eN[a2]))
                    cen[t] = [p * scale[t] for p in P]
            # tet: each column's table entries, last to first (j = k Tc + t)
            tet = torch.zeros(D, TILE)
            for ci, col in enumerate(cols):
                delta = torch.zeros(D)
                hits = [(k, t) for k in range(4) for t in range(tc) if tb[k, t] == col]
                for k, t in sorted(hits, key=lambda kt: kt[0] * tc + kt[1], reverse=True):
                    delta = delta + cen[t][k]
                m = anyt * float(bool(hits)) + (1.0 - anyt)
                tet[:, ci] = (xp[:, ci] + delta) * m
            o = slice(b * ab + r * TILE, b * ab + (r + 1) * TILE)
            for j, part in enumerate((xp, cct, tet)):
                xct[j * Dp : j * Dp + D, o] = part
    pre = (iw.kbT.float() @ xct).to(iw.dtype) + iw.b[:, None]
    return pre[:D], xct


@pytest.mark.parametrize("D", [13, 40])
def test_inject_fwd_tiles_derive_the_plain_forward(D):
    x, tables, iw = _c3_bins(D, D)
    tet = tables[2].numpy()
    cross = (tet >= 0).all(1) & ((tet // TILE).max(1) > (tet // TILE).min(1))
    assert cross.any(), "a centre with neighbours in two tiles"
    pre, xct = _inject_fwd_tiles(x, *tables, iw)
    rpre, rxct = bin_inject.inject_fwd_plain(x, *tables, iw)
    assert torch.equal(xct, rxct)
    assert torch.equal(pre, rpre)
