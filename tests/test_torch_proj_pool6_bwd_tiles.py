"""The layouts and schedules the Hopper backwards of the projection fold
(kernels 1c and 1c-vocab) and of kernel 6 rest on, on the CPU; the kernels
run only on the card (see tests/test_torch_cuda.py).

The projection fold's bf16 backward (``proj_bwd_wg_kernel`` in
``csrc/mp_stack_bwd.cu``) multiplies with a tile's 64 atoms as rows on
wgmma: t0^T = emb^T kb (N = Dp, K = E; emb's tile MN-major) and dembT =
dtc^T kb^T (N = E in halves of 128, K = Dp; dtc K-major, written so by the
first epilogue).  Both products read one resident copy of kb, in core
matrices of 8 d by 8 consecutive e (``bin_mp.proj_wg_index``): K-major for
the first, MN-major (wgmma's transpose bit) for the second.  Rendered here:
every (feature, atom) of each operand and staging tile is held once, the
epilogues' shared-memory accesses are free of bank conflicts, and kb read by
both descriptors reads back every weight.  The transposed chain (t0^T,
dt0, dtc, dembT in the plain version's cast points) with its per-block d_bb
partials (persistent blocks, tiles b, b + G, ...; summed in block order)
and, under the embedding fold, its per-block d_bd partials (each feature's
codes sorted stably, each run of one code a row's sum in atom order, added
to the block's partial) holds to ``_proj_bwd_plain`` and
``mp_stack_bwd_vocab_plain`` (fp32 rtol 1e-5: the same fp32 products summed
in another order) and to JAX's ``binned_mp_stack_t`` gradient with
``proj_weights``, with and without ``embed_spec``, in interpret mode (the
fp32 bar, rtol 5e-4 / atol 5e-5; the bf16 bar, max|d|/max|ref| < 5e-2).

Kernel 6's backward on tiles (``bin_pool_bwd_tile_kernel`` in
``csrc/bin_pool.cu``): one 64-atom tile a block, a bin's tiles a cluster.
Each tile takes its atoms' attn columns and head mean, dw from eight column
groups an atom (added in order), t_mol as per-tile partials per (head,
molecule) summed over the ranks in rank order (one exchange), ds rounded to
the compute dtype, dx from the tile's rows, and its d_ks, d_ko and d_b
partials, summed over the ranks in rank order into the bin's partial.
``_pool6_bwd_tiles`` renders that schedule; it holds to ``pool_bwd_plain``
(fp32 rtol 1e-5) and to the vjp of JAX's ``binned_attention_pool_fused`` in
interpret mode (the fp32 and bf16 bars) on bins of 64, 128 and 256 atoms
with molecules across tile borders, one molecule over three tiles, atoms of
no molecule, empty molecule slots and a padding bin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ext_fwd_pool6_tiles import (JDT, TDT, TILE, _acc_coords, _close, _kmajor,
                                            _mnmajor, _pool6_case, _rank_sum,
                                            _read_by_descriptor)

from aimnet_x2d_tpu.ops import embed as jax_embed
from aimnet_x2d_tpu.ops.bin_mp import binned_mp_stack_t as jax_stack
from aimnet_x2d_tpu.ops.bin_pool import binned_attention_pool_fused as jax_pool
from aimnet_x2d_tpu_torch.ops import bin_mp, bin_pool, embed
from aimnet_x2d_tpu_torch.utils.activation import activation_grad

torch.set_num_threads(1)

G32_LD = 68  # floats a row of the g32 tile (64 atoms, padded)


# ---- the projection backward: layouts ------------------------------------- #


def _banks_free(words):
    """True if the 32-bit words a warp touches at once (32 lanes) lie in
    distinct banks, the same word read or written by several lanes aside."""
    w = np.unique(np.asarray(words).ravel())
    return len(np.unique(w % 32)) == len(w)


@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("Dp", [32, 64, 96, 128, 160])
def test_proj_wgmma_layouts_hold_each_value_once(Dp, E):
    # the accumulators of both products cover their tiles once
    for N in (Dp, 128):
        atom, feat = _acc_coords(N)
        assert np.array_equal(np.sort((atom * N + feat).ravel()), np.arange(TILE * N))
    # emb's tile, MN-major (K = E features): the producer's 16-byte copies of
    # each row's 8 chunks land where the descriptor of each K step reads
    m, k = np.meshgrid(np.arange(TILE), np.arange(E), indexing="ij")
    off = _mnmajor(m, k)
    assert np.array_equal(np.sort(off.ravel()), np.arange(0, 128 * E, 2))
    assert np.array_equal(_read_by_descriptor(k, m, 0, 1024, 128, True), off)
    r, ch = np.meshgrid(np.arange(E), np.arange(8), indexing="ij")
    assert np.array_equal((r >> 3) * 1024 + ch * 128 + (r & 7) * 16, _mnmajor(8 * ch, r))
    # dtc's tile, K-major (K = Dp): the first epilogue's pair stores and the
    # second product's descriptor
    atom, feat = _acc_coords(Dp)
    T, i = np.arange(128)[:, None], np.arange(0, Dp // 2, 2)[None, :]
    w, g, t, j, h = T // 32, (T % 32) // 4, T % 4, i // 4, (i // 2) % 2
    assert np.array_equal((2 * w + h) * 16 * Dp + j * 128 + g * 16 + t * 4,
                          _kmajor(atom[:, ::2], feat[:, ::2], Dp))
    m, k = np.meshgrid(np.arange(TILE), np.arange(Dp), indexing="ij")
    assert np.array_equal(_read_by_descriptor(k, m, 0, 128, 16 * Dp, False), _kmajor(m, k, Dp))
    # g32's tile: rows of 64 floats, 68 apart; the first epilogue's reads of
    # (feature 8j + 2t + q, atom 16w + g + 8h) are free of bank conflicts
    cells = (feat * G32_LD + atom).ravel()
    assert len(np.unique(cells)) == TILE * Dp and cells.max() < Dp * G32_LD
    for wi in range(4):
        lanes = slice(32 * wi, 32 * wi + 32)
        for acc in range(Dp // 2):
            assert _banks_free(feat[lanes, acc] * G32_LD + atom[lanes, acc])
    # the emb form's demb staging, [e][atom] with its 16-byte chunks
    # swizzled by e % 8: each (e, atom) once, whole chunks of 8 atoms, and
    # the second epilogue's 2-byte stores free of bank conflicts
    e, a = np.meshgrid(np.arange(E), np.arange(TILE), indexing="ij")
    stage = e * 128 + (((a >> 3) ^ (e & 7)) << 4) + (a & 7) * 2
    assert np.array_equal(np.sort(stage.ravel()), np.arange(0, 128 * E, 2))
    atom, feat = _acc_coords(128)
    for c in range(E // 128):
        ee = 128 * c + feat
        off = ee * 128 + (((atom >> 3) ^ (ee & 7)) << 4) + (atom & 7) * 2
        for wi in range(4):
            for acc in range(64):
                assert _banks_free(off[32 * wi: 32 * wi + 32, acc] // 4)
    # the embedding fold's demb staging, [atom][E + 8]: each value once, the
    # second epilogue's pair stores free of bank conflicts
    vo = atom * (E + 8) * 2 + feat * 2
    for c in range(E // 128):
        cells = vo + 256 * c
        for wi in range(4):
            for acc in range(0, 64, 2):
                assert _banks_free(cells[32 * wi: 32 * wi + 32, acc] // 4)
    full = (np.arange(TILE)[:, None] * (E + 8) + np.arange(E)[None, :]).ravel()
    assert len(np.unique(full)) == TILE * E


def _proj_case(rng, D, E, dtype):
    kb = (rng.uniform(-1, 1, (E, D)) / np.sqrt(E)).astype(np.float32)
    bb = rng.uniform(-0.2, 0.2, D).astype(np.float32)
    return bin_mp.prep_proj(torch.tensor(kb), torch.tensor(bb), TDT[dtype], bin_mp.padded_dim(D))


@pytest.mark.parametrize("E", [128, 256])
@pytest.mark.parametrize("D", [19, 153])
def test_proj_kb_reads_back_every_weight_in_both_majors(D, E):
    pw = _proj_case(np.random.default_rng(D + E), D, E, "bfloat16")
    Dp = pw.kbT.shape[0]
    stream = bin_mp.proj_wg_weights(pw)
    assert stream.numel() == Dp * E + Dp and torch.equal(stream[Dp * E:], pw.bb)

    def at(byte):
        return stream[torch.from_numpy(np.asarray(byte) // 2)]

    n, k = np.meshgrid(np.arange(Dp), np.arange(16), indexing="ij")
    for s in range(E // 16):  # kb^T emb: B K-major, N = d, K = e
        got = at(s * 32 * Dp + (k // 8) * 16 * Dp + (n // 8) * 128 + (n % 8) * 16 + (k % 8) * 2)
        assert torch.equal(got, pw.kbT[:, 16 * s: 16 * s + 16])
    n, k = np.meshgrid(np.arange(128), np.arange(16), indexing="ij")
    for c in range(E // 128):  # kb dtc: B MN-major, N = e (a half), K = d
        for s in range(Dp // 16):
            got = at(256 * c * Dp + 256 * s + (k // 8) * 128 + (n // 8) * 16 * Dp + (k % 8) * 16
                     + (n % 8) * 2)
            assert torch.equal(got, pw.kbT[16 * s: 16 * s + 16, 128 * c: 128 * c + 128].T)


# ---- the projection backward: the schedule -------------------------------- #


def _runs_accumulate(part, demb_t, codes_t, vt):
    """The embedding fold's table accumulation of one tile: per feature, the
    tile's codes sorted stably; each run of one valid code adds the sum of
    its atoms' demb rows, in atom order, to the block's compact partial."""
    Df = vt.Df
    for f, V in enumerate(vt.sizes):
        cf = codes_t[f]
        order = sorted(range(TILE), key=lambda a: int(cf[a]))
        p = 0
        while p < TILE:
            code = int(cf[order[p]])
            q = p
            while q < TILE and int(cf[order[q]]) == code:
                q += 1
            if 0 <= code < V:
                run = demb_t[order[p]].float()[f * Df:(f + 1) * Df].clone()
                for r in order[p + 1: q]:
                    run = run + demb_t[r].float()[f * Df:(f + 1) * Df]
                base = Df * vt.offsets[f]
                part[base + np.arange(Df) * V + code] += run
            p = q


def _proj_bwd_tiles(x, g32, pw, act, vt=None, blocks=3):
    """The projection fold's backward as the wgmma kernel schedules it (see
    the top of this file), blocks persistent over the 64-atom tiles; then
    d_kb as the grouped contraction forms it.  Same arguments and returns as
    ``_proj_bwd_plain`` (x the embeddings) or, with ``vt`` (x the code rows),
    ``mp_stack_bwd_vocab_plain``."""
    dt = pw.kbT.dtype
    Dp, A = g32.shape
    E = pw.E
    emb = embed.embed_from_codes(x, vt) if vt is not None else x
    n_tiles = A // TILE
    kb = pw.kbT.float()
    n_acc = vt.Df * vt.offsets[-1] if vt is not None else 0
    parts = torch.zeros(blocks, Dp + n_acc)
    demb = torch.zeros(E, A, dtype=dt)
    dtc = torch.zeros(Dp, A, dtype=dt)
    for b in range(blocks):
        for tile in range(b, n_tiles, blocks):
            cols = slice(tile * TILE, (tile + 1) * TILE)
            t0 = (emb[:, cols].T.float() @ kb.T).to(dt) + pw.bb  # (64, Dp)
            dt0 = g32[:, cols].T * activation_grad(act, t0).float()
            dtc_t = dt0.to(dt)
            parts[b, :Dp] += dt0.sum(0)
            demb_t = torch.cat([(dtc_t.float() @ kb[:, c: c + 128]).to(dt)
                                for c in range(0, E, 128)], 1)  # (64, E)
            dtc[:, cols] = dtc_t.T
            if vt is None:
                demb[:, cols] = demb_t.T
            else:
                _runs_accumulate(parts[b, Dp:], demb_t, x[:, cols], vt)
    tot = _rank_sum(list(parts))
    dkbT = dtc.float() @ emb.float().T
    if vt is None:
        return demb, dkbT, tot[:Dp]
    return embed.expand_diag(tot[Dp:], vt), dkbT, tot[:Dp]


VOCAB = (11, 5, 7, 3)


def _vocab(rng, E, A, dtype):
    codes = np.stack([rng.integers(0, v, A) for v in VOCAB]).astype(np.int32)
    for f, v in enumerate(VOCAB):  # codes outside the vocabularies get nothing
        codes[f, rng.integers(0, A, 3)] = -1
        codes[f, rng.integers(0, A, 3)] = v
    codes[:, -TILE:] = 0  # a padding tile, as the loaders fill it
    tables = [rng.normal(size=(v, E // len(VOCAB))).astype(np.float32) for v in VOCAB]
    bd = embed.blockdiag_table_t([torch.tensor(t) for t in tables])
    return torch.from_numpy(codes), tables, embed.prep_vocab(bd, VOCAB, TDT[dtype])


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("vocab", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proj_tiles_give_the_plain_backward(dtype, vocab, act):
    rng = np.random.default_rng(7 + vocab)
    D, E, A = 19, 32, 7 * TILE
    pw = _proj_case(rng, D, E, dtype)
    g32 = torch.tensor(rng.normal(size=(pw.kbT.shape[0], A)).astype(np.float32)) * 0.1
    g32[D:] = 0
    if vocab:
        codes, _, vt = _vocab(rng, E, A, dtype)
        got = _proj_bwd_tiles(codes, g32, pw, act, vt)
        want = bin_mp.mp_stack_bwd_vocab_plain(codes, g32.clone(), pw, vt, act)
    else:
        emb = torch.tensor(rng.normal(size=(E, A)).astype(np.float32)).to(TDT[dtype])
        got = _proj_bwd_tiles(emb, g32, pw, act)
        want = bin_mp._proj_bwd_plain(emb, g32, pw, act)
    for name, a, r in zip(("demb or d_bd", "dkbT", "dbb"), got, want):
        # the same products and casts; the fp32 sums in another order
        _close(a, r, "float32", f"tiles vs plain {name} ({dtype})", rtol=1e-5, atol=1e-6)


def _walk_g32(x, adj, sw, spec, pw, vt, g):
    """The walk's fp32 cotangent of x0 from the plain versions (the input of
    the projection's backward)."""
    _, saved = bin_mp.mp_stack_train_plain(x, adj, sw, spec, pw, vt)
    g32 = bin_mp._pad_rows(g.float(), sw.Dp)
    for l in range(len(sw.layers) - 1, -1, -1):
        g32, _ = bin_mp._layer_bwd_plain(bin_mp._pad_rows(saved[l], sw.Dp), adj, sw.layers[l],
                                         spec, sw.n_blocks, l, g32)
    return g32


@pytest.mark.parametrize("vocab", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proj_tiles_give_the_jax_gradient(dtype, vocab, monkeypatch):
    for var in ("AIMNET_MP_GROUP_FWD", "AIMNET_MP_GROUP_BWD"):  # one bin a grid step
        monkeypatch.setenv(var, "1")
    rng = np.random.default_rng(31 + vocab)
    D, E, nb, ab, act = 19, 16, 2, 2 * TILE, "silu"
    A = nb * ab
    u = lambda s, fan: (rng.uniform(-1, 1, s) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    layer = [u((D, D), 2 * D), u((D, D), 2 * D), u(D, 2 * D), u((D, D), 2 * D), u((D, D), 2 * D),
             u(D, 2 * D), u((D, D), D), u(D, D), u((D, D), D), u(D, D)]
    kb, bb = u((E, D), E), u(D, E)
    adj = rng.integers(0, 2, (nb, ab, ab)).astype(np.int8)
    g = rng.normal(size=(D, A)).astype(np.float32)
    tdt = TDT[dtype]
    if vocab:
        codes, tables, vt = _vocab(rng, E, A, dtype)
        spec_j = dict(embed_spec=(jnp.asarray(codes.numpy()), None, VOCAB))
        x_t = codes
    else:
        emb = rng.normal(size=(E, A)).astype(np.float32)
        if dtype == "bfloat16":
            emb = np.asarray(jnp.asarray(emb, jnp.bfloat16).astype(jnp.float32))
        x_t, vt = torch.tensor(emb).to(tdt), None

    def f(src, kb_, bb_):
        if vocab:
            es = (spec_j["embed_spec"][0], jax_embed.blockdiag_table_t(src), VOCAB)
            return jax_stack(None, jnp.asarray(adj), ((tuple(jnp.asarray(w) for w in layer)),),
                             act=act, num_mlp_layers=1, compute_dtype=JDT[dtype], interpret=True,
                             proj_weights=(kb_, bb_), embed_spec=es)
        return jax_stack(src, jnp.asarray(adj), ((tuple(jnp.asarray(w) for w in layer)),),
                         act=act, num_mlp_layers=1, compute_dtype=JDT[dtype], interpret=True,
                         proj_weights=(kb_, bb_))

    src = [jnp.asarray(t) for t in tables] if vocab else jnp.asarray(emb, JDT[dtype])
    # XLA:CPU has no bf16 x bf16 = f32 dot under jit: the bf16 case runs eagerly
    out, vjp = jax.vjp(jax.jit(f) if dtype == "float32" else f, src, jnp.asarray(kb),
                       jnp.asarray(bb))
    d_src, dkb_ref, dbb_ref = vjp(jnp.asarray(g).astype(out.dtype))

    sw = bin_mp.stack_weights([[torch.tensor(w) for w in layer]], tdt)
    pw = bin_mp.prep_proj(torch.tensor(kb), torch.tensor(bb), tdt, sw.Dp)
    spec = bin_mp.StackSpec(act, 0.0, 0, 1)
    g32 = _walk_g32(x_t, torch.from_numpy(adj), sw, spec, pw, vt, torch.tensor(g).to(tdt))
    d_x, dkbT, dbb = _proj_bwd_tiles(x_t, g32, pw, act, vt, blocks=3)
    _close(dkbT[:D].T, np.asarray(dkb_ref, np.float32), dtype, "tiles vs jax d_kb")
    _close(dbb[:D], np.asarray(dbb_ref, np.float32), dtype, "tiles vs jax d_bb")
    if vocab:
        tt = [torch.tensor(t).requires_grad_(True) for t in tables]
        embed.blockdiag_table_t(tt).backward(d_x)
        for k, (t, r) in enumerate(zip(tt, d_src)):
            _close(t.grad, np.asarray(r, np.float32), dtype, f"tiles vs jax table {k}")
    else:
        _close(d_x.float(), np.asarray(jnp.asarray(d_src, jnp.float32)), dtype, "tiles vs jax demb")


# ---- kernel 6: the backward on tiles --------------------------------------- #


def _pool6_bwd_tiles(xs, xo, pm, ks, ko, attn, gps, gpo, gcov):
    """Kernel 6's backward as the tile kernel schedules it (see the top of
    this file); same arguments and returns as ``pool_bwd_plain``."""
    dt = xs.dtype
    nb, mb, ab = pm.shape
    Ds, Do, H = xs.shape[1], xo.shape[1], ks.shape[1]
    C = ab // TILE
    kcat = torch.cat([ks.float(), ko.float()])  # (Ds + Do, H)
    dxs, dxo = torch.zeros_like(xs), torch.zeros_like(xo)
    bins = []
    for bn in range(nb):
        tiles = []
        for r in range(C):
            cols = slice(bn * ab + r * TILE, bn * ab + (r + 1) * TILE)
            pmt = pm[bn, :, r * TILE: (r + 1) * TILE]
            molof = torch.where(pmt.any(0), pmt.float().argmax(0), torch.tensor(-1))
            mc = molof.clamp(min=0)
            on = (molof >= 0)[:, None]
            at = attn[:, cols]  # (H, 64)
            wbar = at.sum(0) / H
            x = torch.cat([xs[cols].float(), xo[cols].float()], 1)  # (64, Ds + Do)
            gm = torch.cat([gps.float(), gpo.float()], 1).reshape(nb, mb, -1)[bn]
            g = torch.where(on, gm[mc], torch.zeros(()))  # each atom's molecule's row
            q = [(x[:, p:Ds:8] * g[:, p:Ds:8]).sum(1) for p in range(8)]
            o = [(x[:, Ds + p::8] * g[:, Ds + p::8]).sum(1) for p in range(8)]
            s1 = ((q[0] + q[1]) + (q[2] + q[3])) + ((q[4] + q[5]) + (q[6] + q[7]))
            s2 = ((o[0] + o[1]) + (o[2] + o[3])) + ((o[4] + o[5]) + (o[6] + o[7]))
            dw = torch.where(molof >= 0, (s1 + s2) + gcov.reshape(nb, mb)[bn][mc],
                             torch.zeros(()))
            tp = torch.zeros(H, mb)
            for m in range(mb):
                sel = molof == m
                if sel.any():
                    tp[:, m] = (at[:, sel] * (dw[sel] / H)).sum(1)
            tiles.append(dict(cols=cols, molof=molof, at=at, wbar=wbar, x=x, g=g, dw=dw, tp=tp))
        tmol = _rank_sum([t["tp"] for t in tiles])  # the cluster's one exchange
        parts = []
        for t in tiles:
            m = t["molof"]
            tm = torch.where(m >= 0, tmol[:, m.clamp(min=0)], torch.zeros(()))
            ds = (t["at"] * (t["dw"] / H) - t["at"] * tm).to(dt).float()  # (H, 64)
            dx = (t["g"] * t["wbar"][:, None] + ds.T @ kcat.T).to(dt)
            dxs[t["cols"]], dxo[t["cols"]] = dx[:, :Ds], dx[:, Ds:]
            parts.append(torch.cat([(t["x"].T @ ds.T).reshape(-1), ds.sum(1)]))
        bins.append(_rank_sum(parts))
    tot = _rank_sum(bins)  # bin_pool_sum_partials, bins in order
    return dxs, dxo, (tot[: Ds * H].view(Ds, H), tot[Ds * H: (Ds + Do) * H].view(Do, H),
                      tot[(Ds + Do) * H:])


@pytest.mark.parametrize("ref", ["plain-float32", "jax-float32", "jax-bfloat16"])
@pytest.mark.parametrize("ab", [64, 128, 256])
def test_pool6_bwd_tiles_give_the_backward(ab, ref):
    kind, dtype = ref.split("-")
    pm, xs, xo, sk, sb = _pool6_case(ab, 2 * ab + len(ref), dtype)
    rng = np.random.default_rng(ab)
    nb, mb, _ = pm.shape
    Ds, H = xs.shape[1], sk.shape[1]
    cot = [rng.normal(size=(nb * mb, Ds)).astype(np.float32),
           rng.normal(size=(nb * mb, xo.shape[1])).astype(np.float32),
           rng.normal(size=(nb * mb,)).astype(np.float32)]
    tdt = TDT[dtype]
    ks, ko = torch.tensor(sk[:Ds]).to(tdt), torch.tensor(sk[Ds:]).to(tdt)
    xs_t, xo_t, pm_t = torch.tensor(xs).to(tdt), torch.tensor(xo).to(tdt), torch.from_numpy(pm)
    attn = bin_pool.pool_fwd_plain(xs_t, xo_t, pm_t, ks, ko, torch.tensor(sb))[3]
    got = _pool6_bwd_tiles(xs_t, xo_t, pm_t, ks, ko, attn, *map(torch.tensor, cot))
    flat = [got[0], got[1], torch.cat([got[2][0], got[2][1]]), got[2][2]]
    names = ("d x_self", "d x_other", "d score_k", "d score_b")
    if kind == "plain":
        want = bin_pool.pool_bwd_plain(xs_t, xo_t, pm_t, ks, ko, attn, *map(torch.tensor, cot))
        ref_ = [want[0], want[1], torch.cat([want[2][0], want[2][1]]), want[2][2]]
        for name, a, r in zip(names, flat, ref_):
            # d_b is a sum of terms that cancel to 0: held to d_ks's scale
            atol = 1e-6 * float(ref_[2].abs().max()) if name == "d score_b" else 1e-6
            _close(a, r, "float32", f"tiles vs plain {name}", rtol=1e-5, atol=atol)
    else:
        def f(xs_, xo_, sk_, sb_):
            return jax_pool(xs_, xo_, jnp.asarray(pm), sk_, sb_, interpret=True)

        out, vjp = jax.vjp(f, jnp.asarray(xs, JDT[dtype]), jnp.asarray(xo, JDT[dtype]),
                           jnp.asarray(sk), jnp.asarray(sb))
        ref_g = vjp((*(jnp.asarray(c) for c in cot), jnp.zeros_like(out[3])))
        for name, a, r in zip(names, flat, ref_g):
            _close(a.float(), np.asarray(jnp.asarray(r, jnp.float32)), dtype, f"tiles vs jax {name}")
    # the cases hold what the tiles must meet
    owner = np.where(pm.any(1), pm.argmax(1), -1)
    assert (owner[-1] == -1).all() and (pm.sum(2) == 0).any() and (owner[:-1] == -1).any()
    if ab >= 192:
        assert len({a // TILE for a in np.flatnonzero(owner[1] == 1)}) == 3
