"""The layouts and schedules the Hopper forwards of kernels 5 and 6 rest on,
on the CPU; the kernels run only on the card (see tests/test_torch_cuda.py).

Kernel 5's bf16 forward (``ext_fwd_wg_kernel`` in ``csrc/mp_ext.cu``)
multiplies with a tile's 64 atoms as rows on wgmma: out^T = xa^T W^T.  Its
accumulators, its A operands (xa's tile MN-major, h and v K-major, no
swizzle), its output staging tile and its weight stream
(``bin_mp.ext_wg_stream_index``) are rendered here in numpy: every
(feature, atom) of a tile is held once, the dropout keep drawn through the
accumulator layout is the JAX kernel's ``_dropout_mask`` bit for bit, and
the stream reads back every weight exactly.  The transposed chain (atoms as
rows, W_s before W_in on xa, the same cast points) in plain PyTorch holds to
``mp_ext_plain`` (fp32 rtol 1e-5: the same fp32 products summed in another
order; bf16 5e-2) and to JAX's ``binned_mp_layer_ext_t`` in interpret mode
(the fp32 bar, rtol 5e-4 / atol 5e-5; the bf16 bar, max|d|/max|ref| < 5e-2).

Kernel 6's forward on tiles (``bin_pool_fwd_tile_kernel`` in
``csrc/bin_pool.cu``): one 64-atom tile a block, a bin's tiles a cluster.
Each tile forms its atoms' scores (eight column groups, added in order),
the softmax over molecules that cross tiles from per-tile partial maxima
and denominators at them (rescaled to the bin's maximum and summed over
the ranks in rank order: one exchange), and its pool and
coverage partials a column at a time over runs of atoms of one molecule;
the partials are summed over the ranks in rank order.  ``_pool6_tiles``
renders that schedule; it holds to ``pool_fwd_plain`` (fp32 rtol 1e-5) and
to JAX's ``binned_attention_pool_fused`` in interpret mode (the fp32 and
bf16 bars) on bins of 64, 128 and 256 atoms with molecules across tile
borders, one molecule over three tiles, a molecule in two runs, atoms of no
molecule, empty molecule slots and a padding bin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.ops.bin_mp import _dropout_mask as jax_mask
from aimnet_x2d_tpu.ops.bin_mp import binned_mp_layer_ext_t as jax_ext
from aimnet_x2d_tpu.ops.bin_pool import binned_attention_pool_fused as jax_pool
from aimnet_x2d_tpu_torch.ops import bin_mp, bin_pool
from aimnet_x2d_tpu_torch.ops.bin_attnpool import _softmax_plain
from aimnet_x2d_tpu_torch.utils.activation import get_activation_function

torch.set_num_threads(1)

TILE = 64
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
M32 = 0xFFFFFFFF


def _close(got, want, dtype, what, rtol=5e-4, atol=5e-5):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor) else want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), max(float(np.abs(want).max()), 1e-30)
    print(f"{what} {dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / scale:.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    else:
        assert err / scale < 5e-2, what


# ---- kernel 5: the wgmma layouts ------------------------------------------ #


def _acc_coords(N):
    """(atom, feature) of accumulator i of thread T of a warpgroup, (128, N/2)
    each: d[4j + 2h + q] = D(16w + g + 8h, 8j + 2t + q)."""
    T, i = np.arange(128)[:, None], np.arange(N // 2)[None, :]
    w, g, t = T // 32, (T % 32) // 4, T % 4
    j, h, q = i // 4, (i // 2) % 2, i % 2
    return 16 * w + g + 8 * h + 0 * i, 8 * j + 2 * t + q + 0 * T


def _kmajor(atom, feature, N):
    """Byte offset of (atom, feature) in a K-major [atom][feature] tile:
    core matrices of 8 atoms x 8 features, 128 bytes apart along the
    features, 16 N bytes apart along the atoms."""
    return (atom // 8) * 16 * N + (feature // 8) * 128 + (atom % 8) * 16 + (feature % 8) * 2


def _mnmajor(atom, feature):
    """Byte offset of (atom, feature) in xa's MN-major tile: core matrices of
    8 features x 8 atoms, 128 bytes apart along the atoms, 1024 along the
    features."""
    return (feature // 8) * 1024 + (atom // 8) * 128 + (feature % 8) * 16 + (atom % 8) * 2


def _read_by_descriptor(k, m, start, lbo, sbo, mn_major):
    """The byte a wgmma of K 16 reads for A's (m, k) from a no-swizzle
    descriptor (start of K-step k // 16, core-matrix strides lbo along K and
    sbo along M)."""
    base = start + (k // 16) * (2048 if mn_major else 256)
    kk = k % 16
    core = base + (kk // 8) * lbo + (m // 8) * sbo
    return core + ((kk % 8) * 16 + (m % 8) * 2 if mn_major else (m % 8) * 16 + (kk % 8) * 2)


def _keep(feature, col, mix, thresh):
    """csrc/common.cuh drop_keep in numpy uint32 arithmetic."""
    f, c = feature.astype(np.uint64), col.astype(np.uint64)
    x = ((f * 0x85EBCA6B) & M32) ^ ((c * 0xC2B2AE35) & M32) ^ mix
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    x ^= x >> 16
    return x >= thresh


@pytest.mark.parametrize("N", [32, 64, 96, 128, 160])
def test_wgmma_layouts_hold_each_feature_and_atom_once(N):
    atom, feat = _acc_coords(N)
    cells = atom * N + feat
    assert np.array_equal(np.sort(cells.ravel()), np.arange(TILE * N))
    # the epilogue's bf16-pair stores land where the next product's A reads
    T, i = np.arange(128)[:, None], np.arange(0, N // 2, 2)[None, :]
    w, g, t, j, h = T // 32, (T % 32) // 4, T % 4, i // 4, (i // 2) % 2
    kernel_off = (2 * w + h) * 16 * N + j * 128 + g * 16 + t * 4
    assert np.array_equal(kernel_off, _kmajor(atom[:, ::2], feat[:, ::2], N))
    m, k = np.meshgrid(np.arange(TILE), np.arange(N), indexing="ij")
    off = _kmajor(m, k, N)
    assert np.array_equal(np.sort(off.ravel()), np.arange(0, 128 * N, 2))
    assert np.array_equal(_read_by_descriptor(k, m, 0, 128, 16 * N, False), off)
    # xa's tile: 2N features, MN-major; the producer's 16-byte copies
    m, k = np.meshgrid(np.arange(TILE), np.arange(2 * N), indexing="ij")
    off = _mnmajor(m, k)
    assert np.array_equal(np.sort(off.ravel()), np.arange(0, 256 * N, 2))
    assert np.array_equal(_read_by_descriptor(k, m, 0, 1024, 128, True), off)
    r, ch = np.meshgrid(np.arange(2 * N), np.arange(8), indexing="ij")
    dst = (r >> 3) * 1024 + ch * 128 + (r & 7) * 16
    assert np.array_equal(dst, _mnmajor(8 * ch, r))
    # the output staging tile: row f of 128 bytes, 16-byte chunks swizzled
    f, a = np.meshgrid(np.arange(N), np.arange(TILE), indexing="ij")
    stage = f * 128 + (((a >> 3) ^ (f & 7)) << 4) + (a & 7) * 2
    assert np.array_equal(np.sort(stage.ravel()), np.arange(0, 128 * N, 2))
    chunk = f[:, ::8] * 128 + (((a[:, ::8] >> 3) ^ (f[:, ::8] & 7)) << 4)
    assert np.array_equal(chunk, stage[:, ::8])  # a chunk's first atom opens it


@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_wgmma_dropout_keep_is_the_jax_mask(rate):
    """The keep the W1 epilogue draws at its accumulators' (feature, atom)
    coordinates, tile by tile of a rank's columns, equals JAX's mask."""
    N, tiles = 160, 3
    atom, feat = _acc_coords(N)
    thresh = min(int(rate * 2**32), 2**32 - 1)
    for seed, tag in ((0, 0), (0x7FFFFFFF, 1), (-5 & M32, 1)):
        want = np.asarray(jax_mask((N, tiles * TILE), rate, jnp.uint32(seed), jnp.uint32(tag),
                                   jnp.uint32(0)))
        mix = (seed + tag * 0x9E3779B9) & M32
        for tile in range(tiles):
            col = tile * TILE + atom
            got = _keep(feat, col, mix, thresh)
            assert np.array_equal(got, want[feat, col])


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
@pytest.mark.parametrize("D", [19, 153])
def test_wgmma_stream_reads_back_every_weight(D, n_blocks):
    rng = np.random.default_rng(D + n_blocks)
    shapes = [(D, D), (D, D), (D,), (D, D), (D, D), (D,)] + [(D, D), (D,), (D, D), (D,)] * n_blocks
    sw = bin_mp.stack_weights([[torch.tensor(rng.normal(size=s).astype(np.float32))
                                for s in shapes]], torch.bfloat16)
    Dp, ws = sw.Dp, sw.layers[0]
    stream = bin_mp.ext_wg_weights(sw)
    assert stream.numel() == bin_mp.ext_wg_stream_elems(Dp, n_blocks)
    n, k = np.meshgrid(np.arange(Dp), np.arange(32), indexing="ij")
    pos = (n // 8) * 256 + (k // 8) * 64 + (n % 8) * 8 + k % 8

    def stage(s):
        return stream[s * 32 * Dp: (s + 1) * 32 * Dp][torch.from_numpy(pos)]

    s = 0  # W_s, W_in, then W1_b and W2_b of each block
    for mat in [ws[2], ws[0]] + [ws[k + 4 * b] for b in range(n_blocks) for k in (4, 6)]:
        for kc in range(mat.shape[1] // 32):
            assert torch.equal(stage(s), mat[:, 32 * kc: 32 * kc + 32])
            s += 1
    biases = stream[s * 32 * Dp:].reshape(-1, Dp)
    want = [ws[1], ws[3]] + [ws[5 + 2 * i] for i in range(2 * n_blocks)]
    assert len(biases) == len(want)
    for got, ref in zip(biases, want):
        assert torch.equal(got, ref)


def _ext_wg_chain(xa, sw, spec):
    """Kernel 5's forward as the wgmma kernel orders it, atoms as rows:
    s = rnd(xa^T W_s^T + b_s) first and kept, then h from xa^T W_in^T; the
    blocks; out = rnd(h + s).  The casts of the plain version."""
    dt, D, Dp = sw.dtype, sw.D, sw.Dp
    ws = sw.layers[0]
    fn = get_activation_function(spec.act)
    X = bin_mp._pad_xa(xa, D, Dp).T  # (A, 2Dp)
    dot = lambda a, w: torch.matmul(a.float(), w.float().T).to(dt)  # noqa: E731
    s = dot(X, ws[2]) + ws[3]
    h = fn(dot(X, ws[0]) + ws[1])
    for i in range(sw.n_blocks):
        w1, b1, w2, b2 = ws[4 + 4 * i: 8 + 4 * i]
        v = fn(dot(h, w1) + b1)
        drop = spec.drop(0, i, sw.n_blocks)
        if drop is not None:
            rate, seed, tag = drop
            keep = bin_mp.dropout_keep(Dp, 0, X.shape[0], rate, seed, tag).T
            v = torch.where(keep, v * bin_mp.drop_scale(rate, dt), torch.zeros((), dtype=dt))
        h = (dot(v, w2) + b2) + h
    return (h + s).T[:D].contiguous()


def _ext_case(dtype, rng, D=19, A=4 * 32, n_blocks=2):
    u = lambda s, fan: rng.uniform(-1, 1, s).astype(np.float32) / np.sqrt(fan)  # noqa: E731
    ws = [u((D, D), 2 * D), u((D, D), 2 * D), u(D, 2 * D), u((D, D), 2 * D), u((D, D), 2 * D),
          u(D, 2 * D)]
    for _ in range(n_blocks):
        ws += [u((D, D), D), u(D, D), u((D, D), D), u(D, D)]
    xa = rng.normal(size=(2 * D, A)).astype(np.float32)
    xa[:, -32:] = 0.0  # a padding bin
    return xa, ws


@pytest.mark.parametrize("ref", ["plain", "jax"])
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgmma_chain_gives_the_layer_forward(dtype, rate, ref):
    rng = np.random.default_rng(11 + int(100 * rate))
    xa, ws = _ext_case(dtype, rng)
    seed = -123456789
    tdt = TDT[dtype]
    sw = bin_mp.stack_weights([[torch.tensor(w) for w in ws]], tdt)
    spec = bin_mp.StackSpec("silu", rate, seed & M32, 1)
    xa_t = torch.tensor(xa).to(tdt)
    got = _ext_wg_chain(xa_t, sw, spec)
    if ref == "plain":
        want = bin_mp.mp_ext_plain(xa_t, sw, spec)
        _close(got, want, dtype, f"chain vs plain rate={rate}", rtol=1e-5, atol=1e-6)
    else:
        want = jax_ext(jnp.asarray(xa).astype(JDT[dtype]), tuple(jnp.asarray(w) for w in ws),
                       ab=32, act="silu", num_mlp_layers=2, compute_dtype=JDT[dtype],
                       interpret=True, dropout=rate,
                       drop_seed=jnp.asarray([seed], jnp.int32) if rate else None)
        _close(got, np.asarray(want.astype(jnp.float32)), dtype, f"chain vs jax rate={rate}")


# ---- kernel 6: the forward on tiles ---------------------------------------- #


def _owners(rng, nb, ab, mb):
    """(nb, ab) molecule of each atom, -1 for none.  Bin 0: molecules of 5-40
    atoms along the bin with gaps (across the tile borders), molecule 0 also
    owning one atom further on (two runs); bin 1: a molecule over atoms
    40-179 (three tiles where ab >= 192), small ones after, the rest padding;
    the last bin pads only.  Trailing molecule slots stay empty."""
    owner = np.full((nb, ab), -1)
    a = int(rng.integers(0, 3))
    for m in range(mb - 2):
        n = int(rng.integers(5, 41))
        if a + n > ab:
            break
        owner[0, a: a + n] = m
        a += n + int(rng.integers(0, 3))
    if a < ab:
        owner[0, a] = 0
    if ab >= 128:
        owner[1, :30] = 0
        owner[1, 40: min(180, ab - 10)] = 1
        owner[1, min(182, ab - 8): min(190, ab)] = 2
    else:
        owner[1, 3:20], owner[1, 25:60] = 0, 1
    return owner


def _pool6_case(ab, seed, dtype):
    rng = np.random.default_rng(seed)
    nb, mb, Ds, Do, H = 3, 10, 21, 13, 4
    owner = _owners(rng, nb, ab, mb)
    pm = (owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)
    xs = rng.normal(size=(nb * ab, Ds)).astype(np.float32)
    xo = rng.normal(size=(nb * ab, Do)).astype(np.float32)
    sk = (rng.normal(size=(Ds + Do, H)) * 0.3).astype(np.float32)
    sb = rng.normal(size=(H,)).astype(np.float32)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        xs, xo = (np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32)) for v in (xs, xo))
    return pm, xs, xo, sk, sb


def _rank_sum(parts):
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def _pool6_tiles(xs, xo, pm, ks, ko, b):
    """Kernel 6's forward as the tile kernel schedules it (see the top of
    this file); same arguments and returns as ``pool_fwd_plain``."""
    dt = xs.dtype
    nb, mb, ab = pm.shape
    Ds, Do, H = xs.shape[1], xo.shape[1], ks.shape[1]
    C = ab // TILE
    ps = torch.zeros(nb * mb, Ds)
    po = torch.zeros(nb * mb, Do)
    cov = torch.zeros(nb * mb)
    attn = torch.zeros(H, nb * ab)
    ksf, kof = ks.float(), ko.float()
    for bn in range(nb):
        tiles = []
        for r in range(C):
            cols = slice(bn * ab + r * TILE, bn * ab + (r + 1) * TILE)
            pmt = pm[bn, :, r * TILE: (r + 1) * TILE]
            molof = torch.where(pmt.any(0), pmt.float().argmax(0), torch.tensor(-1))
            x_s, x_o = xs[cols].float(), xo[cols].float()
            q = [(x_s[:, p::8] @ ksf[p::8], x_o[:, p::8] @ kof[p::8]) for p in range(8)]
            s1, s2 = ([((q[0][k] + q[1][k]) + (q[2][k] + q[3][k]))
                       + ((q[4][k] + q[5][k]) + (q[6][k] + q[7][k]))] for k in (0, 1))
            s1, s2 = s1[0], s2[0]
            sc = ((s1 + s2) + b.float()).T  # (H, 64)
            pmax = torch.full((H, mb), -1e30)
            for m in range(mb):
                sel = molof == m
                if sel.any():
                    pmax[:, m] = torch.maximum(pmax[:, m], sc[:, sel].max(1).values)
            tiles.append(dict(cols=cols, molof=molof, sc=sc, pmax=pmax, xs=xs[cols], xo=xo[cols]))
        for t in tiles:  # each tile's denominator at its own max
            m = t["molof"]
            e = torch.where(m >= 0, torch.exp(t["sc"] - t["pmax"][:, m.clamp(min=0)]),
                            torch.zeros(()))
            t["pden"] = torch.stack([e[:, m == k].sum(1) for k in range(mb)], 1)
        gmax = torch.stack([t["pmax"] for t in tiles]).amax(0)
        gden = _rank_sum([t["pden"] * torch.exp(t["pmax"] - gmax) for t in tiles])
        parts = []
        for t in tiles:
            m = t["molof"]
            mc = m.clamp(min=0)
            at = torch.where(m >= 0, torch.exp(t["sc"] - gmax[:, mc]) / gden[:, mc].clamp(min=1e-16),
                             torch.zeros(()))
            attn[:, t["cols"]] = at
            wbar = at.sum(0) / H
            wdt = wbar.to(dt)
            vals = torch.cat([(t["xs"] * wdt[:, None]).float(), (t["xo"] * wdt[:, None]).float(),
                              wbar[:, None]], 1)  # (64, Ds + Do + 1), rounded products
            part = torch.zeros(mb, Ds + Do + 1)
            c = 0
            while c < TILE:  # runs of atoms of one molecule, each run's sum added
                k = int(m[c])
                e = c
                while e < TILE and int(m[e]) == k:
                    e += 1
                if k >= 0:
                    part[k] += vals[c:e].sum(0)
                c = e
            parts.append(part)
        tot = _rank_sum(parts)
        rows = slice(bn * mb, (bn + 1) * mb)
        ps[rows], po[rows], cov[rows] = tot[:, :Ds], tot[:, Ds: Ds + Do], tot[:, -1]
    return ps, po, cov, attn


@pytest.mark.parametrize("ref", ["plain-float32", "jax-float32", "jax-bfloat16"])
@pytest.mark.parametrize("ab", [64, 128, 256])
def test_pool6_tiles_give_the_forward(ab, ref):
    kind, dtype = ref.split("-")
    pm, xs, xo, sk, sb = _pool6_case(ab, ab + len(ref), dtype)
    tdt = TDT[dtype]
    Ds = xs.shape[1]
    args = (torch.tensor(xs).to(tdt), torch.tensor(xo).to(tdt), torch.from_numpy(pm),
            torch.tensor(sk[:Ds]).to(tdt), torch.tensor(sk[Ds:]).to(tdt), torch.tensor(sb))
    got = _pool6_tiles(*args)
    if kind == "plain":
        want = bin_pool.pool_fwd_plain(*args)
        for name, g, w in zip(("pooled_self", "pooled_other", "coverage", "attn"), got, want):
            _close(g, w, dtype, f"tiles vs plain {name}", rtol=1e-5, atol=1e-6)
    else:
        want = jax_pool(jnp.asarray(xs, JDT[dtype]), jnp.asarray(xo, JDT[dtype]), jnp.asarray(pm),
                        jnp.asarray(sk), jnp.asarray(sb), interpret=True)
        for name, g, w in zip(("pooled_self", "pooled_other", "coverage", "attn"), got, want):
            _close(g, np.asarray(w, np.float32), dtype, f"tiles vs jax {name}")
    # the cases hold what the tiles must meet
    owner = np.where(pm.any(1), pm.argmax(1), -1)
    assert (owner[-1] == -1).all() and (pm.sum(2) == 0).any()
    if ab >= 192:
        assert len({a // TILE for a in np.flatnonzero(owner[1] == 1)}) == 3


def test_pool6_plain_softmax_is_the_tiles_softmax():
    """The tiles' softmax (partial maxima and denominators at them, rescaled
    and summed over the ranks) is ``_softmax_plain``'s on a bin of four
    tiles."""
    pm, xs, xo, sk, sb = _pool6_case(256, 3, "float32")
    Ds = xs.shape[1]
    args = (torch.tensor(xs), torch.tensor(xo), torch.from_numpy(pm), torch.tensor(sk[:Ds]),
            torch.tensor(sk[Ds:]), torch.tensor(sb))
    s = (args[0] @ args[3] + args[1] @ args[4]) + args[5]
    want = _softmax_plain(s.T.contiguous(), args[2])
    _close(_pool6_tiles(*args)[3], want, "float32", "softmax", rtol=1e-5, atol=1e-7)
