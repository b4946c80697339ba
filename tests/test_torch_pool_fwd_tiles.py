"""The decomposition the tiled Hopper forward of the attention pool rests on
(kernel 3, and 1c-vocab at the pool's site: ``attnpool_fwd_tile_kernel`` in
``csrc/attnpool.cu``), on the CPU; the kernel runs only on the card (see
tests/test_torch_cuda.py).

One 64-atom tile a block, the tiles of a bin a cluster.  Each tile forms the
scores of its atoms with each column's rows summed in five row groups,
added in order; the softmax over molecules that cross tiles from per-tile
partial maxima (the bin's maximum over the ranks) and per-tile partial
denominators (summed over the ranks in rank order); coverage and the pools
as per-tile partials -- the pools one membership product of rnd(x rnd(wbar))
with the tile's one-hot -- summed over the ranks in rank order.

``_pool_fwd_tiles`` renders that schedule in plain PyTorch.  Against
``attnpool_fwd_plain`` and ``attnpool_fwd_vocab_plain`` it holds in fp32 to
rtol 1e-5 (the same fp32 terms summed in another order; tighter than the
fp32 bar) and in bf16 to the bf16 bar, max|d|/max|ref| < 5e-2; against
JAX's ``binned_attnpool_proj_t`` (Pallas in interpret mode) to the fp32
bar, rtol 5e-4 / atol 5e-5.  Bins of 64, 128 and 256 atoms (clusters of 1,
2 and 4): molecules across tile borders, one molecule over three tiles,
padding atoms, empty molecule slots, a tile with no covered atom and a
padding bin; both forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.ops import embed as jax_embed
from aimnet_x2d_tpu.ops.bin_attnpool import binned_attnpool_proj_t as jax_attnpool
from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp, embed
from aimnet_x2d_tpu_torch.utils.activation import get_activation_function

torch.set_num_threads(1)

TILE = 64
GROUPS = 5  # the scores' row groups: 320 threads over 64 columns
RTOL = 1e-5
VOCAB = (11, 5, 7, 3)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("AIMNET_ATTNPOOL_KERNEL", "interpret")
    monkeypatch.setenv("AIMNET_ATTNPOOL_GROUP", "1")  # one bin per interpreted grid step


def _owners(rng, nb, ab, mb):
    """(nb, ab) molecule of each atom, -1 for none.  Bin 0: molecules of
    5-40 atoms along the bin with gaps (across the 64-atom tile borders);
    bin 1: a molecule over atoms 40-179 (three tiles where ab >= 192; two at
    128), small ones after, the rest padding (at ab 256 the last tile holds
    no covered atom); the last bin pads only.  Trailing molecule slots stay
    empty."""
    owner = np.full((nb, ab), -1)
    a = int(rng.integers(0, 3))
    for m in range(mb - 2):
        n = int(rng.integers(5, 41))
        if a + n > ab:
            break
        owner[0, a : a + n] = m
        a += n + int(rng.integers(0, 3))
    if ab >= 128:
        owner[1, :30] = 0
        owner[1, 40 : min(180, ab - 10)] = 1
        owner[1, min(182, ab - 8) : min(190, ab)] = 2
    else:
        owner[1, 3:20], owner[1, 25:60] = 0, 1
    return owner


def _case(ab, seed, dtype=torch.float32, vocab=None):
    rng = np.random.default_rng(seed)
    nb, mb, E, Ds, Do, H = 3, 10, 16, 21, 13, 4
    A = nb * ab
    owner = _owners(rng, nb, ab, mb)
    pm = (owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)
    xo = rng.normal(size=(Do, A)).astype(np.float32)
    kb = rng.uniform(-0.4, 0.4, (E, Ds)).astype(np.float32)
    bb = rng.uniform(-0.2, 0.2, Ds).astype(np.float32)
    ks = rng.uniform(-0.5, 0.5, (Ds, H)).astype(np.float32)
    ko = rng.uniform(-0.5, 0.5, (Do, H)).astype(np.float32)
    sb = rng.uniform(-0.2, 0.2, H).astype(np.float32)
    if vocab is None:
        emb, codes, tables = rng.normal(size=(E, A)).astype(np.float32), None, None
    else:
        codes = np.stack([rng.integers(0, v, A) for v in vocab]).astype(np.int32)
        tables = [(rng.normal(size=(v, E // len(vocab))) * 0.5).astype(np.float32) for v in vocab]
        emb = None
    return dict(emb=emb, codes=codes, tables=tables, xo=xo, pm=pm, kb=kb, bb=bb, ks=ks, ko=ko,
                sb=sb, dtype=dtype, vocab=vocab)


def _torch_operands(c):
    """(emb, xo, pm, weights, codes, vocabulary table) for the port."""
    t = torch.from_numpy
    dt = c["dtype"]
    w = bin_attnpool.prep_weights(t(c["kb"]), t(c["bb"]), t(c["ks"]), t(c["ko"]), t(c["sb"]), dt)
    codes = vt = None
    if c["vocab"] is None:
        emb = t(c["emb"]).to(dt)
    else:
        codes = t(c["codes"])
        vt = embed.prep_vocab(embed.blockdiag_table_t([t(x) for x in c["tables"]]), c["vocab"], dt)
        emb = embed.embed_from_codes(codes, vt)
    return emb, t(c["xo"]).to(dt), t(c["pm"]), w, codes, vt


def _rank_sum(part, C):
    """part (..., C) summed over its last axis in rank order."""
    total = part[..., 0]
    for r in range(1, C):
        total = total + part[..., r]
    return total


def _grouped(k, x):
    """k^T x (fp32) with x's rows in GROUPS ranges of ceil(rows / GROUPS),
    the ranges' sums added in order."""
    n = -(-x.shape[0] // GROUPS)
    total = None
    for g in range(GROUPS):
        part = k[g * n : (g + 1) * n].float().T @ x[g * n : (g + 1) * n].float()
        total = part if total is None else total + part
    return total


def _pool_fwd_tiles(emb, xo, pm, w, act):
    """The forward as the tiled kernel schedules it: returns (ps, po, cov,
    attn) as ``attnpool_fwd_plain`` does."""
    dt = w.dtype
    nb, mb, ab = pm.shape
    C, H, Ds, Do = ab // TILE, w.sb.shape[0], w.Ds, xo.shape[0]
    v = get_activation_function(act)(bin_mp._dot(w.kbT, emb, dt) + w.bb[:, None])[:Ds]
    s = (w.sb[:, None] + _grouped(w.ks, v)) + _grouped(w.ko, xo)  # (H, A) fp32
    own = pm.float().reshape(nb, mb, C, TILE)  # each tile's one-hot
    st = s.reshape(H, nb, C, TILE)
    # each tile's partial max per (head, molecule), the bin's over the ranks
    pmax = torch.where(own[None] > 0, st[:, :, None], torch.tensor(-1e30)).amax(-1)
    gmax = pmax.amax(-1)  # (H, nb, mb): exact in any order
    cover = own.sum(1) > 0  # (nb, C, TILE)
    e = torch.where(cover[None], torch.exp(st - torch.einsum("hbm,bmrc->hbrc", gmax, own)),
                    torch.zeros(()))
    gden = _rank_sum(torch.einsum("hbrc,bmrc->hbmr", e, own), C)
    attn = e / torch.einsum("hbm,bmrc->hbrc", gden, own).clamp(min=1e-16)
    wbar = attn[0]
    for h in range(1, H):
        wbar = wbar + attn[h]
    wbar = wbar / H  # (nb, C, TILE)
    cov = _rank_sum(torch.einsum("brc,bmrc->bmr", wbar, own), C).reshape(-1)

    def pools(x):
        xw = (x.reshape(-1, nb, C, TILE) * wbar.to(dt)[None]).float()  # rounded products
        return _rank_sum(torch.einsum("dbrc,bmrc->dbmr", xw, own), C).reshape(x.shape[0], -1)

    return pools(v), pools(xo), cov, attn.reshape(H, -1)


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


NAMES = ("pooled_self", "pooled_other", "coverage", "attn")


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("ab", [64, 128, 256])
def test_pool_fwd_tiles_give_the_plain_forward(ab, fold):
    c = _case(ab, ab + fold, vocab=VOCAB if fold else None)
    emb, xo, pm, w, codes, vt = _torch_operands(c)
    got = _pool_fwd_tiles(emb, xo, pm, w, "silu")
    want = (bin_attnpool.attnpool_fwd_vocab_plain(codes, xo, pm, w, "silu", vt) if fold
            else bin_attnpool.attnpool_fwd_plain(emb, xo, pm, w, "silu"))
    for a, r, name in zip(got, want, NAMES):
        _close(a, r, name, RTOL, RTOL * float(r.abs().max()))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("ab", [64, 128, 256])
def test_pool_fwd_tiles_in_bf16_give_the_plain_forward(ab, fold):
    c = _case(ab, 3 * ab + fold, torch.bfloat16, VOCAB if fold else None)
    emb, xo, pm, w, codes, vt = _torch_operands(c)
    got = _pool_fwd_tiles(emb, xo, pm, w, "gelu")
    want = (bin_attnpool.attnpool_fwd_vocab_plain(codes, xo, pm, w, "gelu", vt) if fold
            else bin_attnpool.attnpool_fwd_plain(emb, xo, pm, w, "gelu"))
    for a, r, name in zip(got, want, NAMES):
        err = float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        assert err < 5e-2, (name, err)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("ab", [64, 128, 256])
def test_pool_fwd_tiles_give_jax_forward(ab, fold):
    c = _case(ab, 5 * ab + fold, vocab=VOCAB if fold else None)
    emb, xo, pm, w, _, _ = _torch_operands(c)
    got = _pool_fwd_tiles(emb, xo, pm, w, "silu")
    j = jnp.asarray
    weights = (j(c["kb"]), j(c["bb"]), "silu", j(c["xo"]), j(c["pm"]), j(c["ks"]), j(c["ko"]),
               j(c["sb"]))
    if fold:
        spec = (j(c["codes"]), jax_embed.blockdiag_table_t([j(x) for x in c["tables"]]), VOCAB)
        ref = jax_attnpool(None, *weights, interpret=True, embed_spec=spec)
    else:
        ref = jax_attnpool(j(c["emb"]), *weights, interpret=True)
    for a, r, name in zip(got, ref, NAMES):
        _close(a, r, name, 5e-4, 5e-5)


def test_cases_hold_what_the_tiles_must_meet():
    """The bins above hold each case the tile kernel's cluster meets."""
    for ab in (128, 256):
        owner = _owners(np.random.default_rng(ab), 3, ab, 10)
        tiles = lambda b, m: {int(a) // TILE for a in np.flatnonzero(owner[b] == m)}  # noqa: E731
        spans = [len(tiles(b, m)) for b in range(3) for m in range(10)]
        assert max(spans) == min(3, ab // TILE)  # a molecule over three tiles (two at 128)
        assert (owner[-1] < 0).all() and (owner < 0).any(1).all()  # padding
        assert len(set(owner[0][owner[0] >= 0])) < 10  # an empty molecule slot
    assert (_owners(np.random.default_rng(0), 3, 256, 10)[1, 192:] < 0).all()  # an empty tile


@pytest.mark.parametrize("shape", [(368, 256), (32, 32), (176, 48)])
def test_pool_stream_head_holds_kbT_for_the_forward(shape):
    """The tiled forward reads the head of the backward's stream: kb^T's
    row blocks, each 32-column stage padded to 160 rows' worth, and the
    stream's layout puts them first."""
    Dsp, E = shape
    full = bin_attnpool.pool_stream_index(Dsp, E)
    pos = np.arange(Dsp * E).reshape(Dsp, E)
    stages = -(-E // 32)
    head = []
    for r0 in range(0, Dsp, 160):
        R = min(160, Dsp - r0)
        st = bin_mp.frag_stream(pos[r0 : r0 + R], Dsp * E).reshape(stages, R * 32)
        head.append(np.concatenate([st, np.full((stages, (160 - R) * 32), Dsp * E)], 1))
    head = np.concatenate(head).reshape(-1)
    n = head.size
    assert n == -(-Dsp // 160) * stages * 160 * 32 < full.size
    np.testing.assert_array_equal(full[:n], head)
    # every element of kb^T once in the head, and the rest is kb's blocks
    assert np.array_equal(np.sort(full[:n][full[:n] < Dsp * E]), np.arange(Dsp * E))
    assert np.array_equal(np.sort(full[n:][full[n:] < Dsp * E]), np.arange(Dsp * E))
