"""The schedules the Hopper kernels 7 and 8 (``csrc/fused_edge.cu``) rest
on, on the CPU; the kernels run only on the card (see
tests/test_torch_cuda.py).

Kernel 7 (``edge_agg_kernel``) takes a tile of ``TILE_ROWS`` destination
rows a block.  The layout lists each tile's source rows as intervals of
whole 8-row groups and gives every edge the row of its source in the tile's
shared-memory image (``ops/fused_edge.py::tile_intervals``).  Held here, on
the card fixture's batch (a 596-atom alkane, a branched 485-atom alkane,
small molecules and padding rows with no edges) and on random edges: every
real edge's source lies in one of its tile's intervals and its image row
reads it back, the intervals of a tile do not overlap in the image and
start on groups, and a launch whose largest image exceeds the budget takes
the direct route (the fixture takes both, by width).  ``_render_agg``
renders the kernel: the images staged (rounded to bf16 on the way where the
kernel rounds) or x read directly, each row summed from zero in CSR order
in fp32.  Both routes give the same bits, and the rendering holds to
``fused_edge_plain`` (fp32 rtol 1e-6) and to JAX's ``fused_edge_aggregate``
in interpret mode, forward and backward (rtol 5e-4 / atol 5e-5).

Kernel 8 (``wseg_sum_kernel``): a block takes a window and a part of its
segments, sorts the window's slots by segment in shared memory (a stable
counting sort: each warp counts, then places, a contiguous range of slots
after the ranges before it) and sums each segment's rows from zero in that
order; padding slots fall out of the sort, segments no slot names are
zeros.  ``_render_wseg`` renders that schedule; on sorted ids, unsorted
ids, padding slots in the middle of a window and empty windows it is the
sequential sum in slot order, bit for bit, and holds to
``windowed_segment_sum_plain`` (rtol 1e-6) and to JAX's
``pallas_windowed_segment_sum`` in interpret mode (rtol 5e-4 / atol 5e-5).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.ops.fused_edge import build_layouts as jax_build_layouts
from aimnet_x2d_tpu.ops.fused_edge import fused_edge_aggregate as jax_fused
from aimnet_x2d_tpu.ops.pallas_segment import pallas_windowed_segment_sum as jax_wseg
from aimnet_x2d_tpu_torch.ops import fused_edge
from aimnet_x2d_tpu_torch.ops.fused_edge import (
    GROUP,
    TILE_ROWS,
    build_layouts,
    fused_edge_plain,
    stage_plan,
    tile_intervals,
)
from aimnet_x2d_tpu_torch.ops.pallas_segment import windowed_layout, windowed_segment_sum_plain

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def card_batch():
    """The card tests' flat batch (tests/test_torch_cuda.py): a 596-atom
    alkane, a branched 485-atom alkane (rows of up to 28 edges), small
    molecules, and padding atom slots with no edges."""
    from aimnet_x2d_tpu_torch.chem import compute_features
    from aimnet_x2d_tpu_torch.data.batching import collate

    smiles = ["C" * 198, "CC(C)(C)" * 40 + "C", "CCO", "c1ccccc1O", "C[C@H](N)C(=O)O"] * 2
    feats = [compute_features(s, 3) for s in smiles]
    b = collate(feats, np.zeros((len(feats), 1), np.float32), num_hops=3, atom_slots=2400)
    return b.edge_src, b.edge_dst, b.edge_mask, b.num_atom_slots


def _random_edges(seed, A=640, E=900):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, A, E).astype(np.int32), rng.integers(0, A, E).astype(np.int32),
            rng.random(E) < 0.9, A)


def _image_sources(lay, t):
    """The source row of each row of tile t's image (-1: a row no interval
    fills)."""
    img = np.full(int(lay.image_rows[t]), -1, np.int64)
    for a, n, base in lay.iv[lay.tile_iv[t]:lay.tile_iv[t + 1]]:
        assert a % GROUP == 0 and n % GROUP == 0 and base % GROUP == 0 and n > 0
        assert (img[base:base + n] == -1).all(), "two intervals share image rows"
        img[base:base + n] = np.arange(a, a + n)
    return img


def _tiles(lay, tile_rows):
    """The layout's CSR with tiles of ``tile_rows`` rows (the layout's own
    at TILE_ROWS)."""
    if tile_rows == TILE_ROWS:
        return lay
    lay = SimpleNamespace(row_ptr=lay.row_ptr, col=lay.col)
    lay.col_local, lay.tile_iv, lay.iv, lay.image_rows, lay.tile_edges = tile_intervals(
        lay.row_ptr, lay.col, tile_rows)
    return lay


@pytest.mark.parametrize("tile_rows", [16, 32, 64])
@pytest.mark.parametrize("case", ["card", "random"])
def test_tiles_hold_every_source_once(card_batch, case, tile_rows):
    """Each real edge's source lies in its tile's intervals and its image
    row reads it back, in both directions; tiles without edges have no
    image; the image rows are what the kernel computes from iv."""
    edges = card_batch if case == "card" else _random_edges(5)
    A = edges[3]
    for lay in (_tiles(lay, tile_rows) for lay in build_layouts(*edges)):
        tiles = -(-A // tile_rows)
        assert lay.image_rows.shape == (tiles,)
        assert lay.tile_iv.shape == (tiles + 1,) and lay.tile_iv[0] == 0
        assert lay.tile_iv[-1] == lay.iv.shape[0] and np.all(np.diff(lay.tile_iv) >= 0)
        for arr in (lay.col_local, lay.tile_iv, lay.iv):
            assert arr.dtype == np.int32
        for t in range(tiles):
            e0, e1 = lay.row_ptr[min(t * tile_rows, A)], lay.row_ptr[min(t * tile_rows + tile_rows, A)]
            img = _image_sources(lay, t)
            assert lay.tile_edges[t] == e1 - e0
            if e0 == e1:
                assert lay.image_rows[t] == 0 and lay.tile_iv[t] == lay.tile_iv[t + 1]
                continue
            last = lay.iv[lay.tile_iv[t + 1] - 1]
            assert lay.image_rows[t] == last[2] + last[1]
            np.testing.assert_array_equal(img[lay.col_local[e0:e1]], lay.col[e0:e1])


def test_card_batch_tiles_stay_near_their_rows(card_batch):
    """The large molecules' tiles read their carbons and their hydrogens in
    a few intervals, not the whole molecule's span: at most 3 intervals a
    tile, and images at most 4 times a tile's rows in the forward layout."""
    fwd, _ = build_layouts(*card_batch)
    n_iv = np.diff(fwd.tile_iv)
    span = np.zeros(len(n_iv), np.int64)
    for t in np.flatnonzero(n_iv):
        iv = fwd.iv[fwd.tile_iv[t]:fwd.tile_iv[t + 1]]
        span[t] = iv[-1, 0] + iv[-1, 1] - iv[0, 0]
    print(f"intervals a tile max {n_iv.max()}, image rows max {fwd.image_rows.max()}, "
          f"span of the first to the last source row max {span.max()}")
    assert n_iv.max() <= 3 and fwd.image_rows.max() <= 4 * TILE_ROWS
    assert span.max() > 8 * TILE_ROWS  # the intervals skip what one span would stage


def _rounded(x, stage_bf16):
    return torch.from_numpy(x).bfloat16().float().numpy() if stage_bf16 else x


def _render_agg(x, lay, exact, span):
    """Kernel 7 in numpy.  The span route (``span``): each tile stages its
    intervals of x into its image (rounded to bf16 as they are staged unless
    exact) and sums its rows from the image; the direct route: each row
    gathers x's rows (rounded as they are read).  Each row from zero, its
    edges in CSR order, fp32."""
    A, D = x.shape
    xr = _rounded(x, not exact)
    out = np.zeros((A, D), np.float32)
    for t in range(len(lay.image_rows)):
        if span:
            src, idx = np.zeros((int(lay.image_rows[t]), D), np.float32), lay.col_local
            for a, n, base in lay.iv[lay.tile_iv[t]:lay.tile_iv[t + 1]]:
                m = min(n, A - a)
                src[base:base + m] = xr[a:a + m]
        else:
            src, idx = xr, lay.col
        for a in range(t * TILE_ROWS, min(t * TILE_ROWS + TILE_ROWS, A)):
            acc = np.zeros(D, np.float32)
            for e in range(lay.row_ptr[a], lay.row_ptr[a + 1]):
                acc += src[idx[e]]
            out[a] = acc
    return out


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("D", [24, 359])
def test_both_routes_give_the_plain_sum(card_batch, D, exact, monkeypatch):
    """The route of a launch: the span route when every tile's image fits
    the budget (bytes of the largest image a block), else the direct route
    (-1); on the card fixture D 24 stages and fp32 D 359 gathers, and a
    budget below the largest image sends the launch direct.  Both routes
    give the same bits, and those of the plain version."""
    rng = np.random.default_rng(D)
    fwd, bwd = build_layouts(*card_batch)
    A = card_batch[3]
    x = rng.normal(size=(A, D)).astype(np.float32)
    esz = 4 if exact else 2
    for lay in (fwd, bwd):
        largest = int(lay.image_rows.max()) * D * esz
        plan = stage_plan(lay, D, esz)
        assert plan == (largest if largest <= fused_edge.STAGE_BUDGET else -1)
        if D == 24:
            assert plan == largest
        if D == 359 and exact:
            assert plan == -1
        with monkeypatch.context() as m:
            m.setattr(fused_edge, "STAGE_BUDGET", largest - 1)
            assert stage_plan(lay, D, esz) == -1
            m.setattr(fused_edge, "STAGE_BUDGET", largest)
            assert stage_plan(lay, D, esz) == largest
        span = _render_agg(x, lay, exact, True)
        np.testing.assert_array_equal(span, _render_agg(x, lay, exact, False))
        ref = fused_edge_plain(torch.from_numpy(x), lay.to("cpu"), exact).numpy()
        np.testing.assert_allclose(span, ref, rtol=1e-6, atol=1e-6)
        pad = np.diff(lay.row_ptr) == 0
        assert pad.any() and not span[pad].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rendering_gives_the_jax_aggregation(card_batch, dtype):
    """The rendered schedule, forward and backward (the cotangent rounded to
    bf16 where the model is bf16), against JAX's op in interpret mode."""
    import jax

    src, dst, mask, A = card_batch
    D = 16
    rng = np.random.default_rng(7)
    exact = dtype == "float32"
    x = rng.normal(size=(A, D)).astype(np.float32)
    x = _rounded(x, not exact)  # a bf16 model's x is bf16 already
    g = rng.normal(size=(A, D)).astype(np.float32)
    jf, jb = jax_build_layouts(src, dst, mask, A, window=128, chunk=128)
    jdt = jnp.float32 if exact else jnp.bfloat16
    out_ref, vjp = jax.vjp(lambda y: jax_fused(y, jf, jb, exact=exact, interpret=True),
                           jnp.asarray(x).astype(jdt))
    (dx_ref,) = vjp(jnp.asarray(g))
    fwd, bwd = build_layouts(src, dst, mask, A)
    out = _render_agg(x, fwd, exact, stage_plan(fwd, D, 4 if exact else 2) >= 0)
    dx = _render_agg(g, bwd, exact, stage_plan(bwd, D, 4 if exact else 2) >= 0)
    np.testing.assert_allclose(out, np.asarray(out_ref), rtol=5e-4, atol=5e-5)
    dx_ref = np.asarray(dx_ref.astype(jnp.float32))
    if exact:
        np.testing.assert_allclose(dx, dx_ref, rtol=5e-4, atol=5e-5)
    else:  # dx is cast to bf16 after the sum: one bf16 step at most
        dxr = _rounded(dx, True)
        assert (np.abs(dxr - dx_ref) <= np.abs(dx_ref) * 2.0**-7 + 1e-30).all()


def test_layout_keeps_its_image_rows_on_the_host():
    fwd, _ = build_layouts(*_random_edges(6))
    moved = fwd.to("cpu")
    assert isinstance(moved.image_rows, np.ndarray)
    assert isinstance(moved.tile_edges, np.ndarray) and moved.tile_edges.sum() == fwd.num_edges
    assert all(isinstance(a, torch.Tensor) for a in (moved.col_local, moved.tile_iv, moved.iv))
    empty = build_layouts(np.zeros(3, np.int32), np.zeros(3, np.int32), np.zeros(3, bool), 50)[0]
    assert empty.iv.shape == (0, 3) and not empty.image_rows.any()
    assert stage_plan(empty, 153, 2) == 0


# ---- kernel 8 ------------------------------------------------------------ #

def _render_wseg(data, seg, W, cap, window, exact, parts=5, warps=8):
    """Kernel 8 in numpy: per window and part of its segments, a stable
    counting sort of the slots by segment (each of ``warps`` contiguous
    ranges of slots counted, then placed after the ranges before it), then
    each segment's rows summed from zero in the sorted order, fp32; a
    segment no slot names is zero."""
    d = _rounded(data, not exact)
    out = np.zeros((W * window, data.shape[1]), np.float32)
    per = -(-window // parts)
    span = -(-cap // warps)
    for w in range(W):
        ids = seg[w * cap:(w + 1) * cap]
        for s0 in range(0, window, per):
            key = np.where((ids >= s0) & (ids < min(s0 + per, window)), ids - s0, -1)
            counts = np.zeros((warps, per), np.int64)
            for v in range(warps):
                for k in key[v * span:(v + 1) * span]:
                    if k >= 0:
                        counts[v, k] += 1
            start = np.concatenate([[0], np.cumsum(counts.sum(0))])
            cursor = start[:-1] + np.cumsum(counts, 0) - counts  # the ranges before each
            slots = np.zeros(start[-1], np.int64)
            for v in range(warps):
                for i in range(v * span, min((v + 1) * span, cap)):
                    if key[i] >= 0:
                        slots[cursor[v, key[i]]] = i
                        cursor[v, key[i]] += 1
            for k in range(min(per, window - s0)):
                acc = np.zeros(data.shape[1], np.float32)
                for i in slots[start[k]:start[k + 1]]:
                    acc += d[w * cap + i]
                out[w * window + s0 + k] = acc
    return out


def _wseg_case(card_batch, order, window=64):
    """(src_perm, seg_local, W, cap) of the card batch's edges: sorted (the
    windowed layout), shuffled within each window (unsorted ids, padding in
    the middle), or with padding slots inserted mid-window."""
    src, dst, mask, A = card_batch
    src_perm, seg_local, W, cap = windowed_layout(src, dst, mask, A, window=window, chunk=32)
    rng = np.random.default_rng(11)
    if order == "shuffled":
        for w in range(W):
            p = rng.permutation(cap) + w * cap
            src_perm[w * cap:(w + 1) * cap] = src_perm[p]
            seg_local[w * cap:(w + 1) * cap] = seg_local[p]
    elif order == "padding inside":
        for w in range(W):
            sl = seg_local[w * cap:(w + 1) * cap]
            n = int((sl < window).sum())
            if 8 < n <= cap - 3:  # three padding slots among a run, the rest shifted back
                cut = [n // 3, n // 2, n // 2 + 1]
                keep = np.delete(np.arange(cap), [cap - 3, cap - 2, cap - 1])
                order_ = np.insert(keep, cut, [cap - 3, cap - 2, cap - 1])
                src_perm[w * cap:(w + 1) * cap] = src_perm[w * cap + order_]
                seg_local[w * cap:(w + 1) * cap] = sl[order_]
    return src_perm, seg_local, W, cap


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("order", ["sorted", "shuffled", "padding inside"])
def test_wseg_rendering_gives_the_plain_sum(card_batch, order, exact):
    src_perm, seg_local, W, cap = _wseg_case(card_batch, order)
    window, A, D = 64, card_batch[3], 40
    assert (seg_local.reshape(W, cap) == window).all(1).any()  # an empty window
    if order != "sorted":
        assert any((np.diff(np.flatnonzero(s < window)) > 1).any()
                   for s in seg_local.reshape(W, cap))  # padding between real slots
    x = np.random.default_rng(3).normal(size=(A, D)).astype(np.float32)
    data = np.where((seg_local < window)[:, None], x[src_perm], 0).astype(np.float32)
    got = _render_wseg(data, seg_local, W, cap, window, exact)
    ref = windowed_segment_sum_plain(torch.from_numpy(data), torch.from_numpy(seg_local), W,
                                     cap, window, exact).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # every order: the sequential sum in slot order, bit for bit
    seq = np.zeros_like(got)
    d = _rounded(data, not exact)
    for i, s in enumerate(seg_local):
        if s < window:
            seq[i // cap * window + s] += d[i]
    np.testing.assert_array_equal(got, seq)
    if exact:
        want = jax_wseg(jnp.asarray(x), jnp.asarray(src_perm), jnp.asarray(seg_local), A, W, cap,
                        window=window, chunk=32, exact=True, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4, atol=5e-5)


def test_wseg_rendering_folds_repeated_segments():
    """A segment in three runs, a segment no slot names, padding anywhere:
    each segment's slots in slot order, summed from zero."""
    data = np.arange(24, dtype=np.float32).reshape(8, 3) + 0.25
    seg = np.array([2, 2, 4, 0, 2, 4, 0, 2], np.int32)  # window 4: 4 = padding
    got = _render_wseg(data, seg, 1, 8, 4, True)
    want = np.zeros((4, 3), np.float32)
    want[2] = ((data[0] + data[1]) + data[4]) + data[7]
    want[0] = data[3] + data[6]
    np.testing.assert_array_equal(got, want)
    ref = windowed_segment_sum_plain(torch.from_numpy(data), torch.from_numpy(seg), 1, 8, 4, True)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-6)
