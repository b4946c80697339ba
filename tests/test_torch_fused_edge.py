"""The flat layout's operators against the JAX package, on the CPU:

- the edge layouts of kernel 7 (``ops/fused_edge.py``): every real edge
  appears exactly once in each direction, each row in the input order;
- kernel 7's plain version (forward, and dx through the autograd Function)
  against ``fused_edge_aggregate(interpret=True)`` and ``jax.vjp``, fp32
  (``exact=True``) and bf16; the bf16 backward must round the fp32
  cotangent to bf16 as the TPU kernel does, and the check is shown to catch
  a backward that does not;
- kernel 8's plain version (``ops/pallas_segment.py``) against
  ``pallas_windowed_segment_sum(interpret=True)`` with ``exact=True``, and
  with ``exact=False`` against a numpy reference that rounds the data to
  bf16 (the JAX CPU interpreter does not round);
- the segment reductions (``ops/segment.py``) against the JAX ones.

Bars: fp32 rtol 5e-4 / atol 5e-5 (tests/test_parity.py); the bf16
aggregation sums the same rounded operands in fp32 on both sides, so its
results agree to fp32 reassociation and at most 1% of the bf16 values may
differ, by one bf16 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.ops import segment as jseg
from aimnet_x2d_tpu.ops.fused_edge import build_layouts as jax_build_layouts
from aimnet_x2d_tpu.ops.fused_edge import fused_edge_aggregate as jax_fused
from aimnet_x2d_tpu.ops.pallas_segment import pallas_windowed_segment_sum as jax_wseg
from aimnet_x2d_tpu.ops.pallas_segment import windowed_layout as jax_windowed_layout
from aimnet_x2d_tpu_torch.ops import segment
from aimnet_x2d_tpu_torch.ops.fused_edge import (
    build_layouts,
    fused_edge_aggregate,
    fused_edge_plain,
)
from aimnet_x2d_tpu_torch.ops.pallas_segment import (
    pallas_windowed_segment_sum,
    windowed_layout,
    windowed_segment_sum_plain,
)

torch.set_num_threads(1)


def _edges(seed, A=640, E=900):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, A, E).astype(np.int32)
    dst = rng.integers(0, A, E).astype(np.int32)
    mask = rng.random(E) < 0.9
    return rng, src, dst, mask


def _check(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    print(f"{what}: max|d| {err:.2e}, max|d|/max|ref| {err / np.abs(ref).max():.2e}")
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=what)


def _bf16_agree(got, ref, what):
    """bf16 arrays (as fp32) that differ in at most 1% of their values, by
    at most one bf16 step; returns the fraction that differ."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    diff = got != ref
    step = np.abs(ref) * 2.0**-7 + 1e-30
    frac = float(diff.mean())
    print(f"{what}: {frac:.2%} of the values differ, max|d|/max|ref| "
          f"{np.abs(got - ref).max() / np.abs(ref).max():.2e}")
    return frac <= 0.01 and bool((np.abs(got - ref) <= step).all())


def test_layouts_hold_every_real_edge_once_in_each_direction():
    A = 640
    _, src, dst, mask = _edges(0, A)
    fwd, bwd = build_layouts(src, dst, mask, A)
    for lay, key, other in ((fwd, dst, src), (bwd, src, dst)):
        assert lay.row_ptr.dtype == np.int32 and lay.col.dtype == np.int32
        assert lay.row_ptr.shape == (A + 1,) and lay.row_ptr[0] == 0
        assert np.all(np.diff(lay.row_ptr) >= 0) and lay.row_ptr[-1] == mask.sum()
        rows = np.repeat(np.arange(A), np.diff(lay.row_ptr))
        got = sorted(zip(rows.tolist(), lay.col.tolist()))
        assert got == sorted(zip(key[mask].tolist(), other[mask].tolist()))
        # each row keeps the edges' input order
        for a in (0, 17, 333):
            want = other[mask][key[mask] == a]
            np.testing.assert_array_equal(lay.col[lay.row_ptr[a] : lay.row_ptr[a + 1]], want)
    with pytest.raises(ValueError, match="outside"):
        build_layouts(src, dst, mask, A - 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_forward_and_vjp(dtype):
    """Random edges (A 640, E 900, about 10% masked), D 48."""
    A, D = 640, 48
    rng, src, dst, mask = _edges(1, A)
    exact = dtype == "float32"
    jdt = jnp.float32 if exact else jnp.bfloat16
    x = jnp.asarray(rng.normal(size=(A, D)).astype(np.float32)).astype(jdt)
    g = rng.normal(size=(A, D)).astype(np.float32)
    jf, jb = jax_build_layouts(src, dst, mask, A, window=128, chunk=128)
    out_ref, vjp = jax.vjp(lambda y: jax_fused(y, jf, jb, exact=exact, interpret=True), x)
    (dx_ref,) = vjp(jnp.asarray(g))

    fwd, bwd = (lay.to("cpu") for lay in build_layouts(src, dst, mask, A))
    tdt = torch.float32 if exact else torch.bfloat16
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(tdt).requires_grad_(True)
    out = fused_edge_aggregate(xt, fwd, bwd, exact=exact)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(g))
    assert xt.grad.dtype == tdt
    dx_ref = np.asarray(dx_ref.astype(jnp.float32))
    _check(out.detach(), np.asarray(out_ref), f"forward {dtype}")
    if exact:
        _check(xt.grad, dx_ref, "dx float32")
        return
    assert _bf16_agree(xt.grad.float(), dx_ref, "dx bfloat16")
    # a backward that sums the fp32 cotangent without rounding it fails
    unrounded = fused_edge_plain(torch.from_numpy(g), bwd, exact=True).to(tdt).float()
    assert not _bf16_agree(unrounded, dx_ref, "dx bfloat16, cotangent not rounded")


def test_plain_handles_empty_rows_and_no_edges():
    A, D = 7, 5
    x = torch.arange(A * D, dtype=torch.float32).reshape(A, D)
    fwd, bwd = (lay.to("cpu") for lay in build_layouts(
        np.array([0, 1, 1], np.int32), np.array([2, 2, 6], np.int32), np.array([1, 1, 0], bool), A))
    out = fused_edge_plain(x, fwd, exact=True)
    torch.testing.assert_close(out[2], x[0] + x[1])
    assert out[[0, 1, 3, 4, 5, 6]].abs().sum() == 0  # zero in-degree rows, the masked edge
    none = build_layouts(np.zeros(3, np.int32), np.zeros(3, np.int32), np.zeros(3, bool), A)[0]
    assert fused_edge_plain(x, none.to("cpu"), exact=False).abs().sum() == 0


def test_windowed_layout_matches_jax():
    A = 300
    _, src, dst, mask = _edges(2, A, 1200)
    got = windowed_layout(src, dst, mask, A, window=64, chunk=32)
    want = jax_windowed_layout(src, dst, mask, A, window=64, chunk=32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exact", [True, False])
def test_windowed_segment_sum_plain_matches_jax(exact):
    A, D, window, chunk = 300, 96, 64, 32
    rng, src, dst, mask = _edges(3, A, 1200)
    x = rng.normal(size=(A, D)).astype(np.float32)
    src_perm, seg_local, W, cap = windowed_layout(src, dst, mask, A, window=window, chunk=chunk)
    got = pallas_windowed_segment_sum(torch.from_numpy(x), torch.from_numpy(src_perm),
                                      torch.from_numpy(seg_local), A, W, cap, window=window,
                                      chunk=chunk, exact=exact)
    assert got.shape == (W * window, D) and got.dtype == torch.float32
    if exact:
        want = jax_wseg(jnp.asarray(x), jnp.asarray(src_perm), jnp.asarray(seg_local), A, W, cap,
                        window=window, chunk=chunk, exact=True, interpret=True)
        _check(got, np.asarray(want), "windowed segment sum, exact")
        return
    # the data operand rounded to bf16, then summed (float64 here)
    xr = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    want = np.zeros((W * window, D))
    np.add.at(want, dst[mask], xr[src[mask]])
    _check(got, want, "windowed segment sum, data rounded to bf16")
    # the rounding is there: the sum of the unrounded data is another array
    unrounded = np.zeros((W * window, D))
    np.add.at(unrounded, dst[mask], x[src[mask]].astype(np.float64))
    assert np.abs(got.numpy() - unrounded).max() > 1e-3


def test_windowed_segment_sum_drops_padding_slots():
    data = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    seg = torch.tensor([0, 2, 4, 1, 4, 1], dtype=torch.int32)  # window 4: 4 = padding
    out = windowed_segment_sum_plain(data, seg, num_windows=2, cap=3, window=4, exact=True)
    want = torch.zeros(8, 2)
    want[0], want[2] = data[0], data[1]
    want[5] = data[3] + data[5]
    torch.testing.assert_close(out, want)


def test_segment_ops_match_jax():
    rng = np.random.default_rng(4)
    N, B, D, H = 40, 6, 5, 3
    ids = rng.integers(0, B, N).astype(np.int32)
    ids[:4] = B  # padding rows: dropped
    ids[4:6] = 4  # segment 5 stays empty
    ids[ids == 5] = 4
    mask = ids < B
    x = rng.normal(size=(N, D)).astype(np.float32)
    x[10] = x[11] = 9.0  # a tie at the segment's max in every column
    ids[11] = ids[10]
    tx, tids = torch.from_numpy(x), torch.from_numpy(ids)
    for name in ("segment_sum", "segment_mean", "segment_max"):
        got = getattr(segment, name)(tx, tids, B)
        want = getattr(jseg, name)(jnp.asarray(x), jnp.asarray(ids), B)
        _check(got, np.asarray(want), name)
    scores = rng.normal(size=(H, N)).astype(np.float32)
    got = segment.segment_softmax(torch.from_numpy(scores), tids, B, mask=torch.from_numpy(mask))
    want = jseg.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), B, mask=jnp.asarray(mask))
    _check(got, np.asarray(want), "segment_softmax")
    assert float(got[:, ~mask].abs().max()) == 0.0
    # gradients: the max's tie splits evenly, as JAX's segment_max does
    g = rng.normal(size=(B, D)).astype(np.float32)
    xt = tx.clone().requires_grad_(True)
    segment.segment_max(xt, tids, B).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda y: jseg.segment_max(y, jnp.asarray(ids), B), jnp.asarray(x))
    _check(xt.grad, np.asarray(vjp(jnp.asarray(g))[0]), "segment_max grad")
    st = torch.from_numpy(scores).requires_grad_(True)
    gs = rng.normal(size=(H, N)).astype(np.float32)
    segment.segment_softmax(st, tids, B, mask=torch.from_numpy(mask)).backward(torch.from_numpy(gs))
    _, vjp = jax.vjp(lambda s: jseg.segment_softmax(s, jnp.asarray(ids), B, mask=jnp.asarray(mask)),
                     jnp.asarray(scores))
    _check(st.grad, np.asarray(vjp(jnp.asarray(gs))[0]), "segment_softmax grad")
