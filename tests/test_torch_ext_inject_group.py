"""Kernel 5's and kernel 4's weight gradients through the grouped
contraction, and the weight streams their Hopper kernels read, on the CPU
(the kernels run only on the card: see tests/test_torch_cuda.py).

- Kernel 5 (the halo layer): the contraction's plain version, fed the work
  slabs formed from ``mp_ext_bwd_plain``'s own operands (``ext_slabs_plain``,
  the walk's slab form and the slab kernel's, which keeps t and u_i after
  them) through the product mapping the CUDA wrapper uses
  (``layer_products``), gives its weight and bias gradients: fp32, rtol 1e-6
  (the same products of the same operands).
- Kernel 4 (the config-3 inject): the product (dpre, xct, g32), alone and
  grouped after the layer's products as the CUDA wrapper launches them,
  gives ``inject_layer_bwd``'s d_kb and d_b (and the layer's grads).
- The streams: ``walk_weights`` of a one-layer ``StackWeights`` holds the
  matrices kernel 5's walk multiplies by, in use order, where its fragment
  loads read them; ``kb_stream`` holds kb's three parts the same way.
"""

import numpy as np
import pytest
import torch

from aimnet_x2d_tpu_torch.ops import bin_inject, bin_mp
from test_torch_stack_bwd_group import _read_fragments, _weights

RTOL = 1e-6


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=RTOL * float(
        want.abs().max()), err_msg=what)


def _ext_case(seed, D, n_blocks, A=128):
    rng = np.random.default_rng(seed)
    sw = bin_mp.stack_weights(_weights(rng, D, n_blocks, 1), torch.float32)
    xa = torch.from_numpy(rng.normal(size=(2 * D, A)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(D, A)).astype(np.float32))
    return sw, xa, g


@pytest.mark.parametrize("layout", ["walk", "legacy"])
@pytest.mark.parametrize("rate", [0.0, 0.05])
@pytest.mark.parametrize("n_blocks", [1, 2, 3])
@pytest.mark.parametrize("D", [19, 153])
def test_ext_products_give_the_plain_backward_grads(D, n_blocks, rate, layout):
    sw, xa, g = _ext_case(D + n_blocks, D, n_blocks)
    spec = bin_mp.StackSpec("silu", rate, 0x5EED5, 1)
    _, want = bin_mp.mp_ext_bwd_plain(xa, sw, spec, g)
    wk = bin_mp.ext_slabs_plain(xa, sw, spec, g, legacy=layout == "legacy")
    k = bin_mp.bwd_slabs(n_blocks)
    assert wk.shape[0] == k["n"] + (1 + n_blocks if layout == "legacy" else 0)
    prods = bin_mp.layer_products(wk, n_blocks)
    assert len(prods) == 2 + 2 * n_blocks
    got = [t for pair in bin_mp.wgrad_group_plain(prods) for t in pair]
    assert len(got) == len(want)
    for i, (a, r) in enumerate(zip(got, want)):
        _close(a, r, f"grad {i}")


def _c3_round(seed, D, dt):
    """A small config-3 round on the CPU: two bins of 128 atoms, molecules
    of 5-11 atoms, a tetrahedral centre in most of them."""
    rng = np.random.default_rng(seed)
    nb, ab, mb, tc = 2, 128, 16, 12
    A = nb * ab
    owner = np.full((nb, ab), -1)
    tet = np.full((nb, 4, tc), -1, np.int32)
    for b in range(nb):
        a = t = 0
        for m in range(mb):
            n = int(rng.integers(5, 12))
            if a + n > ab:
                break
            owner[b, a : a + n] = m
            if t < tc and rng.random() < 0.7:
                tet[b, :, t] = a + rng.choice(n, 4, replace=False)
                t += 1
            a += n
    adj = lambda vals: (rng.random((nb, ab, ab)) < 6.0 / ab) * rng.choice(vals, (nb, ab, ab))  # noqa: E731
    x = rng.normal(size=(D, A)).astype(np.float32)
    x[1] = np.abs(x[1]) + 0.05
    q = rng.integers(-1, 2, (nb, mb)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    tables = (t(np.where(owner >= 0, q[np.arange(nb)[:, None], np.maximum(owner, 0)], 0)
                .astype(np.float32).reshape(-1)),
              t((owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)), t(tet),
              t(np.array([1.0], np.float32)), t(adj([-1, 1]).astype(np.int8)))
    lws = _weights(rng, D, 2, 1)[0]
    kb = t(rng.uniform(-1, 1, (3 * D, D)).astype(np.float32) / np.sqrt(3 * D))
    b = t(rng.uniform(-1, 1, D).astype(np.float32) / np.sqrt(3 * D))
    iw = bin_inject.prep_inject(kb, b, lws, dt)
    g = t(rng.normal(size=(D, A)).astype(np.float32)).to(dt)
    return t(x).to(dt), tables, t(adj([1, 2]).astype(np.int8)), iw, g


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [13, 40])
def test_inject_product_gives_d_kb_and_d_b(D, dt):
    x, tables, adj, iw, g = _c3_round(D, D, dt)
    spec = bin_mp.StackSpec("silu", 0.05, 0x1234567, 1)
    out, (pre, xct) = bin_inject.inject_layer_fwd(x, *tables, adj, iw, spec, True)
    _, dkbT, db, lg = bin_inject.inject_layer_bwd(x, *tables, adj, iw, spec, (pre, xct), g)
    g32, lg_ref = bin_mp.mp_layer_bwd_plain(pre, adj, iw.sw, spec, g)
    dpre = g32.to(dt)
    ((a_kb, a_b),) = bin_mp.wgrad_group_plain([(dpre, xct, g32)])
    _close(a_kb, dkbT, "d_kb alone")
    _close(a_b, db, "d_b alone")
    # grouped after the layer's products, as the card's one launch holds them
    wk = bin_mp.bwd_slabs_plain(bin_mp._pad_rows(pre, iw.sw.Dp), adj, iw.sw.layers[0], spec,
                                iw.sw.n_blocks, 0, bin_mp._pad_rows(g.float(), iw.sw.Dp))
    prods = bin_mp.layer_products(wk, iw.sw.n_blocks) + [(dpre, xct, g32)]
    got = [t for pair in bin_mp.wgrad_group_plain(prods) for t in pair]
    assert len(got) == len(lg) + 2
    _close(got[-2], dkbT, "d_kb grouped")
    _close(got[-1], db, "d_b grouped")
    for i, (a, r) in enumerate(zip(got[:-2], lg)):
        _close(a, r, f"layer grad {i}")
        _close(a, lg_ref[i], f"layer grad {i} (plain layer backward)")


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_walk_stream_holds_kernel_5s_matrices_in_use_order(n_blocks):
    D = 153
    rng = np.random.default_rng(n_blocks)
    sw = bin_mp.stack_weights(_weights(rng, D, n_blocks, 1), torch.bfloat16)
    Dp = sw.Dp
    stream = bin_mp.walk_weights(sw).float().numpy()
    assert stream.size == bin_mp.walk_stream_elems(Dp, n_blocks)
    ws = [w.float().numpy() for w in sw.layers[0]]
    w_in, b_in, w_s = ws[0], ws[1], ws[2]
    blocks = [ws[4 + 4 * i : 8 + 4 * i] for i in range(n_blocks)]
    # kernel 5's walk: the recompute (W_in, W1_0, W2_0, ..., W1_{n-1}), the
    # walk back (W2_i^T, W1_i^T from the last block), then dxa's agg half and
    # x half, both rows of [W_s^T | W_in^T] (ext_bwd_kernel's products)
    mats = [w_in]
    for i in range(n_blocks):
        mats += [blocks[i][0]] + ([blocks[i][2]] if i + 1 < n_blocks else [])
    for i in reversed(range(n_blocks)):
        mats += [blocks[i][2].T, blocks[i][0].T]
    wt = np.concatenate([w_s.T, w_in.T], 1)
    mats += [wt[Dp:], wt[:Dp]]
    rest = stream
    for j, m in enumerate(mats):
        got, rest = _read_fragments(rest, Dp, m.shape[1])
        np.testing.assert_array_equal(got, m, err_msg=f"matrix {j}")
    biases = [b_in] + [b for blk in blocks for b in (blk[1], blk[3])]
    np.testing.assert_array_equal(rest, np.concatenate(biases))


@pytest.mark.parametrize("D", [13, 153])
def test_kb_stream_holds_kb_parts_in_fragment_order(D):
    rng = np.random.default_rng(D)
    kb = torch.from_numpy(rng.uniform(-1, 1, (3 * D, D)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-1, 1, D).astype(np.float32))
    iw = bin_inject.prep_inject(kb, b, _weights(rng, D, 1, 1)[0], torch.bfloat16)
    Dp = iw.sw.Dp
    kbp = iw.kbT.T.float().numpy()  # (3Dp, Dp): the x', cct and tet parts
    rest = bin_inject.kb_stream(iw).float().numpy()
    for j in range(3):
        got, rest = _read_fragments(rest, Dp, Dp)
        np.testing.assert_array_equal(got, kbp[j * Dp : (j + 1) * Dp], err_msg=f"part {j}")
    assert rest.size == 0
