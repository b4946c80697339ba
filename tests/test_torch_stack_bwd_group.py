"""The stack backward's grouped weight-gradient contraction and the walk's
weight stream, on the CPU (the kernels run only on the card: see
tests/test_torch_cuda.py).

- The contraction's plain version, fed the work slabs formed from the plain
  backward's own operands (``bwd_slabs_plain``) through the product mapping
  the CUDA wrapper uses (``layer_products``), gives the weight and bias
  gradients of ``mp_stack_bwd_plain`` and ``mp_layer_bwd_plain``: fp32,
  rtol 1e-6 (the same products of the same operands).
- The walk's weight stream (``walk_weights``) holds each matrix the walk
  multiplies by, in the order it uses them, where its A-fragment loads
  read them: rebuilt here by that read rule, exactly.
"""

import numpy as np
import pytest
import torch

from aimnet_x2d_tpu_torch.ops import bin_mp

RTOL = 1e-6


def _weights(rng, D, n_blocks, n_layers):
    u = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32) / np.sqrt(s[0]))  # noqa: E731
    layers = []
    for _ in range(n_layers):
        lw = [u(D, D), u(D, D), u(D), u(D, D), u(D, D), u(D)]
        for _ in range(n_blocks):
            lw += [u(D, D), u(D), u(D, D), u(D)]
        layers.append(lw)
    return layers


def _case(seed, D, n_blocks, n_layers, nb=3, ab=64, E=None, dt=torch.float32):
    rng = np.random.default_rng(seed)
    near = rng.random((nb, ab, ab)) < 6.0 / ab
    adj = torch.from_numpy((near * rng.integers(1, 3, (nb, ab, ab))).astype(np.int8))
    sw = bin_mp.stack_weights(_weights(rng, D, n_blocks, n_layers), dt)
    rows = E if E is not None else D
    x = torch.from_numpy(rng.normal(size=(rows, nb * ab)).astype(np.float32)).to(dt)
    g = torch.from_numpy(rng.normal(size=(D, nb * ab)).astype(np.float32)).to(dt)
    pw = None
    if E is not None:
        kb = torch.from_numpy(rng.uniform(-1, 1, (E, D)).astype(np.float32) / np.sqrt(E))
        bb = torch.from_numpy(rng.uniform(-1, 1, D).astype(np.float32) / np.sqrt(E))
        pw = bin_mp.prep_proj(kb, bb, dt, sw.Dp)
    return adj, sw, x, g, pw


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=RTOL * float(
        want.abs().max()), err_msg=what)


def _group_grads(wk, n_blocks):
    return [t for pair in bin_mp.wgrad_group_plain(bin_mp.layer_products(wk, n_blocks))
            for t in pair]


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("n_blocks", [1, 2])
def test_stack_products_give_the_plain_backward_grads(n_blocks, fold, rate, act):
    D, L = 19, 3
    adj, sw, x, g, pw = _case(n_blocks + 10 * fold, D, n_blocks, L, E=24 if fold else None)
    spec = bin_mp.StackSpec(act, rate, 0x5EED1234, L)
    _, saved = bin_mp.mp_stack_train_plain(x, adj, sw, spec, pw)
    _, want, proj = bin_mp.mp_stack_bwd_plain(x, adj, sw, spec, saved, g, pw)
    first = 0 if fold else 1
    g32 = bin_mp._pad_rows(g.float(), sw.Dp)
    for l in range(L - 1, -1, -1):
        if l >= first:
            xl = bin_mp._pad_rows(saved[l - first], sw.Dp)
        else:
            xl = bin_mp._pad_rows(x, sw.Dp)
        wk = bin_mp.bwd_slabs_plain(xl, adj, sw.layers[l], spec, n_blocks, l, g32)
        assert wk.shape[0] == bin_mp.bwd_slabs(n_blocks)["n"]
        for k, (got, ref) in enumerate(zip(_group_grads(wk, n_blocks), want[l])):
            _close(got, ref, f"layer {l} grad {k}")
        g32, _ = bin_mp._layer_bwd_plain(xl, adj, sw.layers[l], spec, n_blocks, l, g32)
    if fold:
        # the fold's product: (rnd(dt0), emb, bias from dt0 in fp32)
        t0 = bin_mp._dot(pw.kbT, x, x.dtype) + pw.bb[:, None]
        dt0 = g32 * bin_mp.activation_grad(act, t0).float()
        ((dkbT, dbb),) = bin_mp.wgrad_group_plain([(dt0.to(x.dtype), x, dt0)])
        _close(dkbT, proj[0], "dkbT")
        _close(dbb, proj[1], "dbb")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n_blocks", [1, 2])
@pytest.mark.parametrize("D", [19, 40])
def test_layer_products_give_the_plain_layer_backward_grads(D, n_blocks, rate):
    adj, sw, x, g, _ = _case(D + n_blocks, D, n_blocks, 1, nb=2, ab=128)
    spec = bin_mp.StackSpec("silu", rate, 0x0BADCAFE, 1)
    _, want = bin_mp.mp_layer_bwd_plain(x, adj, sw, spec, g)
    wk = bin_mp.bwd_slabs_plain(bin_mp._pad_rows(x, sw.Dp), adj, sw.layers[0], spec, n_blocks, 0,
                                bin_mp._pad_rows(g.float(), sw.Dp))
    for k, (got, ref) in enumerate(zip(_group_grads(wk, n_blocks), want)):
        _close(got, ref, f"grad {k}")


def test_slab_layout_has_the_walk_operands_then_the_legacy_ones():
    for n in (1, 2, 3):
        k = bin_mp.bwd_slabs(n)
        order = [k["XA"], k["H"], k["V"], k["DH"], k["DU"], k["DT"], k["n"]]
        assert order == [0, 2, 2 + n, 2 + 2 * n, 2 + 3 * n, 2 + 4 * n, 3 + 4 * n]
        assert k["n_legacy"] == k["n"] + n + 2  # t, u_i, dA


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_wgrad_group_on_cpu_tensors_is_the_plain_version(dt):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    prods = [(t(32, 128).to(dt), t(64, 128).to(dt), None), (t(16, 128).to(dt), t(16, 128).to(dt),
                                                             t(16, 128))]
    before = bin_mp.wgrad_group.launches
    got = bin_mp.wgrad_group(prods)
    assert bin_mp.wgrad_group.launches == before  # no kernel on the CPU
    for (dw, db), (dY, X, b) in zip(got, prods):
        torch.testing.assert_close(dw, dY.float() @ X.float().T, rtol=0, atol=0)
        torch.testing.assert_close(db, (b if b is not None else dY.float()).sum(1), rtol=0, atol=0)


def _read_fragments(stream, Dp, K):
    """The (Dp, K) matrix the walk's warps read from ``stream``: per
    32-column stage and 16 x 16 tile (k-major), lane 4g + t's eight values
    are (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), (g, 2t+8), (g, 2t+9),
    (g+8, 2t+8), (g+8, 2t+9)."""
    Kp = -(-K // 32) * 32
    MT = Dp // 16
    w = np.zeros((Dp, Kp), stream.dtype)
    for s in range(Kp // 32):
        st = stream[s * Dp * 32 : (s + 1) * Dp * 32]
        for kk in range(2):
            for mt in range(MT):
                tile = st[(kk * MT + mt) * 256 : (kk * MT + mt + 1) * 256]
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    v = tile[lane * 8 : lane * 8 + 8]
                    r, c = 16 * mt + g, 32 * s + 16 * kk + 2 * t
                    w[r, c : c + 2], w[r + 8, c : c + 2] = v[0:2], v[2:4]
                    w[r, c + 8 : c + 10], w[r + 8, c + 8 : c + 10] = v[4:6], v[6:8]
    assert not w[:, K:].any(), "padding columns must be zero"
    return w[:, :K], stream[Dp * Kp :]


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("n_blocks", [1, 2])
@pytest.mark.parametrize("D", [19, 40])
def test_walk_stream_holds_each_matrix_in_use_order(D, n_blocks, n_layers):
    rng = np.random.default_rng(D * n_blocks + n_layers)
    sw = bin_mp.stack_weights(_weights(rng, D, n_blocks, n_layers), torch.bfloat16)
    Dp = sw.Dp
    stream = bin_mp.walk_weights(sw).float().numpy()
    per = bin_mp.walk_stream_elems(Dp, n_blocks)
    assert stream.size == n_layers * per
    for l, ws in enumerate(sw.layers):
        ws = [w.float().numpy() for w in ws]
        w_in, b_in, w_s = ws[0], ws[1], ws[2]
        blocks = [ws[4 + 4 * i : 8 + 4 * i] for i in range(n_blocks)]
        mats = [w_in]
        for i in range(n_blocks):
            mats += [blocks[i][0]] + ([blocks[i][2]] if i + 1 < n_blocks else [])
        for i in reversed(range(n_blocks)):
            mats += [blocks[i][2].T, blocks[i][0].T]
        wt = np.concatenate([w_s.T, w_in.T], 1)
        mats += [wt[Dp:], wt[:Dp]]
        rest = stream[l * per : (l + 1) * per]
        for j, m in enumerate(mats):
            got, rest = _read_fragments(rest, Dp, m.shape[1])
            np.testing.assert_array_equal(got, m, err_msg=f"layer {l} matrix {j}")
        biases = [b_in] + [b for blk in blocks for b in (blk[1], blk[3])]
        np.testing.assert_array_equal(rest, np.concatenate(biases))
