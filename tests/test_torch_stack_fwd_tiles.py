"""The schedule of the stack forward's Hopper kernel on tiles
(``stack_fwd_tile_kernel``, csrc/mp_stack.cu), on the CPU (the kernel runs
only on the card: see tests/test_torch_cuda.py).

- The forward's weight stream (``fwd_weights``) holds the fold's kb^T, then
  each layer's W_in, W1_i, W2_i and W_s in the order the kernel multiplies
  by them, where its A-fragment loads read them, then the biases: rebuilt
  here by that read rule, exactly.
- The kernel's schedule, rendered plainly: each 64-atom tile forms its own
  x0 under the fold (from emb, or from the code rows and the table), then
  per layer its columns of agg from the bin's tiles in rank order, then its
  chain and residual with the dropout mask at its own global columns.  This
  gives ``mp_stack_train_plain``'s output and saved inputs, and
  ``mp_stack_plain``'s output: fp32, rtol 1e-6 (the aggregation's fp32 sums
  are taken 64 source atoms at a time, in another order).
"""

import numpy as np
import pytest
import torch

from aimnet_x2d_tpu_torch.ops import bin_mp, embed
from aimnet_x2d_tpu_torch.utils.activation import get_activation_function
from test_torch_stack_bwd_group import _case, _read_fragments, _weights

torch.set_num_threads(1)

RTOL = 1e-6
TILE = 64
VOCAB = (11, 5, 4, 6)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=RTOL * float(want.abs().max()), err_msg=what)


def _stack_fwd_tiles(x, adj, sw, spec, pw=None, vt=None):
    """The tile kernel's schedule in plain PyTorch: (out (D, A), the saved
    inputs of layers 1.. and, under the fold, of layer 0)."""
    dt = sw.dtype
    fn = get_activation_function(spec.act)
    nb, ab, _ = adj.shape
    C, Dp, D = ab // TILE, sw.Dp, sw.D
    if vt is not None:
        x = embed.embed_from_codes(x, vt)
    tiles = {}
    for b in range(nb):
        for r in range(C):
            xt = x[:, b * ab + r * TILE : b * ab + (r + 1) * TILE]
            tiles[b, r] = (fn(bin_mp._dot(pw.kbT, xt, dt) + pw.bb[:, None]) if pw is not None
                           else bin_mp._pad_rows(xt, Dp))

    def whole():
        return torch.cat([tiles[b, r] for b in range(nb) for r in range(C)], dim=1)

    saved = []
    for l, ws in enumerate(sw.layers):
        if pw is not None or l > 0:
            saved.append(whole()[:D].contiguous())
        w_in, b_in, w_s, b_s = ws[:4]
        new = {}
        for b in range(nb):
            for r in range(C):
                acc = torch.zeros(Dp, TILE)
                for s in range(C):  # the cluster's tiles in rank order
                    blk = adj[b, r * TILE : (r + 1) * TILE, s * TILE : (s + 1) * TILE]
                    acc += tiles[b, s].float() @ blk.float().T
                xa = torch.cat([tiles[b, r], acc.to(dt)])
                h = fn(bin_mp._dot(w_in, xa, dt) + b_in[:, None])
                for i in range(sw.n_blocks):
                    w1, b1, w2, b2 = ws[4 + 4 * i : 8 + 4 * i]
                    v = fn(bin_mp._dot(w1, h, dt) + b1[:, None])
                    drop = spec.drop(l, i, sw.n_blocks)
                    if drop is not None:
                        v = bin_mp._apply_drop(v, drop, b * ab + r * TILE)
                    h = bin_mp._dot(w2, v, dt) + b2[:, None] + h
                s_ = bin_mp._dot(w_s, xa, dt) + b_s[:, None]
                new[b, r] = (h + s_) + tiles[b, r]
        tiles = new
    return whole()[:D].contiguous(), saved


def _vocab(rng, E, A):
    codes = np.stack([rng.integers(0, v, A) for v in VOCAB]).astype(np.int32)
    codes[0, 3], codes[2, 7] = -1, 1000  # outside their vocabularies: zero rows
    tables = [torch.from_numpy(rng.normal(size=(v, E // len(VOCAB))).astype(np.float32))
              for v in VOCAB]
    vt = embed.prep_vocab(embed.blockdiag_table_t(tables), VOCAB, torch.float32)
    return torch.from_numpy(codes), vt


@pytest.mark.parametrize("fold", [None, "emb", "vocab"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("ab", [64, 128])
def test_fwd_tiles_derive_the_plain_training_forward(ab, rate, fold):
    E = 32 if fold else None
    adj, sw, x, _, pw = _case(ab + int(rate * 10), 19, 2, 3, nb=2, ab=ab, E=E)
    vt = None
    if fold == "vocab":
        x, vt = _vocab(np.random.default_rng(ab), E, x.shape[1])
    spec = bin_mp.StackSpec("silu", rate, 0xC0FFEE)
    out, saved = _stack_fwd_tiles(x, adj, sw, spec, pw, vt)
    ref, ref_saved = bin_mp.mp_stack_train_plain(x, adj, sw, spec, pw, vt)
    _close(out, ref, "out")
    assert len(saved) == len(ref_saved) == (3 if fold else 2)
    for l, (a, r) in enumerate(zip(saved, ref_saved)):
        _close(a, r, f"saved input {l}")


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("ab", [64, 256])
def test_fwd_tiles_derive_the_plain_serving_forward(ab, n_layers):
    """Serving (kernel 1) and, at one layer, kernel 1d: layer(x) + x."""
    adj, sw, x, _, _ = _case(ab + n_layers, 40, 2, n_layers, nb=2, ab=ab)
    out, _ = _stack_fwd_tiles(x, adj, sw, bin_mp.StackSpec("gelu"))
    _close(out, bin_mp.mp_stack_plain(x, adj, sw, "gelu"), "out")


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("n_blocks", [1, 2])
@pytest.mark.parametrize("D", [19, 40])
def test_fwd_stream_holds_each_matrix_in_use_order(D, n_blocks, n_layers, fold):
    rng = np.random.default_rng(D * n_blocks + n_layers + 7 * fold)
    sw = bin_mp.stack_weights(_weights(rng, D, n_blocks, n_layers), torch.bfloat16)
    Dp, E = sw.Dp, 48 if fold else 0
    pw = None
    if fold:
        kb = torch.from_numpy(rng.uniform(-1, 1, (E, D)).astype(np.float32))
        pw = bin_mp.prep_proj(kb, torch.from_numpy(rng.uniform(-1, 1, D).astype(np.float32)),
                              torch.bfloat16, Dp)
    rest = bin_mp.fwd_weights(sw, pw).float().numpy()
    assert rest.size == bin_mp.fwd_stream_elems(Dp, n_blocks, n_layers, E)
    mats, biases = [], []
    if fold:
        mats.append(("kb^T", pw.kbT.float().numpy()))
        biases.append(pw.bb.float().numpy())
    for l, ws in enumerate(sw.layers):
        ws = [w.float().numpy() for w in ws]
        mats.append((f"layer {l} W_in", ws[0]))
        biases.append(ws[1])
        for i in range(n_blocks):
            mats += [(f"layer {l} W1_{i}", ws[4 + 4 * i]), (f"layer {l} W2_{i}", ws[6 + 4 * i])]
            biases += [ws[5 + 4 * i], ws[7 + 4 * i]]
        mats.append((f"layer {l} W_s", ws[2]))
        biases.append(ws[3])
    for what, m in mats:
        got, rest = _read_fragments(rest, Dp, m.shape[1])
        np.testing.assert_array_equal(got, m, err_msg=what)
    np.testing.assert_array_equal(rest, np.concatenate(biases))
