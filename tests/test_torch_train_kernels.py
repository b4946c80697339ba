"""Plain PyTorch versions of the training kernels against the JAX package's
Pallas kernels, which run here in interpret mode, as the JAX package's own
kernel tests run them.

- ops/bin_mp.py: the stack's training forward (dropout, the x_other
  projection fold, saved layer inputs) and its backward, against
  ``binned_mp_stack_t`` and ``jax.vjp`` of it; the dropout mask against
  ``bin_mp._dropout_mask``, bit for bit.
- ops/bin_attnpool.py: the fused attention pool, forward and backward,
  against ``binned_attnpool_proj_t`` and ``jax.vjp`` of it.

Inputs are made from a seed with numpy and handed to both.  Tolerances:
fp32 rtol 5e-4 / atol 5e-5 (both sides accumulate in fp32 and differ only
in summation order); bf16 max|d|/max|ref| < 5e-2 (one fp32 sum rounding to
the other bf16 neighbour moves an intermediate by 2**-8 and propagates).
Run with ``-s`` to print the measured errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.ops import bin_mp as jax_bin_mp
from aimnet_x2d_tpu.ops.bin_attnpool import binned_attnpool_proj_t as jax_attnpool
from aimnet_x2d_tpu.ops.bin_mp import binned_mp_stack_t as jax_stack
from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    monkeypatch.setenv("AIMNET_MP_PROJ", "1")
    monkeypatch.setenv("AIMNET_ATTNPOOL_KERNEL", "interpret")


def _check(got, ref, dtype, what="", scale=None):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max() if scale is None else scale, 1e-30)
    print(f"{what} {dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / scale:.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=what)
    else:
        assert err / scale < 5e-2, what


def _adjacency(rng, nb, ab):
    adj = np.zeros((nb, ab, ab), np.int8)
    for b in range(nb):
        n = rng.integers(ab // 2, ab + 1)
        for _ in range(4 * n):
            i, j = rng.integers(0, n, 2)
            if i != j:
                adj[b, i, j] += 1
    return adj


def _stack_inputs(seed, D=19, E=16, nb=3, ab=32, n_layers=2, n_blocks=2):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(E, nb * ab)).astype(np.float32)
    x = rng.normal(size=(D, nb * ab)).astype(np.float32)
    adj = _adjacency(rng, nb, ab)
    layers = []
    for _ in range(n_layers):
        ws = [rng.uniform(-0.3, 0.3, (D, D)), rng.uniform(-0.3, 0.3, (D, D)),
              rng.uniform(-0.2, 0.2, D),
              rng.uniform(-0.3, 0.3, (D, D)), rng.uniform(-0.3, 0.3, (D, D)),
              rng.uniform(-0.2, 0.2, D)]
        for _ in range(n_blocks):
            ws += [rng.uniform(-0.3, 0.3, (D, D)), rng.uniform(-0.2, 0.2, D),
                   rng.uniform(-0.3, 0.3, (D, D)), rng.uniform(-0.2, 0.2, D)]
        layers.append([w.astype(np.float32) for w in ws])
    kb = rng.uniform(-0.4, 0.4, (E, D)).astype(np.float32)
    bb = rng.uniform(-0.2, 0.2, D).astype(np.float32)
    g = rng.normal(size=(D, nb * ab)).astype(np.float32)
    return x, emb, adj, layers, kb, bb, g


@pytest.mark.parametrize("seed", [0, 7, -123456789, 2**31 - 1])
@pytest.mark.parametrize("tag", [0, 3, 5])
@pytest.mark.parametrize("lane_off", [0, 96, 40960])
def test_dropout_mask_bit_equal(seed, tag, lane_off):
    ref = jax_bin_mp._dropout_mask(
        (19, 64), 0.05, jnp.uint32(np.uint32(np.int64(seed) & 0xFFFFFFFF)), tag,
        jnp.uint32(lane_off))
    got = bin_mp.dropout_keep(19, lane_off, 64, 0.05, seed & 0xFFFFFFFF, tag)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.85 < got.float().mean() < 1.0


def _jax_stack_fn(adj, act, dtype, rate, seed, n_blocks, proj):
    def f(xin, kb, bb, layers):
        return jax_stack(
            xin.astype(JDT[dtype]), jnp.asarray(adj), layers, act=act, num_mlp_layers=n_blocks,
            compute_dtype=JDT[dtype], interpret=True, dropout=rate,
            drop_seed=jnp.asarray([seed], jnp.int32) if rate else None,
            proj_weights=(kb, bb) if proj else None,
        )
    return f


@pytest.mark.parametrize("proj,rate", [(True, 0.1), (False, 0.1), (True, 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_train_forward_and_backward_match_jax(dtype, proj, rate):
    act, seed, n_blocks = "silu", -987654, 2
    x, emb, adj, layers, kb, bb, g = _stack_inputs(seed=4)
    xin = emb if proj else x
    f = _jax_stack_fn(adj, act, dtype, rate, seed, n_blocks, proj)
    jl = tuple(tuple(jnp.asarray(w) for w in lw) for lw in layers)
    out_ref, vjp = jax.vjp(f, jnp.asarray(xin), jnp.asarray(kb), jnp.asarray(bb), jl)
    dx_ref, dkb_ref, dbb_ref, dl_ref = vjp(jnp.asarray(g).astype(out_ref.dtype))

    tx = torch.from_numpy(xin).to(TDT[dtype]).requires_grad_(True)
    tkb = torch.from_numpy(kb).requires_grad_(True)
    tbb = torch.from_numpy(bb).requires_grad_(True)
    tl = [[torch.from_numpy(w).requires_grad_(True) for w in lw] for lw in layers]
    out = bin_mp.binned_mp_stack_train_t(
        tx, torch.from_numpy(adj), tl, TDT[dtype], act=act, dropout=rate, seed=seed,
        proj_weights=(tkb, tbb) if proj else None)
    _check(out.detach().float(), out_ref.astype(jnp.float32), dtype, "out")
    out.backward(torch.from_numpy(g).to(out.dtype))
    _check(tx.grad.float(), dx_ref.astype(jnp.float32), dtype, "demb" if proj else "dx")
    if proj:
        _check(tkb.grad, dkb_ref, dtype, "d_kb")
        _check(tbb.grad, dbb_ref, dtype, "d_bb")
    for l, (lw, lref) in enumerate(zip(tl, dl_ref)):
        for k, (w, r) in enumerate(zip(lw, lref)):
            _check(w.grad, r, dtype, f"layer {l} weight {k}")


@pytest.mark.parametrize("act", ["relu", "leakyrelu", "elu", "gelu"])
def test_stack_train_backward_activations(act):
    dtype, rate, seed = "float32", 0.2, 99
    x, emb, adj, layers, kb, bb, g = _stack_inputs(seed=8, D=13, E=32, ab=64, nb=2)
    f = _jax_stack_fn(adj, act, dtype, rate, seed, 2, True)
    jl = tuple(tuple(jnp.asarray(w) for w in lw) for lw in layers)
    out_ref, vjp = jax.vjp(f, jnp.asarray(emb), jnp.asarray(kb), jnp.asarray(bb), jl)
    dx_ref, dkb_ref, _, dl_ref = vjp(jnp.asarray(g))
    tx = torch.from_numpy(emb).requires_grad_(True)
    tkb = torch.from_numpy(kb).requires_grad_(True)
    tl = [[torch.from_numpy(w).requires_grad_(True) for w in lw] for lw in layers]
    out = bin_mp.binned_mp_stack_train_t(tx, torch.from_numpy(adj), tl, torch.float32, act=act,
                                         dropout=rate, seed=seed,
                                         proj_weights=(tkb, torch.from_numpy(bb)))
    out.backward(torch.from_numpy(g))
    _check(out.detach(), out_ref, dtype, f"{act} out")
    _check(tx.grad, dx_ref, dtype, f"{act} demb")
    _check(tkb.grad, dkb_ref, dtype, f"{act} d_kb")
    _check(tl[0][0].grad, dl_ref[0][0], dtype, f"{act} layer 0 w_in0")


def test_saved_inputs_are_layer_inputs():
    x, emb, adj, layers, kb, bb, g = _stack_inputs(seed=3)
    sw = bin_mp.stack_weights([[torch.from_numpy(w) for w in lw] for lw in layers], torch.float32)
    pw = bin_mp.prep_proj(torch.from_numpy(kb), torch.from_numpy(bb), torch.float32, sw.Dp)
    spec = bin_mp.StackSpec("silu")
    out, saved = bin_mp.mp_stack_train_plain(torch.from_numpy(emb), torch.from_numpy(adj), sw,
                                             spec, pw)
    assert len(saved) == 2
    x0 = torch.nn.functional.silu(torch.from_numpy(kb).T @ torch.from_numpy(emb)
                                  + torch.from_numpy(bb)[:, None])
    torch.testing.assert_close(saved[0], x0, rtol=1e-5, atol=1e-5)
    # without dropout the training forward is the serving forward
    torch.testing.assert_close(out, bin_mp.mp_stack_plain(x0, torch.from_numpy(adj), sw, "silu"),
                               rtol=1e-5, atol=1e-5)


def _pool_inputs(seed, Ds=21, Do=13, E=16, H=4, nb=3, mb=8, ab=32):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(E, nb * ab)).astype(np.float32)
    xo = rng.normal(size=(Do, nb * ab)).astype(np.float32)
    owner = rng.integers(-1, mb - 1, (nb, ab))  # some atoms and one slot empty
    pm = (owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)
    kb = rng.uniform(-0.4, 0.4, (E, Ds)).astype(np.float32)
    bb = rng.uniform(-0.2, 0.2, Ds).astype(np.float32)
    ks = rng.uniform(-0.5, 0.5, (Ds, H)).astype(np.float32)
    ko = rng.uniform(-0.5, 0.5, (Do, H)).astype(np.float32)
    sb = rng.uniform(-0.2, 0.2, H).astype(np.float32)
    gps = rng.normal(size=(Ds, nb * mb)).astype(np.float32)
    gpo = rng.normal(size=(Do, nb * mb)).astype(np.float32)
    gcov = rng.normal(size=(nb * mb,)).astype(np.float32)
    return emb, xo, pm, kb, bb, ks, ko, sb, gps, gpo, gcov


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attnpool_forward_and_backward_match_jax(dtype, act):
    emb, xo, pm, kb, bb, ks, ko, sb, gps, gpo, gcov = _pool_inputs(seed=5)
    jdt = JDT[dtype]

    def f(e, x, kb_, bb_, ks_, ko_, sb_):
        ps, po, cov, _ = jax_attnpool(e.astype(jdt), kb_, bb_, act, x.astype(jdt),
                                      jnp.asarray(pm), ks_, ko_, sb_, interpret=True)
        return ps, po, cov

    args = [jnp.asarray(a) for a in (emb, xo, kb, bb, ks, ko, sb)]
    ref, vjp = jax.vjp(f, *args)
    grads_ref = vjp((jnp.asarray(gps), jnp.asarray(gpo), jnp.asarray(gcov)))
    attn_ref = jax_attnpool(args[0].astype(jdt), args[2], args[3], act, args[1].astype(jdt),
                            jnp.asarray(pm), args[4], args[5], args[6], interpret=True)[3]

    t = [torch.from_numpy(a) for a in (emb, xo, kb, bb, ks, ko, sb)]
    t[0], t[1] = t[0].to(TDT[dtype]), t[1].to(TDT[dtype])
    for a in t:
        a.requires_grad_(True)
    ps, po, cov, attn = bin_attnpool.binned_attnpool_proj_t(
        t[0], t[2], t[3], act, t[1], torch.from_numpy(pm), t[4], t[5], t[6])
    for got, r, name in zip((ps, po, cov), ref, ("pooled_self", "pooled_other", "coverage")):
        _check(got.detach(), r, dtype, name)
    _check(attn, attn_ref, dtype, "attn")
    assert not attn.requires_grad
    torch.autograd.backward([ps, po, cov], [torch.from_numpy(a) for a in (gps, gpo, gcov)])
    names = ("demb", "dx_other", "d_kb", "d_bb", "d_ks", "d_ko", "d_sb")
    for a, r, name in zip(t, grads_ref, names):
        # the exact d_sb is 0 (a per-head shift of every score leaves each
        # molecule's softmax unchanged): in bf16 both sides hold the rounding
        # residue of sums of such terms, so it is held to the scale of the
        # same terms weighted by the features, d_ks
        scale = np.abs(np.asarray(grads_ref[4])).max() if name == "d_sb" else None
        _check(a.grad.float(), jnp.asarray(r, jnp.float32), dtype, name, scale)


@pytest.mark.parametrize("fault", ["two_owners", "weight_2"])
def test_attnpool_refuses_pool_mat_the_kernels_cannot_take(fault):
    emb, xo, pm, kb, bb, ks, ko, sb, *_ = _pool_inputs(seed=6)
    bin_attnpool.check_one_owner(torch.from_numpy(pm))  # the loaders' form passes
    bad = pm.copy()
    if fault == "two_owners":
        bad[0, :, 0] = 0
        bad[0, 0, 0] = bad[0, 1, 0] = 1
    else:
        bad[0, :, 0] = 0
        bad[0, 0, 0] = 2
    t = [torch.from_numpy(a) for a in (emb, xo, kb, bb, ks, ko, sb)]
    with pytest.raises(ValueError, match="at most one molecule"):
        bin_attnpool.binned_attnpool_proj_t(t[0], t[2], t[3], "silu", t[1], torch.from_numpy(bad),
                                            t[4], t[5], t[6])
