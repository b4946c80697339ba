"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.  Run on the
card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.  This file
imports no JAX, so it runs where only PyTorch is installed.

Tolerances as max|kernel - plain| / max|plain|: fp32 1e-4 (same fp32
products, summed in another order); bf16 stack 5e-2 (a sum rounding to the
other bf16 neighbour moves an intermediate by 2**-8 and propagates);
pools 1e-5 (identical rounded products, fp32 sums)."""

import numpy as np
import pytest
import torch

from aimnet_x2d_tpu_torch.ops import bin_mp, bin_wpool

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel(got, ref):
    assert torch.isfinite(got).all()
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


@pytest.mark.parametrize("act", ["silu", "relu", "leakyrelu", "elu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [19, 153])
def test_stack_kernel_matches_plain(dev, dtype, act, D):
    g = torch.Generator(device=dev).manual_seed(D)
    nb, ab = 5, 256 if D == 153 else 64
    adj = torch.randint(0, 3, (nb, ab, ab), generator=g, device=dev).to(torch.int8)
    layers = []
    for _ in range(3):
        shapes = [(D, D), (D, D), (D,), (D, D), (D, D), (D,)] + [(D, D), (D,), (D, D), (D,)] * 2
        layers.append([(torch.rand(s, generator=g, device=dev) - 0.5) * 0.4 for s in shapes])
    sw = bin_mp.stack_weights(layers, dtype)
    x = torch.randn(D, nb * ab, generator=g, device=dev).to(dtype)
    before = bin_mp.mp_stack_fwd.launches
    got = bin_mp.binned_mp_stack_t(x, adj, sw, act)
    assert bin_mp.mp_stack_fwd.launches == before + 1
    ref = bin_mp.mp_stack_plain(x, adj, sw, act)
    torch.cuda.synchronize()
    assert _rel(got, ref) < (1e-4 if dtype == torch.float32 else 5e-2)


@pytest.mark.parametrize("mb", [5, 16, 44])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wpool_kernel_matches_plain(dev, dtype, mb):
    g = torch.Generator(device=dev).manual_seed(mb)
    nb, ab, D = 7, 256, 359
    owner = torch.randint(-1, mb, (nb, ab), generator=g, device=dev)
    pm = (owner[:, None, :] == torch.arange(mb, device=dev)[None, :, None]).to(torch.int8)
    x = torch.randn(D, nb * ab, generator=g, device=dev).to(dtype)
    w = torch.rand(nb * ab, generator=g, device=dev)
    before = bin_wpool.wpool_fwd.launches
    got = bin_wpool.binned_wpool_t(x, w, pm)
    assert bin_wpool.wpool_fwd.launches == before + 1
    ref = bin_wpool.wpool_plain(x, w, pm)
    torch.cuda.synchronize()
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("need_dw", [True, False])
@pytest.mark.parametrize("mb", [5, 16, 44])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wpool_bwd_kernel_matches_plain(dev, dtype, mb, need_dw):
    """Kernel 2b: dx is the rounded cotangent times w, the same arithmetic
    on both sides; dw sums fp32 products over D in another order (1e-5)."""
    g = torch.Generator(device=dev).manual_seed(100 + mb)
    nb, ab = 7, 256
    owner = torch.randint(-1, mb, (nb, ab), generator=g, device=dev)
    pm = (owner[:, None, :] == torch.arange(mb, device=dev)[None, :, None]).to(torch.int8)
    w = torch.rand(nb * ab, generator=g, device=dev) * (owner >= 0).reshape(-1)
    for D in (359, 153):
        x = torch.randn(D, nb * ab, generator=g, device=dev).to(dtype)
        gout = torch.randn(D, nb * mb, generator=g, device=dev)
        before = bin_wpool.wpool_bwd.launches
        dx, dw = bin_wpool.wpool_bwd(x, w, pm, gout, need_dw)
        assert bin_wpool.wpool_bwd.launches == before + 1
        rdx, rdw = bin_wpool.wpool_bwd_plain(x, w, pm, gout, need_dw)
        torch.cuda.synchronize()
        assert dx.dtype == dtype and _rel(dx, rdx) < 1e-5
        if need_dw:
            assert dw.dtype == torch.float32 and _rel(dw, rdw) < 1e-5
            assert torch.equal(dw, bin_wpool.wpool_bwd(x, w, pm, gout, True)[1])  # fixed order
        else:
            assert dw is None and rdw is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wpool_autograd_launches_both_kernels(dev, dtype):
    """binned_wpool_t's backward on a CUDA tensor runs kernel 2b, with dw
    only when w needs a gradient, and matches the same on CPU copies."""
    g = torch.Generator(device=dev).manual_seed(7)
    nb, mb, ab, D = 5, 16, 256, 153
    owner = torch.randint(-1, mb, (nb, ab), generator=g, device=dev)
    pm = (owner[:, None, :] == torch.arange(mb, device=dev)[None, :, None]).to(torch.int8)
    x0 = torch.randn(D, nb * ab, generator=g, device=dev).to(dtype)
    w0 = torch.rand(nb * ab, generator=g, device=dev)
    gout = torch.randn(D, nb * mb, generator=g, device=dev)
    grads = {}
    for where, w_grad in (("cuda", True), ("cuda", False), ("cpu", True)):
        x = x0.detach().to(where).requires_grad_(True)
        w = w0.detach().to(where).requires_grad_(w_grad)
        f0, b0 = bin_wpool.wpool_fwd.launches, bin_wpool.wpool_bwd.launches
        bin_wpool.binned_wpool_t(x, w, pm.to(where)).backward(gout.to(where))
        ran = (bin_wpool.wpool_fwd.launches - f0, bin_wpool.wpool_bwd.launches - b0)
        assert ran == ((1, 1) if where == "cuda" else (0, 0))
        assert (w.grad is not None) == w_grad
        grads[(where, w_grad)] = (x.grad, w.grad)
    torch.cuda.synchronize()
    ref = grads[("cpu", True)]
    for key in (("cuda", True), ("cuda", False)):
        assert _rel(grads[key][0], ref[0].to(dev)) < 1e-5
    assert _rel(grads[("cuda", True)][1], ref[1].to(dev)) < 1e-5


def test_kernel_errors_raise(dev):
    x = torch.randn(19, 128, device=dev)
    adj = torch.zeros(2, 64, 64, dtype=torch.int8, device=dev)
    sw = bin_mp.stack_weights([[torch.zeros(s, device=dev) for s in
                                [(19, 19)] * 2 + [(19,)] + [(19, 19)] * 2 + [(19,)]]] * 2,
                              torch.bfloat16)
    with pytest.raises(TypeError):  # dtype mismatch with the weights
        bin_mp.binned_mp_stack_t(x, adj, sw, "silu")
    with pytest.raises(ValueError):  # ab not a multiple of 64
        bin_mp.binned_mp_stack_t(x.to(torch.bfloat16), adj[:, :32, :32].contiguous(), sw, "silu")
    x_odd = torch.zeros(19 * 128 + 1, dtype=torch.bfloat16, device=dev)[1:].view(19, 128)
    with pytest.raises(ValueError):  # x not 16-byte aligned
        bin_mp.binned_mp_stack_t(x_odd, adj, sw, "silu")
    np.testing.assert_array_equal(
        bin_mp.binned_mp_stack_t(x.to(torch.bfloat16), adj, sw, "silu").float().cpu().numpy(),
        x.to(torch.bfloat16).float().cpu().numpy(),  # zero weights: x + 0
    )


# ---- training kernels: stack forward (training form) and backward, the
# attention pool forward and backward, the weight-gradient contraction.
# Same tolerances; the backward's sums run over every atom of the batch in
# another order than the plain version's, which fp32 1e-4 covers.


def _stack_train_case(dev, D, E, nb, ab, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    # molecule-like: a few neighbours per atom (a dense random adjacency
    # grows activations ~ab-fold per layer, past what bf16 gradients hold)
    near = torch.rand(nb, ab, ab, generator=g, device=dev) < 6.0 / ab
    adj = (near * torch.randint(1, 3, (nb, ab, ab), generator=g, device=dev)).to(torch.int8)
    # the model's initialisation scale: U(+-1/sqrt(fan_in))
    u = lambda s, fan: (torch.rand(s, generator=g, device=dev) * 2 - 1) / fan**0.5  # noqa: E731
    layers = []
    for _ in range(3):
        lw = [u((D, D), 4 * D), u((D, D), 4 * D), u((D,), 4 * D)] * 2
        for _ in range(2):
            lw += [u((D, D), D), u((D,), D), u((D, D), D), u((D,), D)]
        layers.append(lw)
    sw = bin_mp.stack_weights(layers, dtype)
    kb = u((E, D), E)
    bb = u((D,), E)
    pw = bin_mp.prep_proj(kb, bb, dtype, sw.Dp)
    emb = torch.randn(E, nb * ab, generator=g, device=dev).to(dtype)
    x = torch.randn(D, nb * ab, generator=g, device=dev).to(dtype)
    gout = torch.randn(D, nb * ab, generator=g, device=dev).to(dtype)
    return adj, sw, pw, emb, x, gout


@pytest.mark.parametrize("proj", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [19, 153])
def test_stack_train_kernels_match_plain(dev, D, dtype, proj):
    nb, ab, E = 5, 256 if D == 153 else 64, 256 if D == 153 else 32
    adj, sw, pw, emb, x, gout = _stack_train_case(dev, D, E, nb, ab, dtype, D + 1)
    spec = bin_mp.StackSpec("silu", 0.05, 0xDEADBEEF)
    xin, pw_ = (emb, pw) if proj else (x, None)
    out, saved = bin_mp.mp_stack_fwd_train(xin, adj, sw, spec, pw_)
    ref, ref_saved = bin_mp.mp_stack_train_plain(xin, adj, sw, spec, pw_)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert _rel(out, ref) < tol
    for s_, r_ in zip(saved, ref_saved):
        assert _rel(s_, r_) < tol
    dx, lg, pg = bin_mp.mp_stack_bwd(xin, adj, sw, spec, saved, gout, pw_)
    rdx, rlg, rpg = bin_mp.mp_stack_bwd_plain(xin, adj, sw, spec, ref_saved, gout, pw_)
    torch.cuda.synchronize()
    errs = {"dx": _rel(dx, rdx)}
    for l, (got_l, ref_l) in enumerate(zip(lg, rlg)):
        for k, (got, r) in enumerate(zip(got_l, ref_l)):
            errs[f"layer {l} grad {k}"] = _rel(got, r)
    for k, (got, r) in enumerate(zip(pg or (), rpg or ())):
        errs[f"proj grad {k}"] = _rel(got, r)
    print(f"D={D} {dtype} proj={proj}: worst {max(errs.values()):.2e}", errs)
    assert max(errs.values()) < tol


def test_stack_serving_unchanged_by_training_form(dev):
    """Without dropout, the training forward computes the serving forward."""
    adj, sw, _, _, x, _ = _stack_train_case(dev, 153, 256, 3, 256, torch.bfloat16, 3)
    out, _ = bin_mp.mp_stack_fwd_train(x, adj, sw, bin_mp.StackSpec("silu"))
    torch.testing.assert_close(out, bin_mp.mp_stack_fwd(x, adj, sw, "silu"), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(359, 153, 256, 16, 256), (21, 13, 32, 12, 64)])
def test_attnpool_kernels_match_plain(dev, dtype, shape):
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    Ds, Do, E, mb, ab = shape
    nb, H = 6, 4
    g = torch.Generator(device=dev).manual_seed(Ds)
    owner = torch.randint(-1, mb - 1, (nb, ab), generator=g, device=dev)
    pm = (owner[:, None, :] == torch.arange(mb, device=dev)[None, :, None]).to(torch.int8)
    bin_attnpool.check_one_owner(pm)  # the kernels' precondition
    emb = torch.randn(E, nb * ab, generator=g, device=dev).to(dtype)
    xo = torch.randn(Do, nb * ab, generator=g, device=dev).to(dtype)
    r = lambda *s: (torch.rand(*s, generator=g, device=dev) - 0.5) * 0.4  # noqa: E731
    w = bin_attnpool.prep_weights(r(E, Ds), r(Ds), r(Ds, H), r(Do, H), r(H), dtype)
    got = bin_attnpool.attnpool_fwd(emb, xo, pm, w, "silu")
    ref = bin_attnpool.attnpool_fwd_plain(emb, xo, pm, w, "silu")
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, b in zip(got, ref):
        assert _rel(a, b) < tol
    gps = torch.randn(Ds, nb * mb, generator=g, device=dev)
    gpo = torch.randn(Do, nb * mb, generator=g, device=dev)
    gcov = torch.randn(nb * mb, generator=g, device=dev)
    demb, dxo, grads = bin_attnpool.attnpool_bwd(emb, xo, pm, w, "silu", ref[3], gps, gpo, gcov)
    rdemb, rdxo, rgrads = bin_attnpool.attnpool_bwd_plain(emb, xo, pm, w, "silu", ref[3], gps,
                                                          gpo, gcov)
    torch.cuda.synchronize()
    assert _rel(demb, rdemb) < tol and _rel(dxo, rdxo) < tol
    # d_sb is a sum of terms that cancel to 0: held to the scale of d_ks
    for i, (a, b) in enumerate(zip(grads, rgrads)):
        scale = float(rgrads[2].abs().max()) if i == 4 else float(b.abs().max())
        assert float((a - b).abs().max()) / scale < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_matches_matmul(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    dY = torch.randn(160, 10 * 1024, generator=g, device=dev).to(dtype)
    X = torch.randn(320, 10 * 1024, generator=g, device=dev).to(dtype)
    dw, db = bin_mp.wgrad(dY, X)
    assert _rel(dw, dY.float() @ X.float().T) < 1e-4
    assert _rel(db, dY.float().sum(1)) < 1e-4
    dw2, _ = bin_mp.wgrad(dY, X)
    assert torch.equal(dw, dw2)  # fixed-order sums: the same bits every run


# ---- config 3: kernel 1d (the stack kernels launched for one layer:
# serving form, training form with dropout, backward) and kernel 4 (the
# charge + stereo inject round), against their plain versions.  Same
# tolerances; inputs are molecule-like (a few neighbours per atom,
# init-scale weights) for the reason given above.


def _init_layer(rng, D, n_blocks=2):
    """One shell-conv layer's fp32 masters at the model's initialisation
    scale, U(+-1/sqrt(fan_in)), in the caller's order."""
    u = lambda s, fan: (rng.uniform(-1, 1, s) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    lw = [u((D, D), 4 * D), u((D, D), 4 * D), u(D, 4 * D), u((D, D), 4 * D), u((D, D), 4 * D),
          u(D, 4 * D)]
    for _ in range(n_blocks):
        lw += [u((D, D), D), u(D, D), u((D, D), D), u(D, D)]
    return lw


def _sparse_adj(rng, nb, ab, values):
    near = rng.random((nb, ab, ab)) < 6.0 / ab
    return (near * rng.choice(values, (nb, ab, ab))).astype(np.int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [19, 153])
def test_layer_kernels_match_plain(dev, D, dtype):
    rng = np.random.default_rng(D)
    nb, ab = 5, 256 if D == 153 else 64
    A = nb * ab
    adj = torch.from_numpy(_sparse_adj(rng, nb, ab, [1, 2])).to(dev)
    sw = bin_mp.stack_weights([[torch.from_numpy(w).to(dev) for w in _init_layer(rng, D)]], dtype)
    x = torch.from_numpy(rng.normal(size=(D, A)).astype(np.float32)).to(dev, dtype)
    gout = torch.from_numpy(rng.normal(size=(D, A)).astype(np.float32)).to(dev, dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    counters = (bin_mp.mp_layer_fwd, bin_mp.mp_layer_fwd_train, bin_mp.mp_layer_bwd,
                bin_mp.mp_stack_fwd, bin_mp.mp_stack_fwd_train, bin_mp.mp_stack_bwd)
    before = [c.launches for c in counters]
    got = bin_mp.binned_mp_layer_t(x, adj, sw, "silu")
    errs = {"serve": _rel(got, bin_mp.mp_stack_plain(x, adj, sw, "silu"))}
    spec = bin_mp.StackSpec("silu", 0.1, bin_mp.layer_drop_seed(-98765, 2) & 0xFFFFFFFF, 1)
    out = bin_mp.mp_layer_fwd_train(x, adj, sw, spec)
    errs["train"] = _rel(out, bin_mp.mp_stack_train_plain(x, adj, sw, spec)[0])
    g32, lg = bin_mp.mp_layer_bwd(x, adj, sw, spec, gout)
    rg32, rlg = bin_mp.mp_layer_bwd_plain(x, adj, sw, spec, gout)
    torch.cuda.synchronize()
    errs["dx"] = _rel(g32, rg32)
    for k, (a, r) in enumerate(zip(lg, rlg)):
        errs[f"grad {k}"] = _rel(a, r)
    print(f"D={D} {dtype}: worst {max(errs.values()):.2e}", errs)
    assert max(errs.values()) < tol
    # each form on its own counter, none on kernel 1's
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 0, 0]


def _c3_case(D, nb, ab, mb, tc, case, seed):
    """A binned config-3 round as numpy arrays: whole molecules of 4-12
    atoms per bin (padding at each bin's end), up to ``tc`` tetrahedral
    centres per bin on four atoms of one molecule (none for ``no_tet``),
    sparse bond and signed cis/trans adjacencies, integer total charges,
    and f = x[1] below the 1e-6 clip on some atoms for ``clip``."""
    rng = np.random.default_rng(seed)
    A = nb * ab
    owner = np.full((nb, ab), -1)
    tet = np.full((nb, 4, tc), -1, np.int32)
    for b in range(nb):
        a = t = 0
        for m in range(mb):
            n = int(rng.integers(4, 13))
            if a + n > ab - 4:
                break
            owner[b, a : a + n] = m
            if case != "no_tet" and t < tc and rng.random() < 0.7:
                tet[b, :, t] = a + rng.choice(n, 4, replace=False)
                t += 1
            a += n
    q = rng.integers(-1, 2, (nb, mb)).astype(np.float32)
    x = rng.normal(size=(D, A)).astype(np.float32)
    x[1] = np.abs(x[1]) + 0.05
    if case == "clip":
        x[1, ::5] = -0.3
    u = lambda s, fan: (rng.uniform(-1, 1, s) / np.sqrt(fan)).astype(np.float32)  # noqa: E731
    return dict(
        x=x,
        tca=np.where(owner >= 0, q[np.arange(nb)[:, None], np.maximum(owner, 0)], 0)
        .astype(np.float32).reshape(-1),
        pool=(owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8),
        tet_bin=tet,
        any_tet=np.array([float((tet >= 0).any())], np.float32),
        sadj=_sparse_adj(rng, nb, ab, [-1, 1]),
        adj=_sparse_adj(rng, nb, ab, [1, 2]),
        kb=u((3 * D, D), 3 * D),
        b=u(D, 3 * D),
        lws=_init_layer(rng, D),
        g=rng.normal(size=(D, A)).astype(np.float32),
        dpre=rng.normal(size=(D, A)).astype(np.float32),
    )


@pytest.mark.parametrize("case", ["tet", "no_tet", "clip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [13, 153])
def test_inject_kernels_match_plain(dev, D, dtype, case):
    from aimnet_x2d_tpu_torch.ops import bin_inject

    nb, ab, mb, tc = (6, 256, 16, 24) if D == 153 else (3, 64, 8, 8)
    c = _c3_case(D, nb, ab, mb, tc, case, D + len(case))
    t = {k: [torch.from_numpy(w).to(dev) for w in v] if k == "lws" else torch.from_numpy(v).to(dev)
         for k, v in c.items()}
    x = t["x"].to(dtype)
    tables = (t["tca"], t["pool"], t["tet_bin"], t["any_tet"], t["sadj"])
    iw = bin_inject.prep_inject(t["kb"], t["b"], t["lws"], dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    counters = (bin_inject.inject_fwd, bin_inject.inject_bwd, bin_mp.mp_layer_fwd_train,
                bin_mp.mp_layer_bwd, bin_mp.mp_layer_fwd)
    before = [k.launches for k in counters]
    # the inject kernels alone
    pre, xct = bin_inject.inject_fwd(x, *tables, iw)
    rpre, rxct = bin_inject.inject_fwd_plain(x, *tables, iw)
    dpre = bin_mp._pad_rows(t["dpre"], iw.sw.Dp).to(dtype)
    dx = bin_inject.inject_bwd(x, *tables, iw, rxct, dpre)
    rdx = bin_inject.inject_bwd_plain(x, *tables, iw, rxct, dpre)
    torch.cuda.synchronize()
    errs = {"pre": _rel(pre, rpre), "xct": _rel(xct, rxct), "dx": _rel(dx, rdx)}
    # the whole round (inject + kernel 1d), training form with dropout and
    # its backward, against the same function on CPU copies (plain versions)
    outs = {}
    for where in ("cuda", "cpu"):
        xin = x.detach().to(where).requires_grad_(True)
        ws = [w.detach().to(where).requires_grad_(True) for w in [t["kb"], t["b"], *t["lws"]]]
        out = bin_inject.binned_inject_mp_layer_train_t(
            xin, *[a.to(where) for a in tables], t["adj"].to(where), ws[0], ws[1], ws[2:], dtype,
            "silu", 0.05, -424242)
        out.backward(t["g"].to(where, dtype))
        outs[where] = [out.detach(), xin.grad] + [w.grad for w in ws]
    names = ["out", "round dx", "d_kb", "d_b"] + [f"layer grad {k}" for k in range(len(t["lws"]))]
    for n, a, r in zip(names, outs["cuda"], outs["cpu"]):
        errs[n] = _rel(a, r.to(dev))
    print(f"D={D} {dtype} {case}: worst {max(errs.values()):.2e}", errs)
    assert max(errs.values()) < tol
    assert [k.launches - b for k, b in zip(counters, before)] == [2, 2, 1, 1, 0]
    # serving form without dropout: the training form's result, bit for bit
    out0 = bin_inject.binned_inject_mp_layer_train_t(
        x, *tables, t["adj"], t["kb"], t["b"], t["lws"], dtype, "silu")
    serve = bin_inject.binned_inject_mp_layer_t(x, *tables, t["adj"], iw, "silu")
    torch.testing.assert_close(serve, out0, rtol=0, atol=0)
    assert bin_mp.mp_layer_fwd.launches == before[4] + 1


# ---- the flat layout: kernel 7 (edge aggregation) and kernel 8 (windowed
# segment sum).  fp32 outputs agree within 1e-5 relative (the same fp32
# values summed in another order); after a cast to bf16 within 1e-2.


def _flat_batch(smiles, atom_slots=None):
    """A flat batch of the featurized SMILES (3 hops) with its edge layouts,
    on the host."""
    from aimnet_x2d_tpu_torch.chem import compute_features
    from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts, collate

    feats = [compute_features(s, 3) for s in smiles]
    return attach_flat_layouts(collate(feats, np.zeros((len(feats), 1), np.float32), num_hops=3,
                                       atom_slots=atom_slots))


@pytest.fixture(scope="module")
def flat_batch():
    # a 596-atom alkane, a branched 485-atom alkane (rows of up to 28
    # edges), small molecules, and padding atom slots with no edges (zero
    # in-degree rows)
    smiles = ["C" * 198, "CC(C)(C)" * 40 + "C", "CCO", "c1ccccc1O", "C[C@H](N)C(=O)O"] * 2
    return _flat_batch(smiles, atom_slots=2400)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [153, 359])
def test_fused_edge_kernels_match_plain(dev, flat_batch, D, dtype):
    from aimnet_x2d_tpu_torch.ops import fused_edge

    g = torch.Generator(device=dev).manual_seed(D)
    fwd, bwd = flat_batch.fused_fwd.to(dev), flat_batch.fused_bwd.to(dev)
    A = flat_batch.num_atom_slots
    assert int(torch.diff(fwd.row_ptr).max()) >= 25 and int((torch.diff(fwd.row_ptr) == 0).sum()) > 0
    exact = dtype == torch.float32
    x = torch.randn(A, D, generator=g, device=dev).to(dtype)
    gout = torch.randn(A, D, generator=g, device=dev)
    before = (fused_edge.fused_edge_fwd.launches, fused_edge.fused_edge_bwd.launches)
    out = fused_edge.fused_edge_fwd(x, fwd, exact)
    dx = fused_edge.fused_edge_bwd(gout, bwd, exact)
    assert (fused_edge.fused_edge_fwd.launches, fused_edge.fused_edge_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = fused_edge.fused_edge_plain(x, fwd, exact)
    rdx = fused_edge.fused_edge_plain(gout, bwd, exact)
    torch.cuda.synchronize()
    assert out.dtype == dx.dtype == torch.float32
    assert _rel(out, ref) < 1e-5 and _rel(dx, rdx) < 1e-5
    assert _rel(out.to(dtype), ref.to(dtype)) < 1e-2 and _rel(dx.to(dtype), rdx.to(dtype)) < 1e-2
    assert torch.equal(out, fused_edge.fused_edge_fwd(x, fwd, exact))  # the same bits every run
    pad = torch.diff(fwd.row_ptr) == 0
    assert out[pad].abs().sum() == 0


def test_fused_edge_kernel_runs_on_a_batch_below_the_tpu_source_block(dev):
    """Two small molecules (24 atom slots, fewer than the TPU layout's
    128-row source block, where the JAX package falls back to XLA): the
    kernel still runs."""
    from aimnet_x2d_tpu_torch.ops import fused_edge

    b = _flat_batch(["CCO", "CC=O"]).to(dev)
    assert b.num_atom_slots < 128
    x = torch.randn(b.num_atom_slots, 153, device=dev).to(torch.bfloat16).requires_grad_(True)
    before = (fused_edge.fused_edge_fwd.launches, fused_edge.fused_edge_bwd.launches)
    out = fused_edge.fused_edge_aggregate(x, b.fused_fwd, b.fused_bwd, exact=False)
    out.backward(torch.ones_like(out))
    assert (fused_edge.fused_edge_fwd.launches, fused_edge.fused_edge_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    xc = x.detach().cpu().requires_grad_(True)
    ref = fused_edge.fused_edge_aggregate(xc, b.fused_fwd.to("cpu"), b.fused_bwd.to("cpu"), False)
    ref.backward(torch.ones_like(ref))
    torch.cuda.synchronize()
    assert _rel(out.detach().cpu(), ref.detach()) < 1e-5
    assert x.grad.dtype == torch.bfloat16 and _rel(x.grad.cpu(), xc.grad) < 1e-2


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("D", [153, 359])
def test_windowed_segment_sum_kernel_matches_plain(dev, flat_batch, D, exact):
    from aimnet_x2d_tpu_torch.ops import pallas_segment

    A = flat_batch.num_atom_slots
    src_perm, seg_local, W, cap = pallas_segment.windowed_layout(
        flat_batch.edge_src, flat_batch.edge_dst, flat_batch.edge_mask, A)
    sp, sl = torch.from_numpy(src_perm).to(dev), torch.from_numpy(seg_local).to(dev)
    x = torch.randn(A, D, generator=torch.Generator(device=dev).manual_seed(D), device=dev)
    before = pallas_segment.wseg_sum.launches
    out = pallas_segment.pallas_windowed_segment_sum(x, sp, sl, A, W, cap, exact=exact)
    assert pallas_segment.wseg_sum.launches == before + 1
    ref = pallas_segment.pallas_windowed_segment_sum(x.cpu(), sp.cpu(), sl.cpu(), A, W, cap,
                                                     exact=exact)
    torch.cuda.synchronize()
    assert out.shape == (W * 256, D)
    assert _rel(out.cpu(), ref) < 1e-5
    assert torch.equal(out, pallas_segment.pallas_windowed_segment_sum(x, sp, sl, A, W, cap,
                                                                       exact=exact))


# ---- kernel 6: the binned attention pool of row-major atom arrays (the
# route of true per-hop aggregation).  fp32 1e-5 (the same fp32 products,
# summed in another order; the weight gradients over every atom of the
# batch); bf16 5e-2 (an fp32 weight that lands on the other side of a bf16
# rounding boundary moves one atom's pooled term by 2**-8).


def _pool6_case(dev, Ds, Do, mb, dtype, seed):
    """(x_self, x_other, pool_mat, ks, ko, b, cotangents): 6 bins of 256
    atoms; bin 0 holds an empty molecule slot and a one-atom molecule (when
    mb > 2), bin 1 is all padding, every bin has atoms of no molecule."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    g = torch.Generator(device=dev).manual_seed(seed)
    nb, ab, H = 6, 256, 4
    owner = torch.randint(-1, mb, (nb, ab), generator=g, device=dev)
    if mb > 2:
        owner[0][owner[0] == mb - 1] = -1
        owner[0][owner[0] == 0] = 1
        owner[0, 7] = 0
    owner[1] = -1
    pm = (owner[:, None, :] == torch.arange(mb, device=dev)[None, :, None]).to(torch.int8)
    bin_attnpool.check_one_owner(pm)
    xs = torch.randn(nb * ab, Ds, generator=g, device=dev).to(dtype)
    xo = torch.randn(nb * ab, Do, generator=g, device=dev).to(dtype)
    ks = (torch.randn(Ds, H, generator=g, device=dev) * 0.1).to(dtype)
    ko = (torch.randn(Do, H, generator=g, device=dev) * 0.1).to(dtype)
    b = torch.randn(H, generator=g, device=dev)
    B = nb * mb
    cot = (torch.randn(B, Ds, generator=g, device=dev), torch.randn(B, Do, generator=g, device=dev),
           torch.randn(B, generator=g, device=dev))
    return xs, xo, pm, ks, ko, b, cot


@pytest.mark.parametrize("mb", [16, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(359, 153), (64, 32)])
def test_bin_pool_kernels_match_plain(dev, widths, dtype, mb):
    from aimnet_x2d_tpu_torch.ops import bin_pool

    Ds, Do = widths
    xs, xo, pm, ks, ko, b, cot = _pool6_case(dev, Ds, Do, mb, dtype, Ds + mb)
    got = bin_pool.bin_pool_fwd(xs, xo, pm, ks, ko, b)
    ref = bin_pool.pool_fwd_plain(xs, xo, pm, ks, ko, b)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for a, r in zip(got, ref):
        assert a.shape == r.shape and _rel(a, r) < tol
    empty = pm.sum(dim=2).reshape(-1) == 0  # bin 1's slots at least
    assert float(got[0][empty].abs().max()) == 0.0 and float(got[2][empty].abs().max()) == 0.0
    assert float(got[3][:, 256:512].abs().max()) == 0.0  # the padding bin
    args = (xs, xo, pm, ks, ko, ref[3], *cot)
    dxs, dxo, grads = bin_pool.bin_pool_bwd(*args)
    rdxs, rdxo, rgrads = bin_pool.pool_bwd_plain(*args)
    torch.cuda.synchronize()
    assert dxs.dtype == dtype and _rel(dxs, rdxs) < tol and _rel(dxo, rdxo) < tol
    # d_b is a sum of terms that cancel to 0: held to the scale of d_ks
    for i, (a, r) in enumerate(zip(grads, rgrads)):
        scale = float(rgrads[0].abs().max()) if i == 2 else float(r.abs().max())
        assert float((a - r).abs().max()) / scale < tol
    # two runs of the backward are bit-equal (no atomics)
    again = bin_pool.bin_pool_bwd(*args)
    for a, r in zip((dxs, dxo, *grads), (again[0], again[1], *again[2])):
        assert torch.equal(a, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bin_pool_autograd_launches_both_kernels(dev, dtype):
    from aimnet_x2d_tpu_torch.ops import bin_pool

    xs, xo, pm, ks, ko, b, cot = _pool6_case(dev, 64, 32, 16, dtype, 3)
    sk = torch.cat([ks, ko]).float().requires_grad_(True)
    sb = b.clone().requires_grad_(True)
    xs.requires_grad_(True)
    f0, b0 = bin_pool.bin_pool_fwd.launches, bin_pool.bin_pool_bwd.launches
    out = bin_pool.binned_attention_pool_fused(xs, xo, pm, sk, sb)
    torch.autograd.backward(out[:3], list(cot))
    assert (bin_pool.bin_pool_fwd.launches, bin_pool.bin_pool_bwd.launches) == (f0 + 1, b0 + 1)
    assert sk.grad.dtype == torch.float32 and xs.grad.dtype == dtype
    assert torch.isfinite(sk.grad).all() and torch.isfinite(xs.grad.float()).all()


# ---- the embedding fold (kernel 1c-vocab) at both sites: the stack's
# training forward and the projection's backward, the attention pool's
# forward and backward, with the codes and the table in place of emb.  The
# lookup is exact, so the folded forwards equal the emb forms bit for bit;
# d_bd sums the same rounded values as the plain version in another order
# (fp32 1e-4, bf16 5e-2); two backward runs give the same bits.


def _vocab_case(dev, E, nb, ab, dtype, seed, vocab=(119, 9, 7, 7)):
    """Code rows (F, A) int32 with codes outside each vocabulary, the last
    bin a padding bin (code 0 everywhere, as the loaders fill it), the fp32
    tables' block-diagonal table and its kernel form."""
    from aimnet_x2d_tpu_torch.ops import embed

    g = torch.Generator(device=dev).manual_seed(seed)
    A = nb * ab
    codes = torch.stack([torch.randint(0, v, (A,), generator=g, device=dev) for v in vocab])
    codes = codes.to(torch.int32)
    codes[0, 3], codes[1, 5], codes[2, 7], codes[3, 11] = -1, vocab[1], 1000, -(2**31)
    codes[:, (nb - 1) * ab :] = 0
    tables = [torch.randn(v, E // len(vocab), generator=g, device=dev) * 0.5 for v in vocab]
    bd = embed.blockdiag_table_t(tables)
    vt = embed.prep_vocab(bd, vocab, dtype)
    return codes, vt, embed.embed_from_codes(codes, vt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [19, 153])
def test_stack_vocab_kernels_match_plain(dev, D, dtype):
    nb, ab, E = 4, 256 if D == 153 else 64, 256 if D == 153 else 32
    adj, sw, pw, _, _, gout = _stack_train_case(dev, D, E, nb, ab, dtype, D + 7)
    adj[-1] = 0  # the padding bin
    codes, vt, emb = _vocab_case(dev, E, nb, ab, dtype, D)
    spec = bin_mp.StackSpec("silu", 0.05, 0xDEADBEEF)
    f0, e0 = bin_mp.mp_stack_fwd_train_vocab.launches, bin_mp.mp_stack_fwd_train.launches
    out, saved = bin_mp.mp_stack_fwd_train_vocab(codes, adj, sw, spec, pw, vt)
    assert bin_mp.mp_stack_fwd_train_vocab.launches == f0 + 1
    ref, ref_saved = bin_mp.mp_stack_train_plain(codes, adj, sw, spec, pw, vt)
    # the lookup is exact: the emb form computes the same bits
    out_e, saved_e = bin_mp.mp_stack_fwd_train(emb, adj, sw, spec, pw)
    assert bin_mp.mp_stack_fwd_train.launches == e0 + 1
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert _rel(out, ref) < tol
    assert torch.equal(out, out_e) and all(torch.equal(a, b) for a, b in zip(saved, saved_e))
    g32 = torch.randn(sw.Dp, nb * ab, generator=torch.Generator(device=dev).manual_seed(D),
                      device=dev) * 0.1
    g32[sw.D :] = 0
    b0 = bin_mp.mp_stack_bwd_vocab.launches
    got = bin_mp.mp_stack_bwd_vocab(codes, g32.clone(), pw, vt, "silu", ab)
    assert bin_mp.mp_stack_bwd_vocab.launches == b0 + 1
    want = bin_mp.mp_stack_bwd_vocab_plain(codes, g32.clone(), pw, vt, "silu")
    again = bin_mp.mp_stack_bwd_vocab(codes, g32.clone(), pw, vt, "silu", ab)
    torch.cuda.synchronize()
    errs = {n: _rel(a, r) for n, a, r in zip(("d_bd", "dkbT", "dbb"), got, want)}
    print(f"D={D} {dtype}: {errs}")
    assert max(errs.values()) < tol
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the whole folded backward (walk + 1c-vocab) through autograd
    w0 = bin_mp.mp_stack_bwd.launches
    dx, lg, pg = bin_mp.mp_stack_bwd(codes, adj, sw, spec, saved, gout, pw, vt)
    rdx, rlg, rpg = bin_mp.mp_stack_bwd_plain(codes, adj, sw, spec, ref_saved, gout, pw, vt)
    torch.cuda.synchronize()
    assert bin_mp.mp_stack_bwd.launches == w0 + 1
    assert _rel(dx, rdx) < tol and max(_rel(a, r) for a, r in zip(pg, rpg)) < tol


@pytest.mark.parametrize("mb", [16, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(359, 153, 256, 256), (21, 13, 32, 64)])
def test_attnpool_vocab_kernels_match_plain(dev, dtype, shape, mb):
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    Ds, Do, E, ab = shape
    nb, H = 5, 4
    g = torch.Generator(device=dev).manual_seed(Ds + mb)
    owner = torch.randint(-1, mb, (nb, ab), generator=g, device=dev)
    owner[-1] = -1  # the padding bin: no molecule
    pm = (owner[:, None, :] == torch.arange(mb, device=dev)[None, :, None]).to(torch.int8)
    codes, vt, emb = _vocab_case(dev, E, nb, ab, dtype, Ds + mb)
    xo = torch.randn(Do, nb * ab, generator=g, device=dev).to(dtype)
    r = lambda *s: (torch.rand(*s, generator=g, device=dev) - 0.5) * 0.4  # noqa: E731
    w = bin_attnpool.prep_weights(r(E, Ds), r(Ds), r(Ds, H), r(Do, H), r(H), dtype)
    f0 = bin_attnpool.attnpool_fwd_vocab.launches
    got = bin_attnpool.attnpool_fwd_vocab(codes, xo, pm, w, "silu", vt)
    assert bin_attnpool.attnpool_fwd_vocab.launches == f0 + 1
    ref = bin_attnpool.attnpool_fwd_vocab_plain(codes, xo, pm, w, "silu", vt)
    emb_form = bin_attnpool.attnpool_fwd(emb, xo, pm, w, "silu")
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for a, b, e in zip(got, ref, emb_form):
        assert _rel(a, b) < tol and torch.equal(a, e)
    gps = torch.randn(Ds, nb * mb, generator=g, device=dev)
    gpo = torch.randn(Do, nb * mb, generator=g, device=dev)
    gcov = torch.randn(nb * mb, generator=g, device=dev)
    args = (codes, xo, pm, w, "silu", ref[3], gps, gpo, gcov, vt)
    b0 = bin_attnpool.attnpool_bwd_vocab.launches
    d_bd, dxo, grads = bin_attnpool.attnpool_bwd_vocab(*args)
    assert bin_attnpool.attnpool_bwd_vocab.launches == b0 + 1
    rd_bd, rdxo, rgrads = bin_attnpool.attnpool_bwd_vocab_plain(*args)
    again = bin_attnpool.attnpool_bwd_vocab(*args)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    errs = {"d_bd": _rel(d_bd, rd_bd), "dxo": _rel(dxo, rdxo)}
    # d_sb is a sum of terms that cancel to 0: held to the scale of d_ks
    for i, (a, b) in enumerate(zip(grads, rgrads)):
        scale = float(rgrads[2].abs().max()) if i == 4 else float(b.abs().max())
        errs[f"grad {i}"] = float((a - b).abs().max()) / scale
    print(f"{shape} {dtype} mb={mb}: {errs}")
    assert max(errs.values()) < tol
    for a, b in zip((d_bd, dxo, *grads), (again[0], again[1], *again[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_autograd_launches_only_the_folded_kernels(dev, dtype):
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, embed

    nb, ab, D, E, Ds, mb, H = 3, 64, 19, 32, 21, 8, 4
    adj, sw, _, _, _, _ = _stack_train_case(dev, D, E, nb, ab, dtype, 5)
    codes, _, _ = _vocab_case(dev, E, nb, ab, dtype, 5)
    g = torch.Generator(device=dev).manual_seed(6)
    tables = [(torch.randn(v, E // 4, generator=g, device=dev) * 0.5).requires_grad_(True)
              for v in (119, 9, 7, 7)]
    spec = (codes, embed.blockdiag_table_t(tables), (119, 9, 7, 7))
    layers = [[torch.from_numpy(w).to(dev).requires_grad_(True)
               for w in _init_layer(np.random.default_rng(l), D)] for l in range(2)]

    def r(*shape):
        return ((torch.rand(*shape, generator=g, device=dev) - 0.5) * 0.4).requires_grad_(True)

    kb, bb = r(E, D), r(D)
    counters = (bin_mp.mp_stack_fwd_train_vocab, bin_mp.mp_stack_bwd, bin_mp.mp_stack_bwd_vocab,
                bin_mp.mp_stack_fwd_train, bin_attnpool.attnpool_fwd_vocab,
                bin_attnpool.attnpool_bwd_vocab, bin_attnpool.attnpool_fwd,
                bin_attnpool.attnpool_bwd)
    before = [c.launches for c in counters]
    xo = bin_mp.binned_mp_stack_train_t(None, adj, layers, dtype, "silu", 0.05, 7,
                                        proj_weights=(kb, bb), embed_spec=spec)
    owner = torch.randint(-1, mb, (nb, ab), generator=g, device=dev)
    pm = (owner[:, None, :] == torch.arange(mb, device=dev)[None, :, None]).to(torch.int8)
    ps, po, cov, _ = bin_attnpool.binned_attnpool_proj_t(
        None, r(E, Ds), r(Ds), "silu", xo, pm, r(Ds, H), r(D, H), r(H), embed_spec=spec)
    (ps.sum() + po.sum() + cov.sum()).backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 0, 1, 1, 0, 0]
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in tables)
    assert kb.grad.dtype == torch.float32 and torch.isfinite(kb.grad).all()
