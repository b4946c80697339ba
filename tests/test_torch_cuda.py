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
