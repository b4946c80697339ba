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
from chip_smoke import rand_pm  # one-hot, or not (multi): the pool matrices chip_smoke checks

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


# (nb, ab, D): the flagship's widths (D 359 and 153), ab 64 and 256, one
# bin, one feature row
WPOOL_SHAPES = [(7, 256, 359), (7, 256, 153), (5, 64, 153), (1, 256, 1), (1, 64, 359)]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("shape", WPOOL_SHAPES)
@pytest.mark.parametrize("mb", [5, 16, 20, 44, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wpool_kernel_matches_plain(dev, dtype, mb, shape, multi):
    """Kernel 2: the same rounded products as the plain version, summed in
    fp32 in another order (1e-5); a rerun bit-equal.  mb 70 takes two slot
    groups; ``multi``: atoms in two slots (values 2 and -1), an empty
    slot."""
    nb, ab, D = shape
    g = torch.Generator(device=dev).manual_seed(mb * 100 + D + ab + multi)
    pm = rand_pm(nb, mb, ab, g, multi)
    x = torch.randn(D, nb * ab, generator=g, device=dev).to(dtype)
    w = torch.rand(nb * ab, generator=g, device=dev)
    before = bin_wpool.wpool_fwd.launches
    got = bin_wpool.binned_wpool_t(x, w, pm)
    assert bin_wpool.wpool_fwd.launches == before + 1
    ref = bin_wpool.wpool_plain(x, w, pm)
    again = bin_wpool.wpool_fwd(x, w, pm)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("need_dw", [True, False])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("shape", WPOOL_SHAPES)
@pytest.mark.parametrize("mb", [5, 16, 20, 44, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wpool_bwd_kernel_matches_plain(dev, dtype, mb, shape, multi, need_dw):
    """Kernel 2b: dx is the rounded cotangent summed over the atom's slots
    in fp32 times w, as the plain version computes it; dw sums fp32
    products over D in another order (1e-5).  dx and dw bit-equal on a
    rerun, dx the same with and without dw."""
    nb, ab, D = shape
    g = torch.Generator(device=dev).manual_seed(100 + mb * 100 + D + ab + multi)
    pm = rand_pm(nb, mb, ab, g, multi)
    w = torch.rand(nb * ab, generator=g, device=dev) * (pm != 0).any(1).reshape(-1)
    x = torch.randn(D, nb * ab, generator=g, device=dev).to(dtype)
    gout = torch.randn(D, nb * mb, generator=g, device=dev)
    before = bin_wpool.wpool_bwd.launches
    dx, dw = bin_wpool.wpool_bwd(x, w, pm, gout, need_dw)
    assert bin_wpool.wpool_bwd.launches == before + 1
    rdx, rdw = bin_wpool.wpool_bwd_plain(x, w, pm, gout, need_dw)
    dx2, dw2 = bin_wpool.wpool_bwd(x, w, pm, gout, need_dw)
    dx3, _ = bin_wpool.wpool_bwd(x, w, pm, gout, not need_dw)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and _rel(dx, rdx) < 1e-5
    assert torch.equal(dx, dx2) and torch.equal(dx, dx3)
    if need_dw:
        assert dw.dtype == torch.float32 and _rel(dw, rdw) < 1e-5
        assert torch.equal(dw, dw2)  # fixed order
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


def _stack_train_case(dev, D, E, nb, ab, dtype, seed, n_blocks=2):
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
        for _ in range(n_blocks):
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


# (ab, nb, dropout on, activation, MLP blocks) of the backward walk's
# cases, the first the original one: ab None is 256 at D 153 and 64 at D 19;
# ab 256 by 5 bins is 20 blocks in clusters of 4 (no whole wave), by 37
# bins 148 blocks (one wave and a bit)
WALK_CASES = [(None, 5, True, "silu", 2), (64, 1, False, "relu", 1), (128, 3, True, "gelu", 2),
              (256, 1, False, "silu", 1), (256, 37, True, "relu", 2)]
WALK_IDS = [f"ab{a}-nb{n}-{'drop' if d else 'nodrop'}-{f}-k{k}" for a, n, d, f, k in WALK_CASES]


@pytest.mark.parametrize("case", WALK_CASES, ids=WALK_IDS)
@pytest.mark.parametrize("proj", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [19, 153])
def test_stack_train_kernels_match_plain(dev, D, dtype, proj, case):
    ab, nb, drop, act, n_blocks = case
    ab, rate = ab or (256 if D == 153 else 64), 0.05 if drop else 0.0
    E = 256 if D == 153 else 32
    adj, sw, pw, emb, x, gout = _stack_train_case(dev, D, E, nb, ab, dtype, D + 1, n_blocks)
    spec = bin_mp.StackSpec(act, rate, 0xDEADBEEF)
    xin, pw_ = (emb, pw) if proj else (x, None)
    out, saved = bin_mp.mp_stack_fwd_train(xin, adj, sw, spec, pw_)
    ref, ref_saved = bin_mp.mp_stack_train_plain(xin, adj, sw, spec, pw_)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert _rel(out, ref) < tol
    for s_, r_ in zip(saved, ref_saved):
        assert _rel(s_, r_) < tol
    b0, w0 = bin_mp.mp_stack_bwd.launches, bin_mp.wgrad_group.launches
    dx, lg, pg = bin_mp.mp_stack_bwd(xin, adj, sw, spec, saved, gout, pw_)
    assert bin_mp.mp_stack_bwd.launches == b0 + 1
    # one grouped contraction a layer, and one for the fold
    assert bin_mp.wgrad_group.launches == w0 + 3 + int(proj)
    rdx, rlg, rpg = bin_mp.mp_stack_bwd_plain(xin, adj, sw, spec, ref_saved, gout, pw_)
    again = bin_mp.mp_stack_bwd(xin, adj, sw, spec, saved, gout, pw_)
    torch.cuda.synchronize()
    errs = {"dx": _rel(dx, rdx)}
    for l, (got_l, ref_l) in enumerate(zip(lg, rlg)):
        for k, (got, r) in enumerate(zip(got_l, ref_l)):
            errs[f"layer {l} grad {k}"] = _rel(got, r)
    for k, (got, r) in enumerate(zip(pg or (), rpg or ())):
        errs[f"proj grad {k}"] = _rel(got, r)
    print(f"D={D} {dtype} proj={proj} {case}: worst {max(errs.values()):.2e}", errs)
    assert max(errs.values()) < tol
    # fixed-order sums: a rerun gives the same bits
    flat = lambda r: [r[0], *(t for l_ in r[1] for t in l_), *(r[2] or ())]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat((dx, lg, pg)), flat(again)))


def test_stack_serving_unchanged_by_training_form(dev):
    """Without dropout, the training forward computes the serving forward."""
    adj, sw, _, _, x, _ = _stack_train_case(dev, 153, 256, 3, 256, torch.bfloat16, 3)
    out, _ = bin_mp.mp_stack_fwd_train(x, adj, sw, bin_mp.StackSpec("silu"))
    torch.testing.assert_close(out, bin_mp.mp_stack_fwd(x, adj, sw, "silu"), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(359, 153, 256, 16, 256), (21, 13, 32, 12, 64)])
def test_attnpool_kernels_match_plain(dev, dtype, shape):
    """Kernel 3 against its plain versions; molecules scattered over each
    bin, so across its 64-atom tiles.  bf16 runs the tiled backward, fp32
    the kernel of one block per bin; both take d_kb from one grouped
    contraction a call; the backward twice, bit-equal."""
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
    args = (emb, xo, pm, w, "silu", ref[3], gps, gpo, gcov)
    b0, g0 = bin_attnpool.attnpool_bwd.launches, bin_mp.wgrad_group.launches
    demb, dxo, grads = bin_attnpool.attnpool_bwd(*args)
    again = bin_attnpool.attnpool_bwd(*args)
    assert (bin_attnpool.attnpool_bwd.launches, bin_mp.wgrad_group.launches) == (b0 + 2, g0 + 2)
    rdemb, rdxo, rgrads = bin_attnpool.attnpool_bwd_plain(*args)
    torch.cuda.synchronize()
    Dsp = w.kbT.shape[0]
    key = (int(dtype == torch.bfloat16), Dsp, E, H, Ds, Do, mb, ab, 0)
    assert bin_attnpool._BWD_TILES[key] == (dtype == torch.bfloat16)
    assert _rel(demb, rdemb) < tol and _rel(dxo, rdxo) < tol
    # d_sb is a sum of terms that cancel to 0: held to the scale of d_ks
    for i, (a, b) in enumerate(zip(grads, rgrads)):
        scale = float(rgrads[2].abs().max()) if i == 4 else float(b.abs().max())
        assert float((a - b).abs().max()) / scale < tol
    for a, b in zip((demb, dxo, *grads), (again[0], again[1], *again[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_group_matches_matmul(dev, dtype):
    """The grouped contraction against fp32 matmuls and row sums: the walk's
    shapes (M 160 by N 320 and 160), a product whose M is not a multiple of
    64, one past GROUP_MAX products (two launches), a bias source, and two
    gathered products (X looked up from code rows and a table: the attention
    pool's M 368 and the stack fold's M 160 with a bias source)."""
    from aimnet_x2d_tpu_torch.ops import embed

    g = torch.Generator(device=dev).manual_seed(1)
    A = 10 * 1024
    r = lambda m: torch.randn(m, A, generator=g, device=dev)  # noqa: E731
    codes, vt, _ = _vocab_case(dev, 256, 40, 256, dtype, 3)
    gx = bin_mp.GatheredX(codes, vt)
    shapes = [(160, 320), (160, 320), (160, 160), (160, 160), (48, 16), (32, 64)]
    prods = [(r(m).to(dtype), r(n).to(dtype), None) for m, n in shapes]
    prods.append((r(160).to(dtype), r(256).to(dtype), r(160)))
    prods += [(r(368).to(dtype), gx, None), (r(160).to(dtype), gx, r(160))]
    prods += [(r(16).to(dtype), r(16).to(dtype), None)] * (bin_mp.GROUP_MAX - len(prods) + 1)
    before = bin_mp.wgrad_group.launches
    got = bin_mp.wgrad_group(prods)
    assert bin_mp.wgrad_group.launches == before + 1
    for (dw, db), (dY, X, b) in zip(got, prods):
        Xd = embed.embed_from_codes(X.codes, X.vt) if isinstance(X, bin_mp.GatheredX) else X
        assert _rel(dw, dY.float() @ Xd.float().T) < 1e-4
        assert _rel(db, (b if b is not None else dY.float()).sum(1)) < 1e-4
    again = bin_mp.wgrad_group(prods)
    assert all(torch.equal(a, b) for p, q in zip(got, again) for a, b in zip(p, q))
    with pytest.raises(ValueError):  # rows not a multiple of 16
        bin_mp.wgrad_group([(r(24).to(dtype), r(32).to(dtype), None)])
    with pytest.raises(TypeError):  # mixed dtypes
        bin_mp.wgrad_group([(r(16).to(dtype), r(16).half(), None)])


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


@pytest.mark.parametrize("case", WALK_CASES, ids=WALK_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [19, 153])
def test_layer_kernels_match_plain(dev, D, dtype, case):
    ab, nb, drop, act, n_blocks = case
    rng = np.random.default_rng(D)
    ab, rate = ab or (256 if D == 153 else 64), 0.1 if drop else 0.0
    A = nb * ab
    adj = torch.from_numpy(_sparse_adj(rng, nb, ab, [1, 2])).to(dev)
    sw = bin_mp.stack_weights([[torch.from_numpy(w).to(dev) for w in _init_layer(rng, D, n_blocks)]],
                              dtype)
    x = torch.from_numpy(rng.normal(size=(D, A)).astype(np.float32)).to(dev, dtype)
    gout = torch.from_numpy(rng.normal(size=(D, A)).astype(np.float32)).to(dev, dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    counters = (bin_mp.mp_layer_fwd, bin_mp.mp_layer_fwd_train, bin_mp.mp_layer_bwd,
                bin_mp.mp_stack_fwd, bin_mp.mp_stack_fwd_train, bin_mp.mp_stack_bwd)
    before = [c.launches for c in counters]
    got = bin_mp.binned_mp_layer_t(x, adj, sw, act)
    errs = {"serve": _rel(got, bin_mp.mp_stack_plain(x, adj, sw, act))}
    spec = bin_mp.StackSpec(act, rate, bin_mp.layer_drop_seed(-98765, 2) & 0xFFFFFFFF, 1)
    out = bin_mp.mp_layer_fwd_train(x, adj, sw, spec)
    errs["train"] = _rel(out, bin_mp.mp_stack_train_plain(x, adj, sw, spec)[0])
    w0 = bin_mp.wgrad_group.launches
    g32, lg = bin_mp.mp_layer_bwd(x, adj, sw, spec, gout)
    assert bin_mp.wgrad_group.launches == w0 + 1  # the layer's weight grads: one contraction
    rg32, rlg = bin_mp.mp_layer_bwd_plain(x, adj, sw, spec, gout)
    g32b, lgb = bin_mp.mp_layer_bwd(x, adj, sw, spec, gout)
    torch.cuda.synchronize()
    errs["dx"] = _rel(g32, rg32)
    for k, (a, r) in enumerate(zip(lg, rlg)):
        errs[f"grad {k}"] = _rel(a, r)
    print(f"D={D} {dtype} {case}: worst {max(errs.values()):.2e}", errs)
    assert max(errs.values()) < tol
    assert torch.equal(g32, g32b) and all(torch.equal(a, b) for a, b in zip(lg, lgb))
    # each form on its own counter, none on kernel 1's
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 2, 0, 0, 0]


def _c3_case(D, nb, ab, mb, tc, case, seed):
    """A binned config-3 round as numpy arrays: whole molecules of 4-12
    atoms per bin (padding at each bin's end), up to ``tc`` tetrahedral
    centres per bin on four atoms of one molecule (none for ``no_tet``),
    sparse bond and signed cis/trans adjacencies, integer total charges,
    and f = x[1] below the 1e-6 clip on some atoms for ``clip``.  Where a
    molecule spans atoms 63 and 64 (two 64-atom tiles of the tiled
    backward), the last centre slot of the bin is a centre on both."""
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
        if case != "no_tet" and ab > 64 and owner[b, 63] >= 0 and owner[b, 63] == owner[b, 64]:
            rest = [i for i in np.flatnonzero(owner[b] == owner[b, 63]) if i not in (63, 64)]
            tet[b, :, tc - 1] = [63, 64, *rng.choice(rest, 2, replace=False)]
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
    """Kernel 4 against its plain versions: the inject kernels alone, then
    the whole round (inject + kernel 1d) forward and backward against the
    same function on the CPU.  bf16 runs the tiled kernels, forward and
    backward (bins of 2 and 4 tiles, molecules and centres across tile
    borders), fp32 the kernels of one block per bin; d_kb and d_b join
    kernel 1d's one grouped contraction.  The forward, the backward alone and
    the round's backward twice, bit-equal; the tiled forward's x' rows equal
    the plain version's."""
    from aimnet_x2d_tpu_torch.ops import bin_inject

    nb, ab, mb, tc = (6, 256, 16, 24) if D == 153 else (3, 128, 12, 8)
    c = _c3_case(D, nb, ab, mb, tc, case, D + len(case))
    if case != "no_tet":  # a centre whose neighbours lie in two tiles
        tiles = np.where(c["tet_bin"] >= 0, c["tet_bin"] // 64, -1)
        assert ((tiles.max(1) > tiles.min(1)) & (c["tet_bin"].min(1) >= 0)).any()
    t = {k: [torch.from_numpy(w).to(dev) for w in v] if k == "lws" else torch.from_numpy(v).to(dev)
         for k, v in c.items()}
    x = t["x"].to(dtype)
    tables = (t["tca"], t["pool"], t["tet_bin"], t["any_tet"], t["sadj"])
    iw = bin_inject.prep_inject(t["kb"], t["b"], t["lws"], dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    counters = (bin_inject.inject_fwd, bin_inject.inject_bwd, bin_mp.mp_layer_fwd_train,
                bin_mp.mp_layer_bwd, bin_mp.mp_layer_fwd, bin_mp.wgrad_group)
    before = [k.launches for k in counters]
    # the inject kernels alone
    pre, xct = bin_inject.inject_fwd(x, *tables, iw)
    pre2, xct2 = bin_inject.inject_fwd(x, *tables, iw)
    rpre, rxct = bin_inject.inject_fwd_plain(x, *tables, iw)
    dpre = bin_mp._pad_rows(t["dpre"], iw.sw.Dp).to(dtype)
    dx = bin_inject.inject_bwd(x, *tables, iw, rxct, dpre)
    dx2 = bin_inject.inject_bwd(x, *tables, iw, rxct, dpre)
    rdx = bin_inject.inject_bwd_plain(x, *tables, iw, rxct, dpre)
    torch.cuda.synchronize()
    key = (int(dtype == torch.bfloat16), iw.sw.Dp, mb, ab, tc)
    assert bin_inject._FWD_TILES[key] == bin_inject._BWD_TILES[key] == (dtype == torch.bfloat16)
    assert torch.equal(pre, pre2) and torch.equal(xct, xct2) and torch.equal(dx, dx2)
    if dtype == torch.bfloat16:  # x' is formed by the same fp32 sums, rounded once
        assert torch.equal(xct[: iw.sw.Dp], rxct[: iw.sw.Dp])
    errs = {"pre": _rel(pre, rpre), "xct": _rel(xct, rxct), "dx": _rel(dx, rdx)}
    # the whole round (inject + kernel 1d), training form with dropout and
    # its backward, against the same function on CPU copies (plain versions)
    outs = {}
    for where in ("cuda", "cuda", "cpu"):
        xin = x.detach().to(where).requires_grad_(True)
        ws = [w.detach().to(where).requires_grad_(True) for w in [t["kb"], t["b"], *t["lws"]]]
        out = bin_inject.binned_inject_mp_layer_train_t(
            xin, *[a.to(where) for a in tables], t["adj"].to(where), ws[0], ws[1], ws[2:], dtype,
            "silu", 0.05, -424242)
        out.backward(t["g"].to(where, dtype))
        got = [out.detach(), xin.grad] + [w.grad for w in ws]
        if where in outs:  # the second card run: the same bits
            assert all(torch.equal(a, b) for a, b in zip(got, outs[where]))
        outs[where] = got
    names = ["out", "round dx", "d_kb", "d_b"] + [f"layer grad {k}" for k in range(len(t["lws"]))]
    for n, a, r in zip(names, outs["cuda"], outs["cpu"]):
        errs[n] = _rel(a, r.to(dev))
    print(f"D={D} {dtype} {case}: worst {max(errs.values()):.2e}", errs)
    assert max(errs.values()) < tol
    # two card rounds: each one inject forward and backward, one layer
    # forward and backward, one grouped contraction (the layer's products
    # and the inject's)
    assert [k.launches - b for k, b in zip(counters, before)] == [4, 4, 2, 2, 0, 2]
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
    """1c-vocab at the pool's site against its plain versions and the emb
    form; molecules scattered over each bin.  bf16 runs the tiled backward,
    fp32 the kernel of one block per bin; both take d_kb from one grouped
    contraction a call (the embeddings gathered); the backward twice,
    bit-equal."""
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
    b0, g0 = bin_attnpool.attnpool_bwd_vocab.launches, bin_mp.wgrad_group.launches
    d_bd, dxo, grads = bin_attnpool.attnpool_bwd_vocab(*args)
    assert bin_attnpool.attnpool_bwd_vocab.launches == b0 + 1
    rd_bd, rdxo, rgrads = bin_attnpool.attnpool_bwd_vocab_plain(*args)
    again = bin_attnpool.attnpool_bwd_vocab(*args)
    assert bin_mp.wgrad_group.launches == g0 + 2
    torch.cuda.synchronize()
    key = (int(dtype == torch.bfloat16), w.kbT.shape[0], E, H, Ds, Do, mb, ab,
           vt.Df * vt.offsets[-1])
    assert bin_attnpool._BWD_TILES[key] == (dtype == torch.bfloat16)
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


# The attention pool's bf16 forward on tiles (attnpool_fwd_tile_kernel: a
# cluster of 64-atom tiles per bin, both forms): (Ds, Do, E, nb, mb, ab),
# clusters of 1, 2, 4 and 8; molecules scattered over each bin, so across
# its tiles, and a padding bin.  Same tolerances as the kernel of one block
# a bin: 5e-2 bf16.

POOL_FWD_SHAPES = [(359, 153, 256, 6, 16, 256), (21, 13, 32, 5, 12, 64), (21, 13, 32, 4, 8, 128),
                   (40, 24, 32, 3, 20, 512)]


def _pool_fwd_case(dev, shape, dtype=torch.bfloat16, H=4):
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    Ds, Do, E, nb, mb, ab = shape
    g = torch.Generator(device=dev).manual_seed(Ds + ab)
    owner = torch.randint(-1, mb - 1, (nb, ab), generator=g, device=dev)
    owner[-1] = -1  # the padding bin: no molecule
    pm = (owner[:, None, :] == torch.arange(mb, device=dev)[None, :, None]).to(torch.int8)
    codes, vt, emb = _vocab_case(dev, E, nb, ab, dtype, Ds + ab)
    xo = torch.randn(Do, nb * ab, generator=g, device=dev).to(dtype)
    r = lambda *s: (torch.rand(*s, generator=g, device=dev) - 0.5) * 0.4  # noqa: E731
    w = bin_attnpool.prep_weights(r(E, Ds), r(Ds), r(Ds, H), r(Do, H), r(H), dtype)
    return emb, codes, vt, xo, pm, w


def _kernel_names(fn):
    """{profiler kernel name: launches} of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _fwd_routes(fn):
    """(tiled, one block a bin) forward launches of one call of ``fn``, by
    the wrapper's route counts."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    routes = bin_attnpool._launch_fwd.routes
    before = dict(routes)
    fn()
    return routes["tiles"] - before["tiles"], routes["bins"] - before["bins"]


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("shape", POOL_FWD_SHAPES)
def test_attnpool_fwd_tiles_match_plain(dev, shape, fold):
    """bf16 runs the tiled forward, one launch a call; reruns bit-equal; the
    vocab form bit-equal to the emb form."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    emb, codes, vt, xo, pm, w = _pool_fwd_case(dev, shape)
    if fold:
        run = lambda: bin_attnpool.attnpool_fwd_vocab(codes, xo, pm, w, "silu", vt)  # noqa: E731
        counter = bin_attnpool.attnpool_fwd_vocab
    else:
        run = lambda: bin_attnpool.attnpool_fwd(emb, xo, pm, w, "silu")  # noqa: E731
        counter = bin_attnpool.attnpool_fwd
    n0 = counter.launches
    got, again = run(), run()
    assert counter.launches == n0 + 2
    want = bin_attnpool.attnpool_fwd_plain(emb, xo, pm, w, "silu")
    emb_form = bin_attnpool.attnpool_fwd(emb, xo, pm, w, "silu")
    torch.cuda.synchronize()
    Ds, Do, E, nb, mb, ab = shape
    assert bin_attnpool._FWD_TILES[(1, w.kbT.shape[0], E, 4, Ds, Do, mb, ab)]
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, emb_form))
    errs = [_rel(a, r) for a, r in zip(got, want)]
    print(f"{shape} fold={fold}: {errs}")
    assert max(errs) < 5e-2
    names = _kernel_names(run)
    assert sum(v for k, v in names.items() if "attnpool_fwd_tile_kernel" in k) == 1
    assert not any("attnpool_fwd_kernel" in k for k in names)
    assert _fwd_routes(run) == (1, 0)


@pytest.mark.parametrize("fold", [False, True])
def test_attnpool_fwd_tiles_feed_the_backward(dev, fold):
    """The tiled backward on the tiled forward's attn gives the plain
    chain's gradients; the weight stream gathered once serves both."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    emb, codes, vt, xo, pm, w = _pool_fwd_case(dev, POOL_FWD_SHAPES[0])
    g = torch.Generator(device=dev).manual_seed(3)
    Ds, Do, B = w.Ds, xo.shape[0], pm.shape[0] * pm.shape[1]
    gs = (torch.randn(Ds, B, generator=g, device=dev), torch.randn(Do, B, generator=g, device=dev),
          torch.randn(B, generator=g, device=dev))
    ws = bin_attnpool.pool_stream(w)
    if fold:
        attn = bin_attnpool.attnpool_fwd_vocab(codes, xo, pm, w, "silu", vt, ws)[3]
        got = bin_attnpool.attnpool_bwd_vocab(codes, xo, pm, w, "silu", attn, *gs, vt, ws)
        ref_attn = bin_attnpool.attnpool_fwd_vocab_plain(codes, xo, pm, w, "silu", vt)[3]
        want = bin_attnpool.attnpool_bwd_vocab_plain(codes, xo, pm, w, "silu", ref_attn, *gs, vt)
    else:
        attn = bin_attnpool.attnpool_fwd(emb, xo, pm, w, "silu", ws)[3]
        got = bin_attnpool.attnpool_bwd(emb, xo, pm, w, "silu", attn, *gs, ws)
        ref_attn = bin_attnpool.attnpool_fwd_plain(emb, xo, pm, w, "silu")[3]
        want = bin_attnpool.attnpool_bwd_plain(emb, xo, pm, w, "silu", ref_attn, *gs)
    torch.cuda.synchronize()
    errs = {"d_emb": _rel(got[0], want[0]), "dxo": _rel(got[1], want[1])}
    # d_sb is a sum of terms that cancel to 0: held to the scale of d_ks
    for i, (a, b) in enumerate(zip(got[2], want[2])):
        scale = float(want[2][2].abs().max()) if i == 4 else float(b.abs().max())
        errs[f"grad {i}"] = float((a - b).abs().max()) / scale
    print(f"fold={fold}: {errs}")
    assert max(errs.values()) < 5e-2


@pytest.mark.parametrize("case", ["fp32", "fp32_fold", "wide", "wide_fold"])
def test_attnpool_fwd_old_kernel_takes_what_the_tiles_do_not(dev, case):
    """fp32, and bf16 past the tiles (ab 576: a cluster of 9), run the
    kernel of one block a bin, by the profiler's kernel names."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    shape = (21, 13, 32, 3, 8, 64 if dtype == torch.float32 else 576)
    emb, codes, vt, xo, pm, w = _pool_fwd_case(dev, shape, dtype)
    if case.endswith("fold"):
        run = lambda: bin_attnpool.attnpool_fwd_vocab(codes, xo, pm, w, "relu", vt)  # noqa: E731
    else:
        run = lambda: bin_attnpool.attnpool_fwd(emb, xo, pm, w, "relu")  # noqa: E731
    got = run()
    want = bin_attnpool.attnpool_fwd_plain(emb, xo, pm, w, "relu")
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert max(_rel(a, r) for a, r in zip(got, want)) < tol
    names = _kernel_names(run)
    assert sum(v for k, v in names.items() if "attnpool_fwd_kernel" in k) == 1
    assert not any("attnpool_fwd_tile_kernel" in k for k in names)
    assert _fwd_routes(run) == (0, 1)


def test_attnpool_autograd_gathers_the_stream_once(dev, monkeypatch):
    """A bf16 step through binned_attnpool_proj_t gathers kb^T's and kb's
    stream once, for the tiled forward and backward both."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    emb, _, _, xo, pm, _ = _pool_fwd_case(dev, POOL_FWD_SHAPES[1])
    g = torch.Generator(device=dev).manual_seed(4)
    E, Ds, Do, H = emb.shape[0], 21, xo.shape[0], 4

    def r(*shape):
        return ((torch.rand(*shape, generator=g, device=dev) - 0.5) * 0.4).requires_grad_(True)

    gathers = []
    real = bin_attnpool.pool_stream
    monkeypatch.setattr(bin_attnpool, "pool_stream", lambda w: gathers.append(1) or real(w))
    f0, b0 = bin_attnpool.attnpool_fwd.launches, bin_attnpool.attnpool_bwd.launches
    kb = r(E, Ds)
    ps, po, cov, _ = bin_attnpool.binned_attnpool_proj_t(emb, kb, r(Ds), "silu", xo, pm, r(Ds, H),
                                                         r(Do, H), r(H))
    (ps.sum() + po.sum() + cov.sum()).backward()
    torch.cuda.synchronize()
    assert len(gathers) == 1
    assert bin_attnpool.attnpool_fwd.launches - f0 == 1
    assert bin_attnpool.attnpool_bwd.launches - b0 == 1
    assert torch.isfinite(kb.grad).all()


def test_attnpool_autograd_gathers_no_stream_past_the_tiles(dev, monkeypatch):
    """A bf16 step at a shape neither tiled kernel takes (ab 576: a cluster
    of 9) gathers no weight stream and runs the kernels of one block a bin."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    emb, _, _, xo, pm, _ = _pool_fwd_case(dev, (21, 13, 32, 3, 8, 576))
    g = torch.Generator(device=dev).manual_seed(5)

    def r(*shape):
        return ((torch.rand(*shape, generator=g, device=dev) - 0.5) * 0.4).requires_grad_(True)

    gathers = []
    real = bin_attnpool.pool_stream
    monkeypatch.setattr(bin_attnpool, "pool_stream", lambda w: gathers.append(1) or real(w))
    kb = r(32, 21)
    step = lambda: bin_attnpool.binned_attnpool_proj_t(  # noqa: E731
        emb, kb, r(21), "silu", xo, pm, r(21, 4), r(13, 4), r(4))
    assert _fwd_routes(step) == (0, 1)
    ps, po, cov, _ = step()
    (ps.sum() + po.sum() + cov.sum()).backward()
    torch.cuda.synchronize()
    assert not gathers
    assert torch.isfinite(kb.grad).all()


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


def _ext_layer(dev, D, g, n_blocks=2):
    shapes = [(D, D), (D, D), (D,), (D, D), (D, D), (D,)] + [(D, D), (D,), (D, D), (D,)] * n_blocks
    return [(torch.rand(s, generator=g, device=dev) - 0.5) * 0.4 for s in shapes]


@pytest.mark.parametrize("rate", [0.0, 0.05])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [19, 153])
def test_ext_layer_kernels_match_plain(dev, D, dtype, rate):
    """Kernel 5 (csrc/mp_ext.cu): the forward and the backward (dxa and every
    weight gradient) against the plain versions, with a padding bin (xa 0)
    and dropout off and on; the backward twice, bit-equal; one launch each.
    bf16 backs up on the stack's walk (csrc/walk.cuh), fp32 on the slab
    kernel; both take the layer's weight gradients from one grouped
    contraction a call."""
    g = torch.Generator(device=dev).manual_seed(D + int(100 * rate))
    A = 6 * 256
    sw = bin_mp.stack_weights([_ext_layer(dev, D, g)], dtype)
    spec = bin_mp.StackSpec("silu", rate, 0x5EED, 1)
    xa = torch.randn(2 * D, A, generator=g, device=dev)
    xa[:, -256:] = 0.0
    xa = xa.to(dtype)
    gy = (torch.randn(D, A, generator=g, device=dev) * 0.1).to(dtype)
    f0, b0 = bin_mp.mp_ext_fwd.launches, bin_mp.mp_ext_bwd.launches
    g0 = bin_mp.wgrad_group.launches
    out = bin_mp.mp_ext_fwd(xa, sw, spec)
    dxa, grads = bin_mp.mp_ext_bwd(xa, sw, spec, gy)
    dxa2, grads2 = bin_mp.mp_ext_bwd(xa, sw, spec, gy)
    assert (bin_mp.mp_ext_fwd.launches, bin_mp.mp_ext_bwd.launches) == (f0 + 1, b0 + 2)
    assert bin_mp.wgrad_group.launches == g0 + 2
    walk = bin_mp._EXT_WALK[(int(dtype == torch.bfloat16), sw.Dp, sw.n_blocks)]
    assert walk == (dtype == torch.bfloat16)
    ref = bin_mp.mp_ext_plain(xa, sw, spec)
    rdxa, rgrads = bin_mp.mp_ext_bwd_plain(xa, sw, spec, gy)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert out.shape == (D, A) and dxa.shape == (2 * D, A)
    assert _rel(out, ref) < tol
    assert _rel(dxa, rdxa) < tol
    assert len(grads) == len(rgrads)
    for a, r in zip(grads, rgrads):
        assert float((a - r).abs().max()) <= tol * max(float(r.abs().max()), 1e-6)
    assert torch.equal(dxa, dxa2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert out[:, -256:].isfinite().all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ext_layer_autograd_launches_kernel_5(dev, dtype):
    """``binned_mp_layer_ext_t`` on CUDA tensors runs kernel 5 once per
    direction and matches the CPU's plain versions."""
    g = torch.Generator(device=dev).manual_seed(7)
    D, A = 153, 512
    ws = _ext_layer(dev, D, g)
    xa = torch.randn(2 * D, A, generator=g, device=dev).to(dtype)
    gy = (torch.randn(D, A, generator=g, device=dev) * 0.1).to(dtype)
    grads = {}
    for where in ("cuda", "cpu"):
        x = xa.detach().to(where).clone().requires_grad_(True)
        w = [t.detach().to(where).clone().requires_grad_(True) for t in ws]
        f0, b0 = bin_mp.mp_ext_fwd.launches, bin_mp.mp_ext_bwd.launches
        y = bin_mp.binned_mp_layer_ext_t(x, w, dtype, "silu", 0.05, 1234)
        y.backward(gy.to(where))
        launched = (bin_mp.mp_ext_fwd.launches - f0, bin_mp.mp_ext_bwd.launches - b0)
        assert launched == ((1, 1) if where == "cuda" else (0, 0))
        grads[where] = [y.detach(), x.grad] + [t.grad for t in w]
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for a, r in zip(grads["cuda"], grads["cpu"]):
        assert float((a.cpu().float() - r.float()).abs().max()) <= tol * max(
            float(r.float().abs().max()), 1e-6)


# ---- the stack forward on tiles (stack_fwd_tile_kernel, bf16): serving,
# training with the projection fold, the embedding fold and one layer
# (kernel 1d, both forms), at a small shape and at the flagship's widths
# (D 153, E 256, ab 256).  Same tolerances.  The route shows on the launch
# counters of the two forward kernels (_launch_tiles, _launch_bins).

TILE_SHAPES = {"small": (19, 32, 3, 128), "flagship": (153, 256, 6, 256)}
TILE_FORMS = ["serve", "train", "vocab", "layer", "layer_train"]


def _flat_out(r):
    return [r[0], *r[1]] if isinstance(r, tuple) else [r]


def _tile_forms(dev, shape):
    """The five bf16 forward forms at ``shape``: name -> (kernel call, its
    plain version), plus the operands."""
    D, E, nb, ab = TILE_SHAPES[shape]
    adj, sw, pw, emb, x, gout = _stack_train_case(dev, D, E, nb, ab, torch.bfloat16, D + ab)
    codes, vt, emb_v = _vocab_case(dev, E, nb, ab, torch.bfloat16, D)
    sw1 = bin_mp.stack_weights([[torch.from_numpy(w).to(dev) for w in
                                 _init_layer(np.random.default_rng(D), D)]], torch.bfloat16)
    spec = bin_mp.StackSpec("silu", 0.05, 0xDEADBEEF)
    spec1 = bin_mp.StackSpec("silu", 0.05, bin_mp.layer_drop_seed(-98765, 2) & 0xFFFFFFFF, 1)
    forms = {
        "serve": (lambda: bin_mp.binned_mp_stack_t(x, adj, sw, "silu"),
                  lambda: bin_mp.mp_stack_plain(x, adj, sw, "silu")),
        "train": (lambda: bin_mp.mp_stack_fwd_train(emb, adj, sw, spec, pw),
                  lambda: bin_mp.mp_stack_train_plain(emb, adj, sw, spec, pw)),
        "vocab": (lambda: bin_mp.mp_stack_fwd_train_vocab(codes, adj, sw, spec, pw, vt),
                  lambda: bin_mp.mp_stack_train_plain(codes, adj, sw, spec, pw, vt)),
        "layer": (lambda: bin_mp.binned_mp_layer_t(x, adj, sw1, "silu"),
                  lambda: bin_mp.mp_stack_plain(x, adj, sw1, "silu")),
        "layer_train": (lambda: bin_mp.mp_layer_fwd_train(x, adj, sw1, spec1),
                        lambda: bin_mp.mp_stack_train_plain(x, adj, sw1, spec1)[0]),
    }
    return forms, dict(adj=adj, sw=sw, pw=pw, emb=emb, x=x, gout=gout, codes=codes, vt=vt,
                       emb_v=emb_v, sw1=sw1, spec=spec, spec1=spec1)


@pytest.mark.parametrize("form", TILE_FORMS)
@pytest.mark.parametrize("shape", list(TILE_SHAPES))
def test_stack_fwd_tiles_match_plain(dev, shape, form):
    run, plain = _tile_forms(dev, shape)[0][form]
    t0, b0 = bin_mp._launch_tiles.launches, bin_mp._launch_bins.launches
    got, again = _flat_out(run()), _flat_out(run())
    assert (bin_mp._launch_tiles.launches - t0, bin_mp._launch_bins.launches - b0) == (2, 0)
    want = _flat_out(plain())
    torch.cuda.synchronize()
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: the same bits
    errs = [_rel(a, r) for a, r in zip(got, want)]
    print(f"{shape} {form}: {errs}")
    assert max(errs) < 5e-2


@pytest.mark.parametrize("shape", list(TILE_SHAPES))
def test_stack_fwd_tiles_forms_agree_and_feed_the_backward(dev, shape):
    """The training form without dropout is the serving form, and the
    embedding fold the emb form, bit for bit; 1b's walk on the tile
    forward's saved inputs, and 1d's backward, match their plain versions."""
    _, o = _tile_forms(dev, shape)
    adj, sw, pw, x, gout = o["adj"], o["sw"], o["pw"], o["x"], o["gout"]
    out, _ = bin_mp.mp_stack_fwd_train(x, adj, sw, bin_mp.StackSpec("silu"))
    assert torch.equal(out, bin_mp.mp_stack_fwd(x, adj, sw, "silu"))
    out_v, saved_v = bin_mp.mp_stack_fwd_train_vocab(o["codes"], adj, sw, o["spec"], pw, o["vt"])
    out_e, saved_e = bin_mp.mp_stack_fwd_train(o["emb_v"], adj, sw, o["spec"], pw)
    assert torch.equal(out_v, out_e) and all(torch.equal(a, b) for a, b in zip(saved_v, saved_e))
    emb, spec = o["emb"], o["spec"]
    _, saved = bin_mp.mp_stack_fwd_train(emb, adj, sw, spec, pw)
    _, ref_saved = bin_mp.mp_stack_train_plain(emb, adj, sw, spec, pw)
    dx, lg, pg = bin_mp.mp_stack_bwd(emb, adj, sw, spec, saved, gout, pw)
    rdx, rlg, rpg = bin_mp.mp_stack_bwd_plain(emb, adj, sw, spec, ref_saved, gout, pw)
    g32, lg1 = bin_mp.mp_layer_bwd(x, adj, o["sw1"], o["spec1"], gout)
    rg32, rlg1 = bin_mp.mp_layer_bwd_plain(x, adj, o["sw1"], o["spec1"], gout)
    torch.cuda.synchronize()
    errs = {"1b dx": _rel(dx, rdx), "1d dx": _rel(g32, rg32)}
    errs.update({f"1b layer {l} grad {k}": _rel(a, r) for l, (gl, rl) in enumerate(zip(lg, rlg))
                 for k, (a, r) in enumerate(zip(gl, rl))})
    errs.update({f"1b proj grad {k}": _rel(a, r) for k, (a, r) in enumerate(zip(pg, rpg))})
    errs.update({f"1d grad {k}": _rel(a, r) for k, (a, r) in enumerate(zip(lg1, rlg1))})
    print(f"{shape}: worst {max(errs.values()):.2e}", errs)
    assert max(errs.values()) < 5e-2


@pytest.mark.parametrize("case", ["fp32", "wide"])
def test_stack_fwd_old_kernel_takes_what_the_tiles_do_not(dev, case):
    """fp32, and bf16 past the tiles' widths (Dp 208 > 160), run the kernel
    of one block a bin, serving and training forms alike."""
    D, dtype = (19, torch.float32) if case == "fp32" else (200, torch.bfloat16)
    adj, sw, pw, emb, x, _ = _stack_train_case(dev, D, 32, 3, 64, dtype, D)
    spec = bin_mp.StackSpec("relu", 0.05, 0xDEADBEEF)
    t0, b0 = bin_mp._launch_tiles.launches, bin_mp._launch_bins.launches
    got = [bin_mp.mp_stack_fwd(x, adj, sw, "relu"), *_flat_out(
        bin_mp.mp_stack_fwd_train(emb, adj, sw, spec, pw))]
    assert (bin_mp._launch_tiles.launches - t0, bin_mp._launch_bins.launches - b0) == (0, 2)
    want = [bin_mp.mp_stack_plain(x, adj, sw, "relu"), *_flat_out(
        bin_mp.mp_stack_train_plain(emb, adj, sw, spec, pw))]
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert max(_rel(a, r) for a, r in zip(got, want)) < tol


# ---- kernel 5's bf16 forward on wgmma (ext_fwd_wg_kernel) and kernel 6's
# forward on 64-atom tiles (bin_pool_fwd_tile_kernel), at a small shape and
# at the flagship's (kernel 5: D 153, 2 blocks, a graph rank's 20,480
# atoms; kernel 6: Ds 359, Do 153, H 4, ab 256, mb 16).  Same tolerances;
# the routes show on the wrappers' route counts.

EXT_SHAPES = {"small": (19, 6 * 256), "flagship": (153, 20480)}


def _ext_routes(fn):
    routes = bin_mp.mp_ext_fwd.routes
    before = dict(routes)
    fn()
    return routes["wgmma"] - before["wgmma"], routes["tiles"] - before["tiles"]


@pytest.mark.parametrize("rate", [0.0, 0.05])
@pytest.mark.parametrize("shape", list(EXT_SHAPES))
def test_ext_fwd_wgmma_matches_plain(dev, shape, rate):
    """bf16 runs the wgmma kernel, one launch a call, within the bf16 bar of
    the plain version; reruns bit-equal; the padding bin's columns finite;
    fp32 stays on the kernel of one block a tile."""
    D, A = EXT_SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(D + int(100 * rate))
    layer = _ext_layer(dev, D, g)
    spec = bin_mp.StackSpec("silu", rate, 0x5EED, 1)
    xa = torch.randn(2 * D, A, generator=g, device=dev)
    xa[:, -256:] = 0.0
    for dtype, want in ((torch.bfloat16, (1, 0)), (torch.float32, (0, 1))):
        sw = bin_mp.stack_weights([layer], dtype)
        x = xa.to(dtype)
        outs = []
        assert _ext_routes(lambda: outs.append(bin_mp.mp_ext_fwd(x, sw, spec))) == want
        again = bin_mp.mp_ext_fwd(x, sw, spec)
        ref = bin_mp.mp_ext_plain(x, sw, spec)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        assert outs[0].shape == (D, A) and _rel(outs[0], ref) < tol
        assert torch.equal(outs[0], again)


@pytest.mark.parametrize("act", ["relu", "gelu"])
@pytest.mark.parametrize("case", [(40, 1), (64, 3), (153, 1)])
def test_ext_fwd_wgmma_takes_its_shapes(dev, case, act):
    """Dp 48 (D 40: not a multiple of 32) stays on ext_fwd_kernel; Dp 64
    with 3 blocks and Dp 160 with 1 take the wgmma kernel; both match the
    plain version under other activations."""
    D, nblk = case
    g = torch.Generator(device=dev).manual_seed(D + nblk)
    sw = bin_mp.stack_weights([_ext_layer(dev, D, g, nblk)], torch.bfloat16)
    spec = bin_mp.StackSpec(act, 0.1, 77, 1)
    xa = torch.randn(2 * D, 3 * 64 + 128, generator=g, device=dev).to(torch.bfloat16)
    outs = []
    routes = _ext_routes(lambda: outs.append(bin_mp.mp_ext_fwd(xa, sw, spec)))
    assert routes == ((0, 1) if D == 40 else (1, 0))
    assert _rel(outs[0], bin_mp.mp_ext_plain(xa, sw, spec)) < 5e-2


def test_ext_layer_autograd_runs_the_wgmma_forward(dev):
    """binned_mp_layer_ext_t on bf16 CUDA tensors: the forward on wgmma, the
    backward on the walk; the gradients within the bf16 bar of the CPU's."""
    g = torch.Generator(device=dev).manual_seed(3)
    D, A = 153, 1024
    ws = _ext_layer(dev, D, g)
    xa = torch.randn(2 * D, A, generator=g, device=dev).to(torch.bfloat16)
    gy = (torch.randn(D, A, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    grads = {}
    for where in ("cuda", "cpu"):
        x = xa.detach().to(where).clone().requires_grad_(True)
        w = [t.detach().to(where).clone().requires_grad_(True) for t in ws]
        before = dict(bin_mp.mp_ext_fwd.routes)
        y = bin_mp.binned_mp_layer_ext_t(x, w, torch.bfloat16, "silu", 0.05, 99)
        y.backward(gy.to(where))
        if where == "cuda":
            assert bin_mp.mp_ext_fwd.routes["wgmma"] == before["wgmma"] + 1
        grads[where] = [y.detach(), x.grad] + [t.grad for t in w]
    for a, r in zip(grads["cuda"], grads["cpu"]):
        assert float((a.cpu().float() - r.float()).abs().max()) <= 5e-2 * max(
            float(r.float().abs().max()), 1e-6)


def _pool6_routes(fn):
    from aimnet_x2d_tpu_torch.ops import bin_pool

    routes = bin_pool.bin_pool_fwd.routes
    before = dict(routes)
    fn()
    return routes["tiles"] - before["tiles"], routes["bins"] - before["bins"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(359, 153), (64, 32)])
def test_bin_pool_fwd_tiles_match_plain(dev, widths, dtype):
    """The forward runs on tiles, one launch a call, reruns bit-equal, within
    POOL6_TOL of the plain version; the backward passes on its attn."""
    from aimnet_x2d_tpu_torch.ops import bin_pool

    Ds, Do = widths
    xs, xo, pm, ks, ko, b, cot = _pool6_case(dev, Ds, Do, 16, dtype, Ds + 7)
    outs = []
    assert _pool6_routes(lambda: outs.append(bin_pool.bin_pool_fwd(xs, xo, pm, ks, ko, b))) == (1, 0)
    got = outs[0]
    again = bin_pool.bin_pool_fwd(xs, xo, pm, ks, ko, b)
    ref = bin_pool.pool_fwd_plain(xs, xo, pm, ks, ko, b)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for a, r, a2 in zip(got, ref, again):
        assert a.shape == r.shape and _rel(a, r) < tol and torch.equal(a, a2)
    args = (xs, xo, pm, ks, ko, got[3], *cot)
    dxs, dxo, grads = bin_pool.bin_pool_bwd(*args)
    rdxs, rdxo, rgrads = bin_pool.pool_bwd_plain(xs, xo, pm, ks, ko, ref[3], *cot)
    torch.cuda.synchronize()
    assert _rel(dxs, rdxs) < tol and _rel(dxo, rdxo) < tol
    for i, (a, r) in enumerate(zip(grads, rgrads)):
        scale = float(rgrads[0].abs().max()) if i == 2 else float(r.abs().max())
        assert float((a - r).abs().max()) / scale < tol


@pytest.mark.parametrize("ab", [64, 128, 512, 768])
def test_bin_pool_fwd_tiles_take_bins_up_to_512(dev, ab):
    """Bins of up to 512 atoms (clusters of up to 8 tiles) run on tiles, a
    bin of 768 on the kernel of one block a bin; random owners (molecules
    in many runs) within POOL6_TOL."""
    from aimnet_x2d_tpu_torch.ops import bin_pool

    g = torch.Generator(device=dev).manual_seed(ab)
    nb, mb, Ds, Do, H = 5, 12, 40, 24, 4
    pm = rand_pm(nb, mb, ab, g)
    xs = torch.randn(nb * ab, Ds, generator=g, device=dev).to(torch.bfloat16)
    xo = torch.randn(nb * ab, Do, generator=g, device=dev).to(torch.bfloat16)
    ks = (torch.randn(Ds, H, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    ko = (torch.randn(Do, H, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    b = torch.randn(H, generator=g, device=dev)
    outs = []
    routes = _pool6_routes(lambda: outs.append(bin_pool.bin_pool_fwd(xs, xo, pm, ks, ko, b)))
    assert routes == ((1, 0) if ab <= 512 else (0, 1))
    for a, r in zip(outs[0], bin_pool.pool_fwd_plain(xs, xo, pm, ks, ko, b)):
        assert _rel(a, r) < 5e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bin_pool_autograd_runs_the_tiles(dev, dtype):
    """binned_attention_pool_fused on CUDA tensors: the forward on tiles,
    the backward kernel on its attn; the gradients match the CPU's."""
    from aimnet_x2d_tpu_torch.ops import bin_pool

    xs, xo, pm, ks, ko, b, cot = _pool6_case(dev, 359, 153, 16, dtype, 5)
    grads = {}
    for where in ("cuda", "cpu"):
        x = xs.detach().to(where).clone().requires_grad_(True)
        sk = torch.cat([ks, ko]).float().to(where).requires_grad_(True)
        sb = b.to(where).clone().requires_grad_(True)
        before = dict(bin_pool.bin_pool_fwd.routes)
        out = bin_pool.binned_attention_pool_fused(x, xo.to(where), pm.to(where), sk, sb)
        torch.autograd.backward(out[:3], [c.to(where) for c in cot])
        if where == "cuda":
            assert bin_pool.bin_pool_fwd.routes["tiles"] == before["tiles"] + 1
        grads[where] = [*(o.detach() for o in out), x.grad, sk.grad, sb.grad]
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for i, (a, r) in enumerate(zip(grads["cuda"], grads["cpu"])):
        scale = float(grads["cpu"][5].abs().max()) if i == 6 else max(float(r.float().abs().max()),
                                                                       1e-6)
        assert float((a.cpu().float() - r.float()).abs().max()) <= tol * scale


# ---- the projection fold's backward on wgmma (kernels 1c and 1c-vocab,
# proj_bwd_wg_kernel) and kernel 6's backward on 64-atom tiles
# (bin_pool_bwd_tile_kernel): the routes by dtype and shape, the new
# kernels against their plain versions (bf16 5e-2; kernel 6 fp32 1e-5),
# reruns bit-equal, the old kernels on what the new ones do not take, and
# the autograd paths through the new kernels.

# (D, E, nb, ab): Dp 160 at the flagship's E, Dp 64 and 128 at E 128
# (D, E, nb, ab); 40 bins of 256 make 160 tiles, more than the card's 132
# blocks, so that blocks run several tiles (the barriers' later phases, both
# g32 buffers, the partials summed over a block's tiles)
PROJ_WG_SHAPES = [(153, 256, 5, 256), (60, 128, 3, 128), (120, 256, 2, 512), (153, 256, 40, 256)]


def _proj_case(dev, D, E, nb, ab, seed, vocab):
    g = torch.Generator(device=dev).manual_seed(seed)
    kb = (torch.rand(E, D, generator=g, device=dev) * 2 - 1) / E**0.5
    bb = (torch.rand(D, generator=g, device=dev) - 0.5) * 0.4
    pw = bin_mp.prep_proj(kb, bb, torch.bfloat16, bin_mp.padded_dim(D))
    g32 = torch.randn(pw.kbT.shape[0], nb * ab, generator=g, device=dev) * 0.1
    g32[D:] = 0
    if vocab:
        codes, vt, _ = _vocab_case(dev, E, nb, ab, torch.bfloat16, seed)
        return pw, g32, codes, vt
    return pw, g32, torch.randn(E, nb * ab, generator=g, device=dev).to(torch.bfloat16), None


def _proj_run(x, g32, pw, act, ab, vt, dtc=None):
    if vt is None:
        return bin_mp.mp_stack_bwd_proj(x, g32, pw, act, ab, dtc)
    return bin_mp.mp_stack_bwd_vocab(x, g32, pw, vt, act, ab, dtc)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("vocab", [False, True])
@pytest.mark.parametrize("shape", PROJ_WG_SHAPES)
def test_proj_bwd_wgmma_matches_plain(dev, shape, vocab, act):
    D, E, nb, ab = shape
    pw, g32, x, vt = _proj_case(dev, D, E, nb, ab, D + E + vocab, vocab)
    fn = bin_mp.mp_stack_bwd_vocab if vocab else bin_mp.mp_stack_bwd_proj
    before = dict(fn.routes)
    dtc = torch.empty(g32.shape, dtype=torch.bfloat16, device=dev)
    got = _proj_run(x, g32.clone(), pw, act, ab, vt, dtc)
    assert (fn.routes["wgmma"] - before["wgmma"], fn.routes["bins"] - before["bins"]) == (1, 0)
    again = _proj_run(x, g32.clone(), pw, act, ab, vt)
    want = (bin_mp.mp_stack_bwd_vocab_plain(x, g32.clone(), pw, vt, act) if vocab
            else bin_mp._proj_bwd_plain(x, g32.clone(), pw, act))
    emb = bin_mp.embed_from_codes(x, vt) if vocab else x
    t0 = bin_mp._dot(pw.kbT, emb, torch.bfloat16) + pw.bb[:, None]
    dt0 = g32 * bin_mp.activation_grad(act, t0).float()
    torch.cuda.synchronize()
    errs = {n: _rel(a, r) for n, a, r in zip(("demb or d_bd", "dkbT", "dbb"), got, want)}
    # rnd(dt0) as the plain chain rounds it, but where a product's other
    # order of accumulation puts t0 across a bf16 rounding (about 1e-5 of
    # the elements on the CPU's two orders, each within 1e-3 of max|dt0|)
    off = dtc.float() != dt0.to(torch.bfloat16).float()
    print(f"{shape} vocab={vocab} {act}: {errs}; dtc off rnd(dt0) at {float(off.float().mean()):.2e}"
          f" of the elements, by {_rel(dtc, dt0):.2e}")
    assert max(errs.values()) < 5e-2
    assert float(off.float().mean()) <= 1e-3 and _rel(dtc, dt0) <= 1e-2
    # the fp32 sums over the atoms (d_bb of dt0; d_kb of dtc; under the fold
    # d_bd of demb's rows) apart from those elements only by their order
    assert errs["dbb"] <= 1e-3 and errs["dkbT"] <= 1e-3
    if vocab:
        assert errs["demb or d_bd"] <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", ["fp32", "fp32_fold", "E32", "Dp48", "Dp48_fold"])
def test_proj_bwd_old_kernel_takes_what_the_wgmma_does_not(dev, case):
    """fp32, E not 128 or 256, Dp not a multiple of 32: the kernel of one
    block a bin, within its bar of the plain version."""
    vocab = case.endswith("fold")
    D, E = {"fp32": (153, 256), "fp32_fold": (153, 256), "E32": (19, 32), "Dp48": (40, 256),
            "Dp48_fold": (40, 256)}[case]
    pw, g32, x, vt = _proj_case(dev, D, E, 3, 128, 11, vocab)
    if case.startswith("fp32"):
        pw = bin_mp.prep_proj(pw.kbT[:D].T.float(), pw.bb[:D].float(), torch.float32, pw.kbT.shape[0])
        x = x if vocab else x.float()
        if vocab:
            from aimnet_x2d_tpu_torch.ops import embed

            vt = embed.VocabTable(vt.bd.float(), vt.sizes)
    fn = bin_mp.mp_stack_bwd_vocab if vocab else bin_mp.mp_stack_bwd_proj
    before = dict(fn.routes)
    got = _proj_run(x, g32.clone(), pw, "silu", 128, vt)
    assert (fn.routes["wgmma"] - before["wgmma"], fn.routes["bins"] - before["bins"]) == (0, 1)
    want = (bin_mp.mp_stack_bwd_vocab_plain(x, g32.clone(), pw, vt, "silu") if vocab
            else bin_mp._proj_bwd_plain(x, g32.clone(), pw, "silu"))
    torch.cuda.synchronize()
    tol = 1e-4 if case.startswith("fp32") else 5e-2
    assert max(_rel(a, r) for a, r in zip(got, want)) < tol


@pytest.mark.parametrize("fold", [False, True])
def test_stack_train_autograd_runs_the_wgmma_projection(dev, fold):
    """The flagship's training backward (and the fold's) through autograd:
    the projection's backward on wgmma once a call, gradients as the
    plain versions' on the CPU."""
    from aimnet_x2d_tpu_torch.ops import embed

    nb, ab, D, E = 3, 256, 153, 256
    adj, _, _, emb, _, _ = _stack_train_case(dev, D, E, nb, ab, torch.bfloat16, 21, 1)
    g = torch.Generator(device=dev).manual_seed(22)
    layers = [[torch.from_numpy(w).to(dev) for w in _init_layer(np.random.default_rng(l), D)]
              for l in range(2)]
    kb = (torch.rand(E, D, generator=g, device=dev) * 2 - 1) / E**0.5
    bb = (torch.rand(D, generator=g, device=dev) - 0.5) * 0.4
    codes, _, _ = _vocab_case(dev, E, nb, ab, torch.bfloat16, 23)
    tables = [torch.randn(v, E // 4, generator=g, device=dev) * 0.5 for v in (119, 9, 7, 7)]
    gout = torch.randn(D, nb * ab, generator=g, device=dev) * 0.1
    fn = bin_mp.mp_stack_bwd_vocab if fold else bin_mp.mp_stack_bwd_proj
    grads = {}
    for where in ("cuda", "cpu"):
        leaves = [kb.detach().to(where).clone().requires_grad_(True),
                  bb.detach().to(where).clone().requires_grad_(True)]
        ls = [[w.to(where) for w in lw] for lw in layers]
        if fold:
            tt = [t.detach().to(where).clone().requires_grad_(True) for t in tables]
            spec, x, grad_of = (codes.to(where), embed.blockdiag_table_t(tt),
                                (119, 9, 7, 7)), None, tt
        else:
            x = emb.detach().to(where).float().clone().requires_grad_(True)
            spec, grad_of = None, [x]
        before = dict(fn.routes)
        out = bin_mp.binned_mp_stack_train_t(x, adj.to(where), ls, torch.bfloat16, "silu", 0.0,
                                             0, proj_weights=tuple(leaves), embed_spec=spec)
        out.backward(gout.to(where).to(out.dtype))
        if where == "cuda":
            torch.cuda.synchronize()
            assert fn.routes["wgmma"] == before["wgmma"] + 1
        grads[where] = [t.grad.float().cpu() for t in grad_of + leaves]
    for a, r in zip(grads["cuda"], grads["cpu"]):
        assert float((a - r).abs().max()) <= 5e-2 * float(r.abs().max())


def _pool6_bwd_routes(fn):
    from aimnet_x2d_tpu_torch.ops import bin_pool

    routes = bin_pool.bin_pool_bwd.routes
    before = dict(routes)
    fn()
    return routes["tiles"] - before["tiles"], routes["bins"] - before["bins"]


@pytest.mark.parametrize("mb", [16, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [(359, 153), (64, 32)])
def test_bin_pool_bwd_tiles_match_plain(dev, widths, dtype, mb):
    """The backward runs on tiles, one launch a call, within POOL6_TOL of
    the plain version, reruns bit-equal."""
    from aimnet_x2d_tpu_torch.ops import bin_pool

    Ds, Do = widths
    xs, xo, pm, ks, ko, b, cot = _pool6_case(dev, Ds, Do, mb, dtype, Ds + mb + 3)
    attn = bin_pool.pool_fwd_plain(xs, xo, pm, ks, ko, b)[3]
    args = (xs, xo, pm, ks, ko, attn, *cot)
    outs = []
    assert _pool6_bwd_routes(lambda: outs.append(bin_pool.bin_pool_bwd(*args))) == (1, 0)
    dxs, dxo, grads = outs[0]
    again = bin_pool.bin_pool_bwd(*args)
    rdxs, rdxo, rgrads = bin_pool.pool_bwd_plain(*args)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    assert dxs.dtype == dtype and _rel(dxs, rdxs) < tol and _rel(dxo, rdxo) < tol
    for i, (a, r) in enumerate(zip(grads, rgrads)):
        scale = float(rgrads[0].abs().max()) if i == 2 else float(r.abs().max())
        assert float((a - r).abs().max()) / scale < tol
    for a, r in zip((dxs, dxo, *grads), (again[0], again[1], *again[2])):
        assert torch.equal(a, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ab", [64, 128, 512, 768])
def test_bin_pool_bwd_tiles_take_bins_up_to_512(dev, ab, dtype):
    """Bins of up to 512 atoms run the backward on tiles, a bin of 768 on
    the kernel of one block a bin; random owners (molecules in many runs)
    within POOL6_TOL."""
    from aimnet_x2d_tpu_torch.ops import bin_pool

    g = torch.Generator(device=dev).manual_seed(ab + 1)
    nb, mb, Ds, Do, H = 5, 12, 40, 24, 4
    pm = rand_pm(nb, mb, ab, g)
    xs = torch.randn(nb * ab, Ds, generator=g, device=dev).to(dtype)
    xo = torch.randn(nb * ab, Do, generator=g, device=dev).to(dtype)
    ks = (torch.randn(Ds, H, generator=g, device=dev) * 0.1).to(dtype)
    ko = (torch.randn(Do, H, generator=g, device=dev) * 0.1).to(dtype)
    b = torch.randn(H, generator=g, device=dev)
    attn = bin_pool.pool_fwd_plain(xs, xo, pm, ks, ko, b)[3]
    cot = [torch.randn(*s, generator=g, device=dev) for s in ((nb * mb, Ds), (nb * mb, Do), (nb * mb,))]
    args = (xs, xo, pm, ks, ko, attn, *cot)
    outs = []
    routes = _pool6_bwd_routes(lambda: outs.append(bin_pool.bin_pool_bwd(*args)))
    assert routes == ((1, 0) if ab <= 512 else (0, 1))
    ref = bin_pool.pool_bwd_plain(*args)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    got, want = outs[0], ref
    assert _rel(got[0], want[0]) < tol and _rel(got[1], want[1]) < tol
    for i, (a, r) in enumerate(zip(got[2], want[2])):
        scale = float(want[2][0].abs().max()) if i == 2 else float(r.abs().max())
        assert float((a - r).abs().max()) / scale < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bin_pool_autograd_runs_the_backward_tiles(dev, dtype):
    """binned_attention_pool_fused on CUDA tensors, as per-hop training
    runs it: forward and backward on tiles, one launch each."""
    from aimnet_x2d_tpu_torch.ops import bin_pool

    xs, xo, pm, ks, ko, b, cot = _pool6_case(dev, 359, 153, 16, dtype, 9)
    x = xs.clone().requires_grad_(True)
    sk = torch.cat([ks, ko]).float().requires_grad_(True)
    sb = b.clone().requires_grad_(True)
    f0, b0 = dict(bin_pool.bin_pool_fwd.routes), dict(bin_pool.bin_pool_bwd.routes)
    out = bin_pool.binned_attention_pool_fused(x, xo, pm, sk, sb)
    torch.autograd.backward(out[:3], list(cot))
    torch.cuda.synchronize()
    assert bin_pool.bin_pool_fwd.routes["tiles"] == f0["tiles"] + 1
    assert (bin_pool.bin_pool_bwd.routes["tiles"], bin_pool.bin_pool_bwd.routes["bins"]) == \
        (b0["tiles"] + 1, b0["bins"])
    assert torch.isfinite(x.grad.float()).all() and torch.isfinite(sk.grad).all()
