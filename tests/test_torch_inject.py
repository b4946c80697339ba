"""Plain PyTorch versions of the config-3 kernels against the JAX package's
Pallas kernels, which run here in interpret mode, as the JAX package's own
kernel tests run them.

- ops/bin_inject.py (kernel 4): one charge + stereo inject round with its
  layer and residual, forward and backward (dx, d_kb, d_b and every layer
  gradient), against ``binned_inject_mp_layer_t`` and ``jax.vjp`` of it, on a
  binned batch with real stereo content: with tetrahedral centres, with none
  (``any_tet`` 0), and with the 1e-6 charge clip binding on some atoms;
- ops/bin_mp.py (kernel 1d): one layer with dropout and the caller's
  residual, against ``binned_mp_layer_t``; the per-layer dropout seed
  against ``models/gnn.py::_layer_drop_seed``;
- the stereo context and the per-atom total charge the model builds for
  them, against ``GNN._stereo_context``.

Inputs are made from a seed with numpy and handed to both.  Tolerances:
fp32 rtol 5e-4 / atol 5e-5 (both sides accumulate in fp32 and differ only in
summation order); bf16 max|d|/max|ref| < 5e-2 (one fp32 sum rounding to the
other bf16 neighbour moves an intermediate by 2**-8 and propagates).  Run
with ``-s`` to print the measured errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.data.binning import bin_pack_batch as jax_bin_pack
from aimnet_x2d_tpu.data.synthetic import make_synthetic_batch
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.models.gnn import _layer_drop_seed as jax_layer_seed
from aimnet_x2d_tpu.ops.bin_inject import binned_inject_mp_layer_t as jax_inject
from aimnet_x2d_tpu.ops.bin_mp import binned_mp_layer_t as jax_layer
from aimnet_x2d_tpu_torch.data.batching import MolBatch
from aimnet_x2d_tpu_torch.models.gnn import atom_total_charge, stereo_context
from aimnet_x2d_tpu_torch.ops import bin_inject, bin_mp

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check(got, ref, dtype, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1e-30)
    print(f"{what} {dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / scale:.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=what)
    else:
        assert err / scale < 5e-2, what


def _batches(stereo):
    """(JAX binned batch, the same arrays as the port's MolBatch on the CPU)."""
    jb = jax_bin_pack(make_synthetic_batch(num_graphs=13, mean_atoms=12, num_hops=3, num_tasks=2,
                                           seed=11, with_stereo=stereo), ab=64, mb=16)
    names = [f.name for f in dataclasses.fields(MolBatch)]
    pb = MolBatch(**{n: np.asarray(getattr(jb, n)) if isinstance(getattr(jb, n), np.ndarray)
                     else getattr(jb, n) for n in names}).to("cpu")
    return jb, pb


def _layer_ws(rng, D, n_blocks=2):
    u = lambda s, fan: rng.uniform(-1, 1, s).astype(np.float32) / np.sqrt(fan)  # noqa: E731
    ws = [u((D, D), 4 * D), u((D, D), 4 * D), u(D, 4 * D), u((D, D), 4 * D), u((D, D), 4 * D),
          u(D, 4 * D)]
    for _ in range(n_blocks):
        ws += [u((D, D), D), u(D, D), u((D, D), D), u(D, D)]
    return ws


@pytest.mark.parametrize("base", [0, 12345, -2**31, 2**31 - 1, -7])
def test_layer_drop_seed_matches_jax(base):
    for l in range(4):
        assert bin_mp.layer_drop_seed(base, l) == int(jax_layer_seed(jnp.int32(base), l))


@pytest.mark.parametrize("stereo", [True, False])
def test_stereo_context_matches_jax(stereo):
    jb, pb = _batches(stereo)
    A = pb.atom_type.shape[0]
    cfg = JaxConfig(hidden_dim=32, embedding_dim=4, use_stereochemistry=True)
    ref = JaxGNN(cfg)._stereo_context(jb, A, None, None)
    ctx = stereo_context(pb)
    for name in ("stereo_adj", "tet_nbrs", "tet_flat", "tet_nz", "any_tet"):
        np.testing.assert_array_equal(getattr(ctx, name).numpy(), np.asarray(ref[name]), name)
    assert bool(ctx.any_tet) == stereo
    assert (ctx.stereo_adj.numpy() != 0).any() == stereo
    tca = atom_total_charge(pb).numpy()
    B = pb.total_charge.shape[0]
    want = np.where(jb.atom_mask, np.asarray(jb.total_charge)[np.clip(jb.atom_mol, 0, B - 1)], 0)
    np.testing.assert_array_equal(tca, want)
    if stereo:
        assert (tca != 0).any()


def _inject_case(case, D=13, seed=3):
    jb, pb = _batches(case != "no_tet")
    A = pb.atom_type.shape[0]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(D, A)).astype(np.float32)
    x[1] = np.abs(x[1]) + 0.05  # f: the 1e-6 clip does not bind ...
    if case == "clip":  # ... except on some atoms
        x[1, rng.random(A) < 0.3] = -rng.random(int((rng.random(A) < 0.3).sum()) or 1)[0]
        x[1, ::7] = -0.5
    ctx = stereo_context(pb)
    sadj, any_tet = ctx.stereo_adj, ctx.any_tet.float().reshape(1)
    tca = atom_total_charge(pb)
    kb = rng.uniform(-0.3, 0.3, (3 * D, D)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, D).astype(np.float32)
    g = rng.normal(size=(D, A)).astype(np.float32)
    return jb, pb, x, sadj, tca, any_tet, kb, b, _layer_ws(rng, D), g


@pytest.mark.parametrize("case,rate", [("tet", 0.1), ("no_tet", 0.0), ("clip", 0.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inject_layer_matches_jax(dtype, case, rate):
    jb, pb, x, sadj, tca, any_tet, kb, b, lws, g = _inject_case(case)
    assert float(any_tet) == float(case != "no_tet")
    if case == "clip":
        assert (x[1] < 1e-6).any() and (x[1] >= 1e-6).any()
    seed, act, jdt = -123456, "silu", JDT[dtype]

    def f(xin, kb_, b_, lws_):
        return jax_inject(xin.astype(jdt), jnp.asarray(tca.numpy()), jnp.asarray(jb.pool_mat),
                          jnp.asarray(jb.tet_bin), jnp.asarray(any_tet.numpy()[0]),
                          jnp.asarray(sadj.numpy()), jnp.asarray(jb.bin_adj), kb_, b_, lws_,
                          act=act, num_mlp_layers=2, compute_dtype=jdt, interpret=True,
                          dropout=rate, drop_seed=jnp.asarray([seed], jnp.int32) if rate else None)

    jl = tuple(jnp.asarray(w) for w in lws)
    out_ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(kb), jnp.asarray(b), jl)
    dx_ref, dkb_ref, db_ref, dl_ref = vjp(jnp.asarray(g).astype(out_ref.dtype))

    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_(True)
    tkb = torch.from_numpy(kb).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tl = [torch.from_numpy(w).requires_grad_(True) for w in lws]
    out = bin_inject.binned_inject_mp_layer_train_t(
        tx, tca, pb.pool_mat, pb.tet_bin, any_tet, sadj, pb.bin_adj, tkb, tb, tl, TDT[dtype],
        act=act, dropout=rate, seed=seed)
    _check(out.detach(), out_ref, dtype, f"{case} out")
    out.backward(torch.from_numpy(g).to(out.dtype))
    _check(tx.grad, dx_ref, dtype, f"{case} dx")
    _check(tkb.grad, dkb_ref, dtype, f"{case} d_kb")
    _check(tb.grad, db_ref, dtype, f"{case} d_b")
    for k, (w, r) in enumerate(zip(tl, dl_ref)):
        _check(w.grad, r, dtype, f"{case} layer weight {k}")
    if rate == 0.0:  # the serving form computes the same
        iw = bin_inject.prep_inject(tkb.detach(), tb.detach(), [w.detach() for w in tl],
                                    TDT[dtype])
        with torch.no_grad():
            serve = bin_inject.binned_inject_mp_layer_t(tx.detach(), tca, pb.pool_mat, pb.tet_bin,
                                                        any_tet, sadj, pb.bin_adj, iw, act)
        torch.testing.assert_close(serve, out.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_layer_matches_jax(dtype):
    jb, pb = _batches(False)
    A = pb.atom_type.shape[0]
    rng = np.random.default_rng(5)
    D, rate, base, act = 13, 0.2, 987654, "gelu"
    x = rng.normal(size=(D, A)).astype(np.float32)
    g = rng.normal(size=(D, A)).astype(np.float32)
    lws = _layer_ws(rng, D)
    jdt = JDT[dtype]
    for l in (0, 2):
        seed = bin_mp.layer_drop_seed(base, l)

        def f(xin, lws_):
            xd = xin.astype(jdt)
            y = jax_layer(xd, jnp.asarray(jb.bin_adj), lws_, act=act, num_mlp_layers=2,
                          compute_dtype=jdt, interpret=True, dropout=rate,
                          drop_seed=jnp.asarray([seed], jnp.int32))
            return y + xd

        out_ref, vjp = jax.vjp(f, jnp.asarray(x), tuple(jnp.asarray(w) for w in lws))
        dx_ref, dl_ref = vjp(jnp.asarray(g).astype(out_ref.dtype))
        tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_(True)
        tl = [torch.from_numpy(w).requires_grad_(True) for w in lws]
        out = bin_mp.binned_mp_layer_train_t(tx, pb.bin_adj, tl, TDT[dtype], act=act,
                                             dropout=rate, seed=seed)
        # the dropout masks are bit-equal: in fp32 any flipped mask bit would
        # move an output by far more than the bar
        _check(out.detach(), out_ref, dtype, f"layer {l} out")
        out.backward(torch.from_numpy(g).to(out.dtype))
        _check(tx.grad, dx_ref, dtype, f"layer {l} dx")
        for k, (w, r) in enumerate(zip(tl, dl_ref)):
            _check(w.grad, r, dtype, f"layer {l} weight {k}")
