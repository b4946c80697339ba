"""Kernel 5's plain PyTorch versions (aimnet_x2d_tpu_torch/ops/bin_mp.py:
``binned_mp_layer_ext_t``, ``mp_ext_plain``, ``mp_ext_bwd_plain``) against the
JAX package's ``binned_mp_layer_ext_t`` in interpret mode, as the JAX
package's own kernel tests run it; and the two aggregation products around
it (ops/halo.py) against JAX's.

The layer on a pre-aggregated [x ; agg] (2D, A): the output, dxa and every
weight gradient, in fp32 (rtol 5e-4 / atol 5e-5: both sides accumulate in
fp32 and differ only in summation order) and bf16 (max|d|/max|ref| < 5e-2:
an fp32 sum that rounds to the other bf16 neighbour moves an intermediate by
2**-8), with dropout off and on (the same int seed on both sides; the keep
mask, keyed on the local atom columns with block tags 0..n-1, bit-equal).
D = 19 (hidden 64) pads to 32 in the port's kernels' layout.  Inputs are made
from a seed with numpy and handed to both.  Run with ``-s`` to print the
measured errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.ops import halo as jax_halo
from aimnet_x2d_tpu.ops.bin_mp import _dropout_mask as jax_mask
from aimnet_x2d_tpu.ops.bin_mp import binned_mp_layer_ext_t as jax_ext
from aimnet_x2d_tpu_torch.ops import bin_mp
from aimnet_x2d_tpu_torch.ops import halo as port_halo

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
D, AB, NB, NBLK = 19, 32, 4, 2


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


def _layer_ws(rng, n_blocks=NBLK):
    u = lambda s, fan: rng.uniform(-1, 1, s).astype(np.float32) / np.sqrt(fan)  # noqa: E731
    ws = [u((D, D), 2 * D), u((D, D), 2 * D), u(D, 2 * D), u((D, D), 2 * D), u((D, D), 2 * D),
          u(D, 2 * D)]
    for _ in range(n_blocks):
        ws += [u((D, D), D), u(D, D), u((D, D), D), u(D, D)]
    return ws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_ext_layer_plain_matches_jax(dtype, rate):
    rng = np.random.default_rng(5)
    A = NB * AB
    xa = rng.normal(size=(2 * D, A)).astype(np.float32)
    xa[:, -AB:] = 0.0  # a padding bin
    g = (rng.normal(size=(D, A)) * 0.1).astype(np.float32)
    ws = _layer_ws(rng)
    seed = -123456789

    def jfn(xa_, *w):
        return jax_ext(xa_, tuple(w), ab=AB, act="silu", num_mlp_layers=NBLK,
                       compute_dtype=JDT[dtype], interpret=True, dropout=rate,
                       drop_seed=jnp.asarray([seed], jnp.int32) if rate else None)

    xa_j = jnp.asarray(xa).astype(JDT[dtype])
    out_j, vjp = jax.vjp(jfn, xa_j, *[jnp.asarray(w) for w in ws])
    grads_j = vjp(jnp.asarray(g).astype(out_j.dtype))

    xa_t = torch.tensor(xa).to(TDT[dtype]).requires_grad_(True)
    ws_t = [torch.tensor(w, requires_grad=True) for w in ws]
    out_t = bin_mp.binned_mp_layer_ext_t(xa_t, ws_t, TDT[dtype], "silu", rate, seed)
    assert out_t.dtype == TDT[dtype] and out_t.shape == (D, A)
    out_t.backward(torch.tensor(g).to(TDT[dtype]))
    _check(out_t, out_j, dtype, f"out rate={rate}")
    _check(xa_t.grad, grads_j[0], dtype, "dxa")
    for i, (wt, gj) in enumerate(zip(ws_t, grads_j[1:])):
        # a weight gradient whose reference is exactly 0 is held to the scale
        # of its layer's largest gradient
        _check(wt.grad, gj, dtype, f"d_w[{i}]")


@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_ext_layer_dropout_mask_bit_equal(rate):
    """The keep mask of block i is the JAX kernel's: the hash of (feature
    row, local atom column, tag i, seed), at the columns the layer sees."""
    A = NB * AB
    for seed, tag in ((0, 0), (0x7FFFFFFF, 1), (-5 & 0xFFFFFFFF, 1)):
        want = np.asarray(jax_mask((D, A), rate, jnp.uint32(seed), jnp.uint32(tag), jnp.uint32(0)))
        got = bin_mp.dropout_keep(D, 0, A, rate, seed, tag).numpy()
        np.testing.assert_array_equal(got, want)
    spec = bin_mp.StackSpec("silu", rate, 99, 1)
    assert [spec.drop(0, i, NBLK)[2] for i in range(NBLK)] == list(range(NBLK))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_halo_aggregation_products_match_jax(dtype):
    rng = np.random.default_rng(8)
    A, H = NB * AB, 16
    x = rng.normal(size=(D, A)).astype(np.float32)
    adj = rng.integers(0, 3, size=(NB, AB, AB)).astype(np.int8)
    halo = rng.normal(size=(D, H)).astype(np.float32)
    hadj = rng.integers(0, 2, size=(H, A)).astype(np.int8)
    jdt, tdt = JDT[dtype], TDT[dtype]
    got = port_halo.binned_local_agg_t(torch.tensor(x).to(tdt), torch.tensor(adj), tdt)
    want = jax_halo.binned_local_agg_t(jnp.asarray(x).astype(jdt), jnp.asarray(adj), jdt)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _check(got, want, "float32", "local agg")
    got = port_halo.halo_agg_contrib_t(torch.tensor(halo).to(tdt), torch.tensor(hadj), tdt)
    want = jax_halo.halo_agg_contrib_t(jnp.asarray(halo).astype(jdt), jnp.asarray(hadj), jdt)
    assert got.dtype == torch.float32
    _check(got, want, "float32", "halo contribution")
