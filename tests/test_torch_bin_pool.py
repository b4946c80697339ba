"""Kernel 6 of the PyTorch port (the binned attention pool of row-major atom
arrays, ops/bin_pool.py) against the JAX package's
``binned_attention_pool_fused`` run in interpret mode, on the CPU.

The port's plain versions (what ``binned_attention_pool_fused`` runs on CPU
tensors) and the JAX kernel get the same seeded inputs: pooled parts,
coverage and attention weights, then the gradients of x_self, x_other, the
score kernel and the score bias through ``jax.vjp`` against autograd, for
fp32 and bf16, on a membership matrix with an empty molecule slot, a
one-atom molecule and atoms of no molecule, and on a one-slot-per-bin one.

Bars: fp32 rtol 5e-4 / atol 5e-5 (both sides sum in fp32, in other orders);
bf16 max|d|/max|ref| < 5e-2 (the same bf16 cast points, fp32 sums in other
orders; a sum next to a rounding boundary moves one bf16 step).  Run with
``-s`` to print the measured errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.ops.bin_pool import binned_attention_pool_fused as jax_pool
from aimnet_x2d_tpu_torch.ops import bin_pool

torch.set_num_threads(1)

NB, AB, DS, DO, H = 3, 64, 40, 17, 4


def _pool_mat(rng, mb):
    """(NB, mb, AB) int8, one molecule at most per atom; bin 0 has an empty
    slot (the last) and a one-atom molecule (slot 0), every bin has atoms
    of no molecule."""
    owner = rng.integers(-1, mb, (NB, AB))
    if mb > 1:
        owner[0][owner[0] == mb - 1] = -1
        owner[0][owner[0] == 0] = 1
        owner[0, 5] = 0
    owner[:, -3:] = -1
    return (owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)


def _inputs(dtype, mb, seed=0):
    rng = np.random.default_rng(seed)
    pm = _pool_mat(rng, mb)
    xs = rng.normal(size=(NB * AB, DS)).astype(np.float32)
    xo = rng.normal(size=(NB * AB, DO)).astype(np.float32)
    sk = (rng.normal(size=(DS + DO, H)) * 0.3).astype(np.float32)
    sb = rng.normal(size=(H,)).astype(np.float32)
    B = NB * mb
    cot = [rng.normal(size=(B, DS)).astype(np.float32), rng.normal(size=(B, DO)).astype(np.float32),
           rng.normal(size=(B,)).astype(np.float32)]
    if dtype == "bfloat16":  # the same bf16 values on both sides
        xs, xo = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (xs, xo))
    return pm, xs, xo, sk, sb, cot


def _check(got, ref, dtype, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    print(f"{what} {dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / np.abs(ref).max():.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=what)
    else:
        assert err / np.abs(ref).max() < 5e-2, what


@pytest.mark.parametrize("mb", [16, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_pool_and_its_gradients_match_jax_kernel(dtype, mb):
    pm, xs, xo, sk, sb, cot = _inputs(dtype, mb)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def f(xs_, xo_, sk_, sb_):
        return jax_pool(xs_, xo_, jnp.asarray(pm), sk_, sb_, interpret=True)

    ref, vjp = jax.vjp(f, jnp.asarray(xs, jdt), jnp.asarray(xo, jdt), jnp.asarray(sk),
                       jnp.asarray(sb))
    ref_g = vjp((*(jnp.asarray(c) for c in cot), jnp.zeros_like(ref[3])))

    t_in = [torch.tensor(xs).to(tdt), torch.tensor(xo).to(tdt), torch.tensor(sk), torch.tensor(sb)]
    for t in t_in:
        t.requires_grad_(True)
    out = bin_pool.binned_attention_pool_fused(t_in[0], t_in[1], torch.from_numpy(pm),
                                               t_in[2], t_in[3])
    assert not out[3].requires_grad
    for name, g, r in zip(("pooled_self", "pooled_other", "coverage", "attn"), out, ref):
        assert g.dtype == torch.float32
        _check(g.detach().numpy(), np.asarray(r, np.float32), dtype, name)
    torch.autograd.backward(out[:3], [torch.from_numpy(c) for c in cot])
    for name, t, r in zip(("d x_self", "d x_other", "d score_k", "d score_b"), t_in, ref_g):
        assert t.grad.dtype == t.dtype, name  # score grads stay fp32, as in JAX
        _check(t.grad.float().numpy(), np.asarray(r, np.float32), dtype, name)


def test_empty_slots_get_zero_and_plain_backward_is_the_autograd_function():
    """An empty molecule slot pools to 0 with coverage 0; atoms of no
    molecule get attention 0; covered molecules have coverage 1."""
    pm, xs, xo, sk, sb, _ = _inputs("float32", 16, seed=1)
    ps, po, cov, attn = bin_pool.binned_attention_pool_fused(
        torch.tensor(xs), torch.tensor(xo), torch.from_numpy(pm), torch.tensor(sk),
        torch.tensor(sb))
    members = pm.sum(axis=2).reshape(-1)
    assert members[15] == 0 and members[0] == 1
    assert float(ps[15].abs().max()) == 0.0 and float(cov[15]) == 0.0
    np.testing.assert_allclose(cov.numpy()[members > 0], 1.0, rtol=1e-6)
    uncovered = pm.sum(axis=1).reshape(-1) == 0
    assert float(attn[:, torch.from_numpy(uncovered)].abs().max()) == 0.0


def test_plain_pool_rejects_an_atom_in_two_molecules():
    pm, xs, xo, sk, sb, _ = _inputs("float32", 16)
    pm[1, :, 7] = 1
    with pytest.raises(ValueError):
        bin_pool.binned_attention_pool_fused(torch.tensor(xs), torch.tensor(xo),
                                             torch.from_numpy(pm), torch.tensor(sk),
                                             torch.tensor(sb))
