"""Plain PyTorch versions of the port's two kernels against the JAX
package's Pallas kernels, which run here in interpret mode, as the JAX
package's own kernel tests run them (tests/test_bin_mp.py).

- ops/bin_mp.py::mp_stack_plain  vs  binned_mp_stack_t (fused MP stack)
- ops/bin_wpool.py::wpool_plain  vs  binned_wpool_t (weighted pool)

Inputs are made from a seed with numpy and handed to both.  Tolerances:
fp32 rtol 5e-4 / atol 5e-5, the repo's own bar for the JAX package against
its torch oracle (tests/test_parity.py), since both sides accumulate in
fp32 and differ only in summation order; bf16 max|d|/max|ref| < 5e-2, the
bar of benchmarks/tpu_kernel_parity.py, since one fp32 sum rounding to the
other bf16 neighbour moves an intermediate by 2**-8 and that propagates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.ops.bin_mp import binned_mp_stack_t as jax_stack
from aimnet_x2d_tpu.ops.bin_wpool import binned_wpool_t as jax_wpool
from aimnet_x2d_tpu_torch.ops import bin_mp, bin_wpool

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    monkeypatch.setenv("AIMNET_WPOOL_KERNEL", "interpret")


def _check(got, ref, dtype):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    print(f"{dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / np.abs(ref).max():.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5)
    else:
        assert err / np.abs(ref).max() < 5e-2


def _adjacency(rng, nb, ab):
    adj = np.zeros((nb, ab, ab), np.int8)
    for b in range(nb):
        n = rng.integers(ab // 2, ab + 1)  # real atoms in this bin
        for _ in range(4 * n):
            i, j = rng.integers(0, n, 2)
            if i != j:
                adj[b, i, j] += 1
    return adj


def _stack_inputs(seed, D=19, nb=3, ab=32, n_layers=2, n_blocks=2):
    rng = np.random.default_rng(seed)
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
    return x, adj, layers


@pytest.mark.parametrize("act", ["silu", "relu", "leakyrelu", "elu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_plain_matches_jax(dtype, act):
    x, adj, layers = _stack_inputs(seed=11)
    ref = jax_stack(
        jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(adj),
        tuple(tuple(jnp.asarray(w) for w in lw) for lw in layers),
        act=act, num_mlp_layers=2, compute_dtype=JDT[dtype], interpret=True,
    )
    sw = bin_mp.stack_weights([[torch.from_numpy(w) for w in lw] for lw in layers], TDT[dtype])
    got = bin_mp.binned_mp_stack_t(
        torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(adj), sw, act=act
    )
    assert got.dtype == TDT[dtype] and got.shape == x.shape
    _check(got.float(), ref.astype(jnp.float32), dtype)


@pytest.mark.parametrize("mb", [8, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wpool_plain_matches_jax(dtype, mb):
    rng = np.random.default_rng(5)
    D, nb, ab = 23, 4, 32
    x = rng.normal(size=(D, nb * ab)).astype(np.float32)
    w = rng.uniform(0, 1, nb * ab).astype(np.float32)
    owner = rng.integers(-1, mb, (nb, ab))
    pm = (owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)
    ref = jax_wpool(jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(w), jnp.asarray(pm),
                    interpret=True)
    got = bin_wpool.binned_wpool_t(
        torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w), torch.from_numpy(pm)
    )
    assert got.dtype == torch.float32 and got.shape == (D, nb * mb)
    _check(got, ref, dtype)


def test_stack_padding_rows_stay_zero():
    """D is padded to a multiple of 16 in the prepped weights only; the
    padded rows of x stay exactly 0 through every layer."""
    x, adj, layers = _stack_inputs(seed=2, D=19)
    sw = bin_mp.stack_weights([[torch.from_numpy(w) for w in lw] for lw in layers],
                              torch.float32)
    assert sw.Dp == 32 and sw.layers[0][0].shape == (32, 64)
    xp = torch.cat([torch.from_numpy(x), torch.zeros(13, x.shape[1])])
    out = xp
    fn = torch.nn.functional.silu
    for ws in sw.layers:
        out = bin_mp._layer_plain(out, torch.from_numpy(adj), ws, fn, sw.n_blocks) + out
    assert not out[19:].any()
    torch.testing.assert_close(out[:19], bin_mp.mp_stack_plain(
        torch.from_numpy(x), torch.from_numpy(adj), sw, "silu"))


def test_tile_major_layout():
    """bf16 weight matrices reach the CUDA kernel tile-major: element (r, c)
    of an (R, C) matrix sits where the kernel's fragment loads look for it."""
    w = torch.arange(32 * 48).reshape(32, 48)
    r, c = torch.meshgrid(torch.arange(32), torch.arange(48), indexing="ij")
    at = ((r // 16) * 3 + c // 16) * 256 + (r % 16) * 16 + c % 16
    assert torch.equal(bin_mp.tile_major(w)[at], w)
    x, adj, layers = _stack_inputs(seed=3)
    lw = [[torch.from_numpy(w) for w in ws] for ws in layers]
    sw = bin_mp.stack_weights(lw, torch.bfloat16)
    w_in = sw.layers[0][0]  # first matrix of the flat buffer
    assert torch.equal(sw.flat[: w_in.numel()], bin_mp.tile_major(w_in))
    sw32 = bin_mp.stack_weights(lw, torch.float32)  # fp32 stays row-major
    assert torch.equal(sw32.flat[: w_in.numel()], sw32.layers[0][0].reshape(-1))


def test_kernel_wrappers_refuse_what_they_cannot_launch():
    """The CUDA wrappers never fall back: a CPU tensor is refused, and the
    dispatchers refuse devices they have no path for."""
    x, adj, layers = _stack_inputs(seed=1)
    sw = bin_mp.stack_weights([[torch.from_numpy(w) for w in lw] for lw in layers],
                              torch.float32)
    xt, at = torch.from_numpy(x), torch.from_numpy(adj)
    with pytest.raises(ValueError):
        bin_mp.mp_stack_fwd(xt, at, sw, "silu")
    pm = torch.zeros(3, 8, 32, dtype=torch.int8)
    with pytest.raises(ValueError):
        bin_wpool.wpool_fwd(xt, torch.ones(xt.shape[1]), pm)
    with pytest.raises(ValueError):
        bin_mp.binned_mp_stack_t(xt.to("meta"), at.to("meta"), sw, "silu")
    with pytest.raises(ValueError):
        bin_wpool.binned_wpool_t(xt.to("meta"), torch.ones(xt.shape[1]), pm.to("meta"))
