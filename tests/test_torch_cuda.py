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
