"""The library yardsticks that ``chip_smoke.py`` times beside kernels 2 and
2b compute the kernels' function: on CPU tensors in fp32, each single
PyTorch call against the port's plain versions (``wpool_plain``, and
``wpool_bwd_plain``'s dx), on one-hot and not one-hot pool matrices.  A
yardstick that left part of the work outside the timed call (the
weighting, w in the backward) would fail here.  The port never calls
them."""

import numpy as np
import pytest
import torch

import chip_smoke
from aimnet_x2d_tpu_torch.ops import bin_wpool

# fp32 sums of the same exact products in another order
RTOL = 1e-6


def _inputs(nb, mb, ab, D, multi, seed):
    rng = np.random.default_rng(seed)
    owner = rng.integers(-1, mb, (nb, ab))
    pm = (owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)
    if multi:  # atoms in two slots (2 and -1), slot 0 empty
        two = ((np.arange(ab) % 3 == 0)[None, :] & (owner >= 0))[:, None, :]
        pm = np.where(two, 2 * pm, pm).astype(np.int8)
        pm = pm - (two & (((owner + 1) % mb)[:, None, :] == np.arange(mb)[None, :, None]))
        pm[:, 0] = 0
    x = rng.standard_normal((D, nb * ab)).astype(np.float32)
    w = rng.random(nb * ab).astype(np.float32)
    g = rng.standard_normal((D, nb * mb)).astype(np.float32)
    return (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(pm.astype(np.int8)),
            torch.from_numpy(g))


def _close(got, ref):
    ref = ref.numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


CASES = [(3, 32, 7), (1, 64, 1), (4, 16, 19)]  # (nb, ab, D)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("mb", [1, 5, 16])
@pytest.mark.parametrize("case", CASES)
def test_wpool_fwd_library_is_the_pool(case, mb, multi):
    nb, ab, D = case
    x, w, pm, _ = _inputs(nb, mb, ab, D, multi, seed=mb + 10 * D)
    got = chip_smoke.wpool_fwd_library(x.reshape(D, nb, ab), w.reshape(nb, ab), pm.float())
    _close(got.reshape(D, nb * mb), bin_wpool.wpool_plain(x, w, pm))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("mb", [1, 5, 16])
@pytest.mark.parametrize("case", CASES)
def test_wpool_bwd_dx_library_is_the_pool_backward(case, mb, multi):
    nb, ab, D = case
    x, w, pm, g = _inputs(nb, mb, ab, D, multi, seed=7 + mb + 10 * D)
    got = chip_smoke.wpool_bwd_dx_library(g.reshape(D, nb, mb), pm.float(), w.reshape(nb, ab))
    dx, _ = bin_wpool.wpool_bwd_plain(x, w, pm, g, need_dw=False)
    _close(got.reshape(D, nb * ab), dx)
