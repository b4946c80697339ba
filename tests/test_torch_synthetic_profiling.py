"""The port's last three ports of JAX host modules against them:
data/synthetic.py (molecules and batches array-equal for one seed),
utils/profiling.py (``StepTimer.summary`` equal under one fake clock, a
trace file written) and utils/random.py (``set_seed`` leaves Python's and
numpy's generators where JAX's does; raises for CUDA without a card)."""

import dataclasses
import os
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.data import synthetic as jax_synthetic
from aimnet_x2d_tpu.utils import profiling as jax_profiling
from aimnet_x2d_tpu.utils.random import set_seed as jax_set_seed
from aimnet_x2d_tpu_torch.data import synthetic
from aimnet_x2d_tpu_torch.utils import profiling, set_seed

from test_torch_halo_partition import _assert_same


@pytest.mark.parametrize("with_stereo", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_mols_and_batches_equal_jax(seed, with_stereo):
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for n in (5, 6, 18, 24):
        got = synthetic.make_synthetic_mol(rng, n, 3, with_stereo=with_stereo)
        want = jax_synthetic.make_synthetic_mol(jrng, n, 3, with_stereo=with_stereo)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "edge_hops":
                assert len(a) == len(b) == 3
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            elif isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
    kw = dict(num_graphs=40, seed=seed, with_stereo=with_stereo)
    batch = synthetic.make_synthetic_batch(**kw)
    _assert_same(batch, jax_synthetic.make_synthetic_batch(**kw))
    assert batch.targets.shape == (40, 12) and batch.graph_mask.all()
    assert bool(batch.tet_mask.any()) == with_stereo
    kw.update(num_graphs=9, mean_atoms=8, num_hops=2, num_tasks=1, atom_slots=128)
    _assert_same(synthetic.make_synthetic_batch(**kw), jax_synthetic.make_synthetic_batch(**kw))


def test_step_timer_summary_equals_jax(monkeypatch):
    ticks = [0.0, 0.010, 1.0, 1.012, 2.0, 2.0095, 3.0, 3.0131]

    def run(timer, result):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        dts = []
        for edges in (100, 250, 300, 275):
            timer.start()
            dts.append(timer.stop(result, num_real_edges=edges))
        return dts, timer.steps, timer.summary(), timer.summary(skip_warmup=0)

    got = run(profiling.StepTimer(), torch.ones(3))
    want = run(jax_profiling.StepTimer(), jnp.ones(3))
    assert got == want
    assert got[2]["steps"] == 3 and got[2]["edges_per_sec"] > 0
    empty = profiling.StepTimer()
    assert empty.summary() == jax_profiling.StepTimer().summary()


def test_trace_writes_a_file(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert os.path.getsize(tmp_path / "trace" / files[0]) > 0


@pytest.mark.parametrize("seed", [0, 42])
def test_set_seed_equals_jax(seed):
    jax_set_seed(seed)
    want = (random.random(), np.random.rand(3))
    gen = set_seed(seed, device="cpu")
    got = (random.random(), np.random.rand(3))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert gen.device.type == "cpu" and gen.initial_seed() == seed
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=torch.Generator().manual_seed(seed)))


def test_set_seed_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = random.getstate()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        set_seed(3)
    assert random.getstate() == state  # nothing seeded
