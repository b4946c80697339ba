"""The train loop's input pipeline (``training.trainer.prefetch_batches``,
the port of the JAX package's two-stage prefetch) and the native builder's
scratch rotation, on the CPU:

- the prefetch yields the loader's batches in its order, array for array
  equal to the serial loop's, with each batch's real edges (binned native
  batches, flat batches and halo shards);
- an error in the collate thread and one in the transfer thread are both
  raised in the consumer, with no hang (each run under a 60 s join);
- a consumer that stops early leaves no thread behind;
- the depth guard: ``2 * size + 3 > SCRATCH_SETS`` raises ValueError;
- with the rotation forced on, a built batch survives ``SCRATCH_SETS - 1``
  further builds bit-exactly, and the next build reuses its buffers (the
  port's twin of the JAX package's ``test_scratch_rotation_covers_prefetch``);
  the loaders rotate nothing unless asked, and ``train`` asks only on the
  card;
- ``train`` feeds its steps through the prefetch: the same losses as a
  serial loop of ``train_step`` with the same seeds, and the epoch record
  carries the prefetch's waits.
"""

import threading

import numpy as np
import pytest
import torch

from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax
from aimnet_x2d_tpu_torch.data.batching import MolBatch
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.data.native_batch import SCRATCH_SETS
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.training import trainer
from aimnet_x2d_tpu_torch.training.trainer import batch_edges, prefetch_batches

torch.set_num_threads(1)

UNITS = ["C", "CC", "O", "N", "C(C)", "C(=O)", "C=C", "c1ccc(cc1)", "C1CCC(CC1)", "[C@H](F)"]


def _smiles(n, seed, big=None):
    rng = np.random.default_rng(seed)
    out = ["C" + "".join(UNITS[rng.integers(len(UNITS))] for _ in range(int(rng.integers(1, 5))))
           + "O" for _ in range(n)]
    if big:
        out[3] = "C" * big
    return out


def _dataset(n=60, seed=0, big=None):
    smiles = _smiles(n, seed, big)
    t = np.random.default_rng(seed).normal(size=(n, 2)).astype(np.float32)
    return MoleculeDataset.from_smiles(smiles, t, 2)


def _fields_equal(a: MolBatch, b: MolBatch):
    for name in ("atom_type", "atom_mol", "atom_mask", "edge_src", "edge_dst", "targets",
                 "graph_mask", "bin_adj", "pool_mat", "halo_send_idx", "halo_adj", "tet_nbrs"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(torch.as_tensor(np.asarray(x)), y.cpu()), name


def _joined(fn, timeout=60):
    """Run ``fn`` in a thread; return what it raised (None if nothing),
    failing if it is still running after ``timeout`` seconds."""
    box = {}

    def run():
        try:
            fn()
            box["raised"] = None
        except BaseException as e:  # noqa: BLE001 - asserting propagation
            box["raised"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "prefetch hung"
    return box["raised"]


@pytest.mark.parametrize("kind", ["binned", "flat", "halo"])
def test_prefetch_matches_serial_order_and_arrays(kind):
    ds = _dataset(big=100 if kind == "flat" else None)
    kw = dict(stack_devices=1, halo_shards=2, rank=(0, 1)) if kind == "halo" else {}
    serial_loader, loader = (BatchLoader(ds, 16, shuffle=True, seed=3, **kw) for _ in range(2))
    assert loader.binned == (kind != "flat")
    # two loaders: a halo loader's slot pins grow as it goes
    for lo in (serial_loader, loader):
        lo.set_epoch(1)
    serial = list(serial_loader)
    stats = {}
    got = list(prefetch_batches(loader, "cpu", stats=stats))
    assert len(got) == len(serial) == len(loader) == stats["batches"] > 1
    for (b, edges), want in zip(got, serial):
        assert edges == batch_edges(want) > 0
        _fields_equal(want, b)
    assert stats["wait_s"] >= 0.0 and stats["copy_ms"] == 0.0


class _FakeBatch:
    halo_adj = None
    edge_mask = np.ones(4, bool)

    def to(self, device, copy=None):
        raise RuntimeError("copy failed")


def test_prefetch_transfer_error_raises_without_hang():
    # 16 batches: more than both queues hold, so the collate thread blocks
    # unless the failed transfer thread drains its queue
    err = _joined(lambda: list(prefetch_batches([_FakeBatch() for _ in range(16)], "cpu")))
    assert isinstance(err, RuntimeError) and "copy failed" in str(err)


def test_prefetch_collate_error_raises_without_hang():
    ds = _dataset()
    loader = BatchLoader(ds, 8)

    def failing():
        for i, b in enumerate(loader):
            if i == 3:
                raise ValueError("collate failed")
            yield b

    seen = []

    def consume():
        for b, _ in prefetch_batches(failing(), "cpu"):
            seen.append(b)

    err = _joined(consume)
    assert isinstance(err, ValueError) and "collate failed" in str(err)
    assert len(seen) <= 3  # batches built before the error may be dropped


def test_prefetch_consumer_stopping_early_ends_the_threads():
    before = threading.active_count()

    def stop_early():
        gen = prefetch_batches(BatchLoader(_dataset(), 4), "cpu")
        next(gen)
        gen.close()

    assert _joined(stop_early) is None
    assert threading.active_count() == before


def test_prefetch_depth_guard():
    assert 2 * 2 + 3 <= SCRATCH_SETS  # the default depth fits the rotation
    with pytest.raises(ValueError, match="SCRATCH_SETS"):
        list(prefetch_batches([], "cpu", size=3))


def test_scratch_rotation_survives_the_batches_in_flight():
    ds = _dataset(n=200, seed=5)
    loader = BatchLoader(ds, 16, shuffle=True, seed=0)
    assert loader.binned and loader._scratches is None  # no rotation unless asked
    loader.rotate_scratch()  # the card's rotation, here on unpinned host memory
    assert len(loader._scratches) == SCRATCH_SETS
    loader.warm_bin_pins()  # one shape for every batch: each scratch set is reused
    it = iter(loader)
    b0 = next(it)
    names = ("atom_type", "atom_mol", "edge_src", "edge_dst", "bin_adj", "pool_mat", "targets")
    snaps = {k: np.array(getattr(b0, k), copy=True) for k in names}
    for _ in range(SCRATCH_SETS - 1):
        next(it)
    for k, v in snaps.items():
        np.testing.assert_array_equal(getattr(b0, k), v, err_msg=f"{k} overwritten in flight")
    b8 = next(it)  # the rotation comes round: batch 8 reuses batch 0's buffers
    assert np.shares_memory(b8.bin_adj, b0.bin_adj)
    # without the rotation every batch owns its arrays
    fresh = BatchLoader(ds, 16, shuffle=True, seed=0)
    fresh.warm_bin_pins()
    batches = list(fresh)
    assert not np.shares_memory(batches[0].bin_adj, batches[SCRATCH_SETS].bin_adj)


def test_train_feeds_its_steps_through_the_prefetch(monkeypatch):
    cfg = GNNConfig(hidden_dim=32, output_dim=2, num_shells=2, num_message_passing_layers=2,
                    embedding_dim=8, ffn_num_layers=2, task_type="multitask",
                    shell_conv_dropout=0.05, ffn_dropout=0.05)
    ds = _dataset(n=48, seed=7)
    tc = trainer.TrainConfig(epochs=2, learning_rate=1e-3, task_type="multitask")
    calls = []
    real = trainer.prefetch_batches

    def spy(loader, device, size=2, stats=None):
        calls.append(str(device))
        return real(loader, device, size, stats)

    monkeypatch.setattr(trainer, "prefetch_batches", spy)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, 1)))
    res = trainer.train(model, BatchLoader(ds, 16, shuffle=True, seed=2), BatchLoader(ds, 16), tc,
                        device="cpu", seed=4)
    assert calls == ["cpu", "cpu"]
    for h in res.history:
        assert h["steps"] == 3 and h["input_wait_seconds"] >= 0.0 and h["copy_ms"] == 0.0

    # the serial loop with the same seeds: the same losses
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, 1)))
    opt = trainer.make_optimizer(model, tc)
    loss_fn = trainer.make_loss_fn(tc)
    host, dev = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    loader = BatchLoader(ds, 16, shuffle=True, seed=2)
    loader.set_epoch(0)
    losses = []
    for b in loader:
        seed = int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=host))
        loss, n = trainer.train_step(model, opt, b.to("cpu"), 1e-3, loss_fn, seed, dev)
        losses.append((float(loss), float(n)))
    want = sum(l * n for l, n in losses) / sum(n for _, n in losses)
    assert res.history[0]["train_loss"] == pytest.approx(want, rel=1e-6)
