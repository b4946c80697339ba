"""``GNNConfig.remat`` (the CLI's ``--gradient_checkpointing``): one
training-form step with both dropouts on, with and without remat, on each
per-layer route -- the inject route (config 3), the layer route (charges
only), the row-major route (flat batches; a per-hop model on binned ones)
and halo shards (the halo stack and the row-major halo route, on a graph
axis of one rank).  The loss and every gradient are equal, and the dropout
generator ends where it ends without remat (the recomputation replays its
state, then puts it back).  The fused stack route keeps no per-layer
activations and is left alone: remat changes nothing there."""

import dataclasses

import numpy as np
import pytest
import torch

from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax
from aimnet_x2d_tpu_torch.data.batching import index_batch
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig, mp_route
from aimnet_x2d_tpu_torch.parallel import halo, mesh

torch.set_num_threads(1)

SMILES = ["C[C@H](N)C(=O)O", "F/C=C/F", "F/C=C\\Cl", "C[C@@H](O)CC", "CCO", "c1ccccc1O",
          "O[C@H]1CC[C@@H](N)CC1", "CC(=O)N"]
BIG = "C" * 30  # 92 atoms with hydrogens: past a 64-atom bin, the batch goes flat
C3 = dict(use_partial_charges=True, use_stereochemistry=True)
CASES = {
    "inject": (C3, "binned"),
    "layer": (dict(use_partial_charges=True), "binned"),
    "rows-flat": (C3, "flat"),
    "rows-per-hop": (dict(parity_mode=False), "binned"),
    "halo-stack": (C3, "halo-binned"),
    "halo-rows": ({}, "halo-flat"),
}


def _batch(layout):
    smiles = SMILES + [BIG] if layout == "flat" else SMILES
    targets = np.random.default_rng(1).normal(size=(len(smiles), 2)).astype(np.float32)
    ds = MoleculeDataset.from_smiles(smiles, targets, 2)
    if layout.startswith("halo"):
        # the collated batch a halo loader partitions, cut for one rank
        collated = BatchLoader(ds, len(smiles), bin_ab=64, bin_mb=16, stack_devices=1,
                               halo_shards=2)._collate(np.arange(len(smiles)))
        kw = dict(binned=True, ab=64) if layout == "halo-binned" else {}
        return index_batch(halo.partition_halo(collated, 1, **kw), 0)
    loader = BatchLoader(ds, len(smiles), bin_ab=64, bin_mb=16)
    assert loader.binned == (layout == "binned")
    return next(iter(loader))


def _step(cfg, flat, batch, seed):
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    gen = torch.Generator().manual_seed(seed)
    out = model(batch.to("cpu"), train=True, generator=gen)
    loss = (out.predictions.float() ** 2).mean()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, torch.rand(4, generator=gen)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_equals_the_plain_step(case, monkeypatch):
    features, layout = CASES[case]
    if layout.startswith("halo"):
        monkeypatch.setitem(mesh._AXES, "graph", mesh.Axis("graph", 1, 0, None))
    kw = dict(hidden_dim=40, output_dim=2, num_shells=2, num_message_passing_layers=2,
              embedding_dim=8, ffn_num_layers=2, task_type="multitask",
              shell_conv_dropout=0.2, ffn_dropout=0.2, **features)
    cfg = GNNConfig(**kw)
    assert layout.startswith("halo") or mp_route(cfg) != "stack"
    flat = init_params(cfg, seed=3)
    batch = _batch(layout)
    assert (batch.halo_send_idx is not None) == layout.startswith("halo")
    loss, grads, after = _step(cfg, flat, batch, seed=11)
    r_loss, r_grads, r_after = _step(dataclasses.replace(cfg, remat=True), flat, batch, seed=11)
    print(f"{case}: loss {float(loss):.7f} remat {float(r_loss):.7f}")
    torch.testing.assert_close(r_loss, loss, rtol=0, atol=0)
    assert grads.keys() == r_grads.keys() and len(grads) > 10
    worst = max(float((r_grads[k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                for k, g in grads.items())
    print(f"{case}: worst gradient rel {worst:.3e}")
    for k, g in grads.items():
        torch.testing.assert_close(r_grads[k], g, rtol=0, atol=0, msg=k)
    torch.testing.assert_close(r_after, after, rtol=0, atol=0)
    # the layers' dropout ran: another seed moves the loss
    other, _, _ = _step(cfg, flat, batch, seed=12)
    assert float(other) != float(loss)
