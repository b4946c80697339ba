"""Several epochs of the port's ``training.trainer.train`` against the JAX
package's ``train``, on the CPU: the same weights (``init_params``), the
same seeded shuffles of the same small dataset, dropouts 0, lr 1e-3, the
default plateau scheduler and global-norm clip.  Three cells:

- config 3 (partial charges and stereochemistry) on binned batches (the
  JAX side's kernels in interpret mode: the inject kernel, the single-layer
  kernel, the fused attention pool);
- the flagship model (attention pooling, 3 shells) on flat batches (a
  dataset holding a molecule larger than a bin; JAX with its kernel-7
  layouts in interpret mode);
- config 3 on flat batches.

Every epoch's train and validation loss and the final parameters are held
to the fp32 bar (rtol 5e-4 / atol 5e-5), save the attention heads' score
biases: a bias shifts every score of its head alike, which leaves each
molecule's softmax unchanged, so its exact gradient is 0 and each side's
Adam step turns its own rounding residue into a move of up to lr; those are
held to lr per step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.data.dataset import BatchLoader as JaxLoader
from aimnet_x2d_tpu.data.dataset import MoleculeDataset as JaxDataset
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.training import trainer as jax_trainer
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.training import trainer

torch.set_num_threads(1)

SMILES = ["C[C@H](N)C(=O)O", "F/C=C/F", "F/C=C\\Cl", "C[C@@H](O)CC", "CCO",
          "N[C@@H](C)C(=O)O", "C/C=C/C(=O)O", "O[C@H]1CC[C@@H](N)CC1", "c1ccccc1O",
          "Cl/C=C\\C[C@H](F)Br", "CC(=O)N", "OCC(O)CO", "CCCCCCCC", "c1ccncc1C", "CC(C)O"]
BIG = "C" * 90  # 272 atoms with hydrogens: the dataset goes flat
C3 = dict(use_partial_charges=True, use_stereochemistry=True)
CELLS = {"config3-binned": (C3, False), "flagship-flat": ({}, True), "config3-flat": (C3, True)}
EPOCHS, LR, BATCH = 3, 1e-3, 8


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for var in ("AIMNET_MP_MEGAKERNEL", "AIMNET_INJECT_FUSED", "AIMNET_WPOOL_KERNEL",
                "AIMNET_ATTNPOOL_KERNEL"):
        monkeypatch.setenv(var, "interpret")
    monkeypatch.setenv("AIMNET_MP_PROJ", "1")


def _tree(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("cell", list(CELLS))
def test_epochs_match_jax_train(cell):
    features, flat_layout = CELLS[cell]
    smiles = SMILES[:7] + [BIG] + SMILES[7:] if flat_layout else SMILES + ["CC#N"]
    targets = np.random.default_rng(0).normal(size=(len(smiles), 2)).astype(np.float32)
    kw = dict(hidden_dim=40, embedding_dim=8, num_message_passing_layers=2, num_shells=3,
              output_dim=2, ffn_num_layers=2, task_type="multitask", shell_conv_dropout=0.0,
              ffn_dropout=0.0, **features)
    cfg = GNNConfig(**kw)
    flat = init_params(cfg, seed=5)

    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    ds = MoleculeDataset.from_smiles(smiles, targets, 3)
    bins = dict(bin_ab=64, bin_mb=16)
    loader = BatchLoader(ds, BATCH, shuffle=True, seed=7, **bins)
    assert loader.binned != flat_layout
    got = trainer.train(model, loader, BatchLoader(ds, 16, **bins),
                        trainer.TrainConfig(epochs=EPOCHS, learning_rate=LR, task_type="multitask"),
                        device="cpu", seed=0)

    jds = JaxDataset.from_smiles(smiles, targets, 3)
    jkw = dict(fused_edges=True) if flat_layout else dict(binned=True, **bins)
    ref = jax_trainer.train(
        JaxGNN(JaxConfig(**kw)), _tree(flat), JaxLoader(jds, BATCH, shuffle=True, seed=7, **jkw),
        JaxLoader(jds, 16, **jkw),
        jax_trainer.TrainConfig(epochs=EPOCHS, learning_rate=LR, task_type="multitask"),
        verbose=False)

    for what in ("train_loss", "val_loss"):
        g, r = [h[what] for h in got.history], [h[what] for h in ref.history]
        print(f"{cell} {what}: port {np.round(g, 6).tolist()} jax {np.round(r, 6).tolist()}")
        np.testing.assert_allclose(g, r, rtol=5e-4, atol=5e-5, err_msg=what)
    steps = EPOCHS * len(loader)
    got_p, ref_p = params_to_flax(got.state_dict, cfg), _flat(ref.params)
    worst = max(float(np.abs(got_p[k] - ref_p[k]).max()) for k in ref_p
                if "attention_weights" not in k or not k.endswith("bias"))
    print(f"{cell} after {steps} steps: parameters worst max|d| {worst:.2e}")
    for k, v in ref_p.items():
        if k.startswith("params/pooling/attention_weights_") and k.endswith("/bias"):
            assert np.abs(got_p[k] - v).max() <= steps * LR + 5e-5, k
        else:
            np.testing.assert_allclose(got_p[k], v, rtol=5e-4, atol=5e-5, err_msg=k)
