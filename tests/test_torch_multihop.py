"""True per-hop aggregation (``parity_mode=False``, the CLI's
``--true_multi_hop``) of the PyTorch port against the JAX package, on the
CPU.  JAX's fused binned routes need parity mode, so both packages run the
row-major route on binned and flat batches alike.

- one shell-convolution layer with per-hop sums against the JAX layer, on a
  binned and a flat batch, fp32 and bf16;
- the serving forward on a binned batch for attention, mean, sum and max
  pooling, fp32 and bf16, against ``GNN.apply``; attention against JAX's
  default unfused pool and against kernel 6 in interpret mode
  (``AIMNET_POOL_KERNEL=interpret``), which the port runs;
- one train step on a binned batch for each pooling type (loss, every
  gradient, every parameter after clip + Adam; dropouts 0);
- config 3 (partial charges and stereochemistry) under per-hop aggregation
  on a binned batch: forward and one step;
- the CLI trains with ``--true_multi_hop`` and serves on a binned and on a
  flat dataset, and the JAX pipeline serves the artifact alike.

Bars: fp32 rtol 5e-4 / atol 5e-5; bf16 max|d|/max|ref| < 5e-2 (the repo's
bars, tests/test_torch_model.py).  Run with ``-s`` to print the errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu.chem import compute_features as jax_features
from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.data.batching import attach_fused_layouts
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.data.binning import bin_pack_batch as jax_bin_pack
from aimnet_x2d_tpu.inference.pipeline import StreamingInferencePipeline as JaxPipeline
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.models.layers import ShellConvolutionLayer as JaxLayer
from aimnet_x2d_tpu.training import trainer as jax_trainer
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.chem import compute_features
from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts, collate
from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.parallel import mesh
from aimnet_x2d_tpu_torch.training import trainer

torch.set_num_threads(1)

SMILES = ["C[C@H](N)C(=O)O", "F/C=C/F", "c1ccccc1O", "CC(=O)N", "C1CCC(CC1)OC#N",
          "Cl/C=C\\C[C@H](F)Br", "N#CC=CC", "OCC(O)CO", "C[C@@H](O)CC", "c1ccncc1C"]
BIG = "C" * 90  # 272 atoms with hydrogens: a dataset holding it goes flat
C3 = dict(use_partial_charges=True, use_stereochemistry=True)


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


def _check(got, ref, dtype, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    print(f"{what} {dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / np.abs(ref).max():.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=what)
    else:
        assert err / np.abs(ref).max() < 5e-2, what


def _check_update(got_p, ref_p, ref_g, lr):
    """Parameters after the step, to the fp32 bar; where the reference
    gradient is zero up to fp32 rounding (|g| <= 1e-7: an L1 loss whose
    signs cancel, a softmax bias), Adam's first step lr g / (|g| + eps) turns
    either side's rounding residue into a move of up to lr, so those
    elements are held to lr + atol."""
    for k, v in ref_p.items():
        zero = np.abs(ref_g[k]) <= 1e-7
        np.testing.assert_allclose(got_p[k][~zero], v[~zero], rtol=5e-4, atol=5e-5, err_msg=k)
        assert np.all(np.abs(got_p[k][zero] - v[zero]) <= lr + 5e-5), k


def _kw(**kw):
    base = dict(hidden_dim=48, embedding_dim=8, num_message_passing_layers=2, output_dim=2,
                num_shells=3, ffn_num_layers=2, task_type="multitask", parity_mode=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def batches():
    """{"binned": (JAX, port), "flat": (JAX, port)}: the same collated
    arrays, random targets; the flat pair holds BIG."""
    out = {}
    for layout, smiles in (("binned", SMILES), ("flat", SMILES[:6] + [BIG] + SMILES[6:])):
        t = np.random.default_rng(0).normal(size=(len(smiles), 2)).astype(np.float32)
        jb = jax_collate([jax_features(s, 3) for s in smiles], t, num_hops=3)
        pb = collate([compute_features(s, 3) for s in smiles], t, num_hops=3)
        if layout == "binned":
            jb, pb = jax_bin_pack(jb, ab=64, mb=16), bin_pack_batch(pb, ab=64, mb=16)
        else:
            jb, pb = attach_fused_layouts(jb), attach_flat_layouts(pb)
        out[layout] = (jb, pb.to("cpu"))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["binned", "flat"])
def test_per_hop_layer_matches_jax(batches, layout, dtype):
    jb, pb = batches[layout]
    kw = _kw(compute_dtype=dtype)
    flat = init_params(GNNConfig(**kw), seed=3)
    lp = {k.split("/", 2)[2]: v for k, v in flat.items()
          if k.startswith("params/message_passing_layers_0/")}
    cdt = jnp.bfloat16 if dtype == "bfloat16" else None
    D = GNNConfig(**kw).x_other_dim
    x = np.random.default_rng(1).normal(size=(pb.num_atom_slots, D)).astype(np.float32)
    x = np.array(jnp.asarray(x, cdt or jnp.float32).astype(jnp.float32))
    ref = JaxLayer(dim=D, num_hops=3, parity_mode=False, dtype=cdt).apply(
        {"params": _tree(lp)}, jnp.asarray(x, cdt or jnp.float32), jb.edge_src, jb.edge_dst,
        jb.edge_hop, jb.edge_mask, True)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with torch.no_grad():
        got = model.message_passing_layers[0](torch.from_numpy(x).to(tdt), pb)
    am = np.asarray(pb.atom_mask)
    _check(got.float().numpy()[am], np.asarray(ref, np.float32)[am], dtype, f"layer {layout}")
    # every hop's block of the input projection sees data
    assert pb.edge_hop[pb.edge_mask].max() == 3


def _forward(kw, jb, pb, seed=7):
    flat = init_params(GNNConfig(**kw), seed=seed)
    ref = JaxGNN(JaxConfig(**kw)).apply(_tree(flat), jb, deterministic=True)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        out = model.eval()(pb, atom_embeddings=True)
    return out, ref


def _compare(out, ref, pb, dtype, kw):
    gm, am = np.asarray(pb.graph_mask), np.asarray(pb.atom_mask)
    _check(out.predictions.numpy()[gm], np.asarray(ref.predictions)[gm], dtype, "predictions")
    _check(out.mol_embeddings.numpy()[gm], np.asarray(ref.mol_embeddings, np.float32)[gm], dtype,
           "mol emb")
    _check(out.atom_embeddings.numpy()[am], np.asarray(ref.atom_embeddings)[am], dtype, "atom emb")
    if kw.get("pooling_type", "attention") == "attention":
        _check(out.attention_weights.numpy(), np.asarray(ref.attention_weights), dtype, "attention")
    if kw.get("use_partial_charges"):
        _check(out.partial_charges.numpy()[am], np.asarray(ref.partial_charges, np.float32)[am],
               dtype, "charges")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooling", ["attention", "attention-kernel", "mean", "sum", "max"])
def test_binned_forward_matches_jax(batches, pooling, dtype, monkeypatch):
    """The row-major binned route; ``attention-kernel`` holds the port to
    JAX's kernel 6 (interpret mode), ``attention`` to its default unfused
    pool."""
    if pooling == "attention-kernel":
        monkeypatch.setenv("AIMNET_POOL_KERNEL", "interpret")
    kw = _kw(pooling_type=pooling.split("-")[0], compute_dtype=dtype)
    jb, pb = batches["binned"]
    out, ref = _forward(kw, jb, pb)
    _compare(out, ref, pb, dtype, kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_config3_binned_forward_matches_jax(batches, dtype, monkeypatch):
    monkeypatch.setenv("AIMNET_POOL_KERNEL", "interpret")
    kw = _kw(compute_dtype=dtype, **C3)
    jb, pb = batches["binned"]
    assert pb.tet_mask.sum() >= 2 and pb.cis_mask.sum() + pb.trans_mask.sum() >= 2
    out, ref = _forward(kw, jb, pb)
    _compare(out, ref, pb, dtype, kw)


def _step(kw, jb, pb, seed=5, lr=1e-3, clip=1.0):
    """One fp32 train step in both packages (dropouts 0): loss, every
    gradient, every parameter after clip + Adam."""
    kw = dict(kw, shell_conv_dropout=0.0, ffn_dropout=0.0)
    flat = init_params(GNNConfig(**kw), seed=seed)
    jcfg = jax_trainer.TrainConfig(learning_rate=lr, loss_function="l1", grad_clip=clip,
                                   task_type="multitask")
    jmodel = JaxGNN(JaxConfig(**kw))
    loss_ref, grads_ref = jax.value_and_grad(jax_trainer.make_loss_fn(jmodel, jcfg))(_tree(flat), jb)
    params = _tree(flat)
    opt = jax_trainer.make_optimizer(jcfg)
    new_ref, _, _, _ = jax_trainer.make_train_step(jmodel, jcfg, opt)(
        params, opt.init(params), jb, jnp.float32(lr), jax.random.PRNGKey(0))

    cfg = GNNConfig(**kw)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    tcfg = trainer.TrainConfig(grad_clip=clip, task_type="multitask")
    opt_t = trainer.make_optimizer(model, tcfg)
    loss = trainer.make_loss_fn(tcfg)(model(pb, train=True).predictions, pb.targets, pb.graph_mask)
    loss.backward()
    loss = float(loss.detach())
    print(f"step: loss port {loss:.7f} jax {float(loss_ref):.7f}")
    np.testing.assert_allclose(loss, float(loss_ref), rtol=5e-4, atol=5e-5)
    got_g = params_to_flax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                            for k, p in model.named_parameters()}, cfg)
    ref_g = _flat(grads_ref)
    assert set(got_g) == set(ref_g)
    print(f"step: grads worst max|d| {max(np.abs(got_g[k] - ref_g[k]).max() for k in ref_g):.2e}")
    for k in ref_g:
        np.testing.assert_allclose(got_g[k], ref_g[k], rtol=5e-4, atol=5e-5, err_msg=k)
    # the hop blocks 2..K of the input projection get gradient (per-hop sums)
    w_in = ref_g["params/message_passing_layers_0/input_proj_kernel"]
    D = cfg.x_other_dim
    assert np.abs(got_g["params/message_passing_layers_0/input_proj_kernel"][3 * D:]).max() > 0
    assert np.abs(w_in[3 * D:]).max() > 0
    opt_t.step(lr)
    _check_update(params_to_flax(model.state_dict(), cfg), _flat(new_ref), ref_g, lr)
    return got_g


@pytest.mark.parametrize("pooling", ["attention", "mean", "sum", "max"])
def test_binned_train_step_matches_jax(batches, pooling, monkeypatch):
    monkeypatch.setenv("AIMNET_POOL_KERNEL", "interpret")
    jb, pb = batches["binned"]
    _step(_kw(pooling_type=pooling), jb, pb)


def test_config3_binned_train_step_matches_jax(batches, monkeypatch):
    monkeypatch.setenv("AIMNET_POOL_KERNEL", "interpret")
    jb, pb = batches["binned"]
    g = _step(_kw(**C3), jb, pb)
    assert np.abs(g["params/stereochemical_embedding_2/kernel"]).max() > 0


def test_true_multi_hop_cli_trains_and_serves_both_layouts(tmp_path):
    """--true_multi_hop through the CLI on a binned and a flat dataset: the
    artifact carries parity_mode=False, and the port's and JAX's pipelines
    serve it alike."""
    rng = np.random.default_rng(0)
    for layout, smiles in (("binned", SMILES * 2), ("flat", SMILES * 2 + [BIG])):
        csv = str(tmp_path / f"{layout}.csv")
        pd.DataFrame({"smiles": smiles, "y": rng.normal(size=len(smiles))}).to_csv(csv, index=False)
        art = str(tmp_path / f"{layout}.npz")
        summary = cli.main([
            "--data_path", csv, "--target_column", "y", "--true_multi_hop", "--epochs", "2",
            "--batch_size", "8", "--hidden_dim", "32", "--embedding_dim", "8",
            "--num_message_passing_layers", "2", "--ffn_num_layers", "2", "--model_save_path",
            art, "--device", "cpu", "--seed", "1"])
        assert np.isfinite(summary["test_metrics"]["mae"])
        mc = jax_load_artifact(art).model_config
        assert mc.parity_mode is False
        mols = str(tmp_path / f"{layout}-mols.csv")
        pd.DataFrame({"smiles": smiles[-6:]}).to_csv(mols, index=False)
        ref, out = str(tmp_path / f"{layout}-jax.csv"), str(tmp_path / f"{layout}-port.csv")
        JaxPipeline(artifact_path=art, chunk_size=4, batch_size=4).run_csv(mols, ref)
        cli.main(["--inference_csv", mols, "--model_save_path", art, "--inference_output", out,
                  "--device", "cpu", "--stream_batch_size", "4"])
        g, r = pd.read_csv(out), pd.read_csv(ref)
        assert g["smiles"].tolist() == r["smiles"].tolist()
        print(f"{layout}: served {len(g)} rows, max|d| {np.abs(g['y'] - r['y']).max():.2e}")
        np.testing.assert_allclose(g["y"].to_numpy(), r["y"].to_numpy(), rtol=5e-4, atol=5e-5)


def test_graph_axis_still_raises(monkeypatch):
    """A per-hop model with a graph axis builds (it runs on halo shards:
    tests/test_torch_halo_config3.py); on a batch that is no halo shard it
    is the edge-replicated mode, which raises outside a rank grid and on a
    one-rank graph axis equals the per-hop model without it (the same
    per-hop sums)."""
    cfg = dataclasses.replace(GNNConfig(**_kw()), graph_axis="g")
    weights = params_from_flax(init_params(cfg, seed=0))
    model = GNN(cfg)
    model.load_state_dict(weights)
    flat = attach_flat_layouts(collate([compute_features(s, 3) for s in SMILES[:3]],
                                       np.zeros((3, 1)), num_hops=3)).to("cpu")
    with pytest.raises(RuntimeError, match="no grid axis 'g'"):
        model(flat)
    monkeypatch.setitem(mesh._AXES, "g", mesh.Axis("g", 1, 0, None))
    plain = GNN(dataclasses.replace(cfg, graph_axis=None))
    plain.load_state_dict(weights)
    with torch.no_grad():
        np.testing.assert_array_equal(model(flat).predictions.numpy(),
                                      plain(flat).predictions.numpy())
