"""Mean, sum and max pooling of the port against the JAX package, on the CPU.

- the weighted pool's backward (``wpool_bwd_plain``: dx and dw) against
  ``jax.vjp`` of the JAX ``binned_wpool_t`` with its Pallas kernel in
  interpret mode (kernel 2b), fp32 and bf16, D below and above 128, w = 1
  and random;
- serving predictions of config 1 (1 shell, mean pooling), sum and max
  pooling against ``GNN.apply``;
- one train step of config 1, of sum and of max pooling (with tied atoms)
  against ``trainer.make_train_step``: the loss, every gradient and every
  updated parameter.

Bars: fp32 rtol 5e-4 / atol 5e-5; bf16 max|d|/max|ref| < 5e-2 (the repo's
bars, tests/test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.chem import compute_features as jax_features
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.data.binning import bin_pack_batch as jax_bin_pack
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.ops.bin_wpool import binned_wpool_t as jax_wpool
from aimnet_x2d_tpu.training import trainer as jax_trainer
from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.chem import compute_features
from aimnet_x2d_tpu_torch.data.batching import collate
from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.ops.bin_wpool import binned_wpool_t, wpool_bwd_plain
from aimnet_x2d_tpu_torch.training import trainer

torch.set_num_threads(1)

# methane and ethane: their hydrogens have equal embeddings, so the max
# pool ties on them
SMILES = ["C", "CC", "CCO", "c1ccccc1O", "CC(=O)N", "C1CCC(CC1)OC#N", "CC(C)(F)F", "N#CC=CC",
          "OCC(O)CO", "C[C@H](N)C(=O)O"]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    monkeypatch.setenv("AIMNET_MP_PROJ", "1")
    monkeypatch.setenv("AIMNET_WPOOL_KERNEL", "interpret")


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


def _batches(num_hops, n=len(SMILES), seed=0, T=1):
    targets = np.random.default_rng(seed).normal(size=(n, T)).astype(np.float32)
    jb = jax_bin_pack(jax_collate([jax_features(s, num_hops) for s in SMILES[:n]], targets,
                                  num_hops=num_hops), ab=64, mb=16)
    pb = bin_pack_batch(collate([compute_features(s, num_hops) for s in SMILES[:n]], targets,
                                num_hops=num_hops), ab=64, mb=16)
    return jb, pb


@pytest.mark.parametrize("w_kind", ["ones", "random"])
@pytest.mark.parametrize("D", [24, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wpool_bwd_plain_matches_jax_vjp(dtype, D, w_kind):
    rng = np.random.default_rng(D + len(w_kind))
    nb, mb, ab = 3, 12, 32
    A = nb * ab
    owner = rng.integers(-1, mb, (nb, ab))
    pm = (owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)
    x = rng.normal(size=(D, A)).astype(np.float32)
    w = np.ones(A, np.float32) if w_kind == "ones" else \
        (rng.random(A) * (owner >= 0).reshape(-1)).astype(np.float32)
    g = rng.normal(size=(D, nb * mb)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    out_ref, vjp = jax.vjp(lambda x_, w_: jax_wpool(x_, w_, jnp.asarray(pm), interpret=True),
                           xj, jnp.asarray(w)[None])
    dx_ref, dw_ref = vjp(jnp.asarray(g))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(tdt)
    dx, dw = wpool_bwd_plain(xt, torch.from_numpy(w), torch.from_numpy(pm), torch.from_numpy(g))
    assert dx.dtype == tdt and dw.dtype == torch.float32
    _check(dx.float(), np.asarray(dx_ref.astype(jnp.float32)), dtype, f"dx D={D} w={w_kind}")
    _check(dw, np.asarray(dw_ref).reshape(-1), dtype, f"dw D={D} w={w_kind}")
    # the autograd Function routes the same backward, and skips dw when w
    # needs no gradient
    xg = xt.clone().requires_grad_(True)
    wg = torch.from_numpy(w).requires_grad_(w_kind == "random")
    out = binned_wpool_t(xg, wg, torch.from_numpy(pm))
    _check(out.detach(), np.asarray(out_ref), dtype, f"pooled D={D} w={w_kind}")
    out.backward(torch.from_numpy(g))
    torch.testing.assert_close(xg.grad, dx, rtol=0, atol=0)
    assert (wg.grad is None) == (w_kind == "ones")
    if wg.grad is not None:
        torch.testing.assert_close(wg.grad, dw, rtol=0, atol=0)


@pytest.mark.parametrize("pooling,num_shells,dtype", [
    ("mean", 1, "float32"), ("mean", 1, "bfloat16"), ("sum", 3, "float32"),
    ("max", 1, "float32"), ("max", 1, "bfloat16"),
])
def test_serving_matches_jax(pooling, num_shells, dtype):
    kw = dict(hidden_dim=48, embedding_dim=8, num_message_passing_layers=3, output_dim=1,
              num_shells=num_shells, ffn_num_layers=3, pooling_type=pooling, compute_dtype=dtype)
    jb, pb = _batches(num_shells)
    flat = init_params(GNNConfig(**kw), seed=11)
    ref = JaxGNN(JaxConfig(**kw)).apply(_tree(flat), jb, deterministic=True)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat))
    with torch.inference_mode():
        out = model.eval()(pb.to("cpu"), atom_embeddings=True)
    gm = pb.graph_mask
    _check(out.predictions.numpy()[gm], np.asarray(ref.predictions)[gm], dtype, "predictions")
    _check(out.mol_embeddings.numpy()[gm], np.asarray(ref.mol_embeddings, np.float32)[gm], dtype,
           "mol emb")
    assert out.attention_weights is None


def _ties(model, batch):
    """Number of (molecule, feature) maxima that two or more atoms share."""
    with torch.inference_mode():
        emb = model(batch, atom_embeddings=True).atom_embeddings
    nb, mb, ab = batch.pool_mat.shape
    pm = batch.pool_mat.reshape(nb, mb, ab).bool()
    xb = emb.reshape(nb, ab, -1)
    n = 0
    for b in range(nb):
        for m in range(mb):
            if pm[b, m].any():
                v = xb[b][pm[b, m]]
                n += int(((v == v.max(0).values).sum(0) > 1).sum())
    return n


@pytest.mark.parametrize("pooling,num_shells", [("mean", 1), ("sum", 3), ("max", 1)])
def test_one_train_step_matches_jax(pooling, num_shells):
    """Config 1 (1 shell, mean pooling, 1 target), sum and max pooling, fp32,
    dropouts 0, the global-norm clip binding."""
    clip, lr = 1e-3, 1e-3
    kw = dict(hidden_dim=48, embedding_dim=8, num_message_passing_layers=3, output_dim=1,
              num_shells=num_shells, ffn_num_layers=3, pooling_type=pooling,
              shell_conv_dropout=0.0, ffn_dropout=0.0)
    jb, pb = _batches(num_shells, seed=1)
    flat = init_params(GNNConfig(**kw), seed=6)
    jcfg = jax_trainer.TrainConfig(learning_rate=lr, loss_function="l1", grad_clip=clip)
    jmodel = JaxGNN(JaxConfig(**kw))
    params = _tree(flat)
    loss_ref, grads_ref = jax.value_and_grad(jax_trainer.make_loss_fn(jmodel, jcfg))(params, jb)
    opt = jax_trainer.make_optimizer(jcfg)
    step = jax_trainer.make_train_step(jmodel, jcfg, opt)
    new_ref, _, step_loss, _ = step(params, opt.init(params), jb, jnp.float32(lr),
                                    jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(step_loss), float(loss_ref), rtol=1e-6)

    cfg = GNNConfig(**kw)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    batch = pb.to("cpu")
    if pooling == "max":
        assert _ties(model, batch) > 0  # the tie case is exercised
    opt_t = trainer.make_optimizer(model, trainer.TrainConfig(grad_clip=clip))
    out = model(batch, train=True)
    loss = trainer.make_loss_fn(trainer.TrainConfig())(out.predictions, batch.targets,
                                                      batch.graph_mask)
    loss.backward()
    print(f"{pooling}: loss port {float(loss):.7f} jax {float(loss_ref):.7f}")
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=5e-4, atol=5e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    got_g, ref_g = params_to_flax(grads, cfg), _flat(grads_ref)
    assert set(got_g) == set(ref_g)
    worst = max(float(np.abs(got_g[k] - ref_g[k]).max()) for k in ref_g)
    print(f"{pooling}: grads worst max|d| {worst:.2e}")
    for k in ref_g:
        np.testing.assert_allclose(got_g[k], ref_g[k], rtol=5e-4, atol=5e-5, err_msg=k)
    # the x_self projection's gradient reaches the model only through the pool
    assert np.abs(got_g["params/embedding_projection/kernel"][:, : cfg.x_self_dim]).max() > 0
    norm = opt_t.step(lr)
    gnorm_ref = float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in ref_g.values())))
    np.testing.assert_allclose(float(norm), gnorm_ref, rtol=5e-4)
    assert gnorm_ref > clip  # the clip binds
    got_p, ref_p = params_to_flax(model.state_dict(), cfg), _flat(new_ref)
    for k in ref_p:
        np.testing.assert_allclose(got_p[k], ref_p[k], rtol=5e-4, atol=5e-5, err_msg=k)
