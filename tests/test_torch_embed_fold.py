"""The embedding fold (``AIMNET_EMBED_FOLD=1``, kernel 1c-vocab) of the port
against the JAX package's, on the CPU.

- ops/embed.py: the one-hot rows and the block-diagonal table against JAX's;
- each site at op level, fp32 and bf16: the stack's training forward and
  backward with the code rows and the table (``binned_mp_stack_train_t(...,
  embed_spec=)``) and the fused attention pool (``binned_attnpool_proj_t(...,
  embed_spec=)``) against the JAX ops with ``embed_spec`` (Pallas in
  interpret mode): outputs, the four tables' gradients through d_bd, and
  every other gradient; codes outside a vocabulary included;
- one train step per route with the switch on in both packages (stack with
  attention, config 3, config 1, one featureless layer, no layers): the
  loss, every gradient and every updated parameter, and which sites folded;
- the port with the switch on and off: the training forward bit-equal, the
  tables' gradients within the bf16 bar;
- serving, the row-major route and flat batches unchanged by the switch;
- the CLI trains with the switch on and writes an artifact the JAX package
  loads.

Tolerances: fp32 rtol 5e-4 / atol 5e-5 (fp32 sums in another order); bf16
max|d|/max|ref| < 5e-2 (an fp32 sum rounding to the other bf16 neighbour
moves an intermediate by 2**-8 and propagates).  Where a reference
gradient is exactly 0, Adam's first step turns either side's rounding
residue into a move of up to lr, so those parameters are held to lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.chem import compute_features as jax_features
from aimnet_x2d_tpu.data.batching import collate as jax_collate
from aimnet_x2d_tpu.data.binning import bin_pack_batch as jax_bin_pack
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu.ops import embed as jax_embed
from aimnet_x2d_tpu.ops.bin_attnpool import binned_attnpool_proj_t as jax_attnpool
from aimnet_x2d_tpu.ops.bin_mp import binned_mp_stack_t as jax_stack
from aimnet_x2d_tpu.training import trainer as jax_trainer
from aimnet_x2d_tpu_torch import cli
from aimnet_x2d_tpu_torch.checkpoint import init_params, load_artifact, params_from_flax, params_to_flax
from aimnet_x2d_tpu_torch.chem import compute_features
from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts, collate
from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig
from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp, embed
from aimnet_x2d_tpu_torch.training import trainer

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VOCAB = (11, 5, 7, 3)  # op-level vocabularies; 4 rows per table, E = 16
SMILES = ["CCO", "c1ccccc1O", "CC(=O)N", "C1CCC(CC1)OC#N", "CC(C)(F)F", "N#CC=CC",
          "OCC(O)CO", "C[C@H](N)C(=O)O", "F/C=C/F", "c1ccncc1C", "CCCCCCCC", "O=C=O"]


@pytest.fixture(autouse=True)
def _fold_on(monkeypatch):
    monkeypatch.setenv("AIMNET_MP_MEGAKERNEL", "interpret")
    monkeypatch.setenv("AIMNET_MP_PROJ", "1")
    monkeypatch.setenv("AIMNET_ATTNPOOL_KERNEL", "interpret")
    monkeypatch.setenv("AIMNET_WPOOL_KERNEL", "interpret")
    monkeypatch.setenv("AIMNET_EMBED_FOLD", "1")
    # one bin per interpreted grid step: the same per-bin arithmetic, a
    # kernel body that traces and compiles several times faster
    for var in ("AIMNET_MP_GROUP_FWD", "AIMNET_MP_GROUP_BWD", "AIMNET_ATTNPOOL_GROUP"):
        monkeypatch.setenv(var, "1")


@pytest.fixture
def folds(monkeypatch):
    """Counts of the port's lookups from codes, by site (the plain versions
    call ``embed_from_codes`` once per direction)."""
    calls = {"stack": 0, "pool": 0}
    for site, mod in (("stack", bin_mp), ("pool", bin_attnpool)):
        def spy(*a, _site=site, **k):
            calls[_site] += 1
            return embed.embed_from_codes(*a, **k)
        monkeypatch.setattr(mod, "embed_from_codes", spy)
    return calls


def _check(got, ref, dtype, what="", scale=None):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max() if scale is None else scale, 1e-30)
    print(f"{what} {dtype}: max|d| {err:.2e}, max|d|/max|ref| {err / scale:.2e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=what)
    else:
        assert err / scale < 5e-2, what


def _codes(rng, A, vocab=VOCAB):
    """(F, A) int32 codes, with a few outside each vocabulary (-1 and V)."""
    codes = np.stack([rng.integers(0, v, A) for v in vocab]).astype(np.int32)
    for f, v in enumerate(vocab):
        codes[f, rng.integers(0, A, 3)] = -1
        codes[f, rng.integers(0, A, 3)] = v
    return codes


def _tables(rng, vocab=VOCAB, d=4):
    return [rng.normal(size=(v, d)).astype(np.float32) for v in vocab]


def test_onehot_rows_and_blockdiag_match_jax():
    rng = np.random.default_rng(0)
    codes, tables = _codes(rng, 40), _tables(rng)
    ref = jax_embed.onehot_rows(jnp.asarray(codes), VOCAB, jnp.float32)
    np.testing.assert_array_equal(embed.onehot_rows(torch.from_numpy(codes), VOCAB,
                                                    torch.float32).numpy(), np.asarray(ref))
    ref_bd = jax_embed.blockdiag_table_t([jnp.asarray(t) for t in tables])
    got_bd = embed.blockdiag_table_t([torch.from_numpy(t) for t in tables])
    np.testing.assert_array_equal(got_bd.numpy(), np.asarray(ref_bd))
    # the lookup is the gather of each feature's row; out-of-range codes give 0
    vt = embed.prep_vocab(got_bd, VOCAB, torch.float32)
    emb = embed.embed_from_codes(torch.from_numpy(codes), vt).numpy()
    for f, (t, v) in enumerate(zip(tables, VOCAB)):
        c = codes[f]
        want = np.where(((c >= 0) & (c < v))[:, None], t[np.clip(c, 0, v - 1)], 0.0)
        np.testing.assert_array_equal(emb[4 * f : 4 * f + 4].T, want)


def _adjacency(rng, nb, ab):
    adj = np.zeros((nb, ab, ab), np.int8)
    for b in range(nb):
        n = rng.integers(ab // 2, ab + 1)
        for _ in range(4 * n):
            i, j = rng.integers(0, n, 2)
            if i != j:
                adj[b, i, j] += 1
    return adj


def _stack_inputs(seed, D=19, nb=2, ab=32, n_layers=2, n_blocks=2):
    rng = np.random.default_rng(seed)
    E = 4 * len(VOCAB)
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
    kb = rng.uniform(-0.4, 0.4, (E, D)).astype(np.float32)
    bb = rng.uniform(-0.2, 0.2, D).astype(np.float32)
    g = rng.normal(size=(D, nb * ab)).astype(np.float32)
    return _codes(rng, nb * ab), _tables(rng), adj, layers, kb, bb, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_fold_matches_jax(dtype):
    act, seed, n_blocks, rate = "silu", -987654, 2, 0.1
    codes, tables, adj, layers, kb, bb, g = _stack_inputs(seed=4)

    def f(tabs, kb_, bb_, layers_):
        return jax_stack(
            None, jnp.asarray(adj), layers_, act=act, num_mlp_layers=n_blocks,
            compute_dtype=JDT[dtype], interpret=True, dropout=rate,
            drop_seed=jnp.asarray([seed], jnp.int32), proj_weights=(kb_, bb_),
            embed_spec=(jnp.asarray(codes), jax_embed.blockdiag_table_t(tabs), VOCAB))

    jl = tuple(tuple(jnp.asarray(w) for w in lw) for lw in layers)
    # XLA:CPU has no bf16 x bf16 = f32 dot under jit: the bf16 case runs eagerly
    out_ref, vjp = jax.vjp(jax.jit(f) if dtype == "float32" else f,
                           [jnp.asarray(t) for t in tables], jnp.asarray(kb), jnp.asarray(bb), jl)
    dtab_ref, dkb_ref, dbb_ref, dl_ref = vjp(jnp.asarray(g).astype(out_ref.dtype))

    tt = [torch.from_numpy(t).requires_grad_(True) for t in tables]
    tkb = torch.from_numpy(kb).requires_grad_(True)
    tbb = torch.from_numpy(bb).requires_grad_(True)
    tl = [[torch.from_numpy(w).requires_grad_(True) for w in lw] for lw in layers]
    spec = (torch.from_numpy(codes), embed.blockdiag_table_t(tt), VOCAB)
    out = bin_mp.binned_mp_stack_train_t(None, torch.from_numpy(adj), tl, TDT[dtype], act=act,
                                         dropout=rate, seed=seed, proj_weights=(tkb, tbb),
                                         embed_spec=spec)
    _check(out.detach().float(), out_ref.astype(jnp.float32), dtype, "out")
    out.backward(torch.from_numpy(g).to(out.dtype))
    for f_, (t, r) in enumerate(zip(tt, dtab_ref)):
        _check(t.grad, r, dtype, f"table {f_}")
    _check(tkb.grad, dkb_ref, dtype, "d_kb")
    _check(tbb.grad, dbb_ref, dtype, "d_bb")
    for l, (lw, lref) in enumerate(zip(tl, dl_ref)):
        for k, (w, r) in enumerate(zip(lw, lref)):
            _check(w.grad, r, dtype, f"layer {l} weight {k}")


def _pool_inputs(seed, Ds=21, Do=13, H=4, nb=3, mb=8, ab=32):
    rng = np.random.default_rng(seed)
    E = 4 * len(VOCAB)
    xo = rng.normal(size=(Do, nb * ab)).astype(np.float32)
    owner = rng.integers(-1, mb - 1, (nb, ab))  # some atoms and one slot empty
    pm = (owner[:, None, :] == np.arange(mb)[None, :, None]).astype(np.int8)
    kb = rng.uniform(-0.4, 0.4, (E, Ds)).astype(np.float32)
    bb = rng.uniform(-0.2, 0.2, Ds).astype(np.float32)
    ks = rng.uniform(-0.5, 0.5, (Ds, H)).astype(np.float32)
    ko = rng.uniform(-0.5, 0.5, (Do, H)).astype(np.float32)
    sb = rng.uniform(-0.2, 0.2, H).astype(np.float32)
    gs = [rng.normal(size=(Ds, nb * mb)), rng.normal(size=(Do, nb * mb)),
          rng.normal(size=(nb * mb,))]
    return (_codes(rng, nb * ab), _tables(rng), xo, pm, kb, bb, ks, ko, sb,
            [x.astype(np.float32) for x in gs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attnpool_fold_matches_jax(dtype):
    codes, tables, xo, pm, kb, bb, ks, ko, sb, gs = _pool_inputs(seed=5)
    jdt, act = JDT[dtype], "silu"

    def f(tabs, x, kb_, bb_, ks_, ko_, sb_):
        ps, po, cov, _ = jax_attnpool(
            None, kb_, bb_, act, x.astype(jdt), jnp.asarray(pm), ks_, ko_, sb_, interpret=True,
            embed_spec=(jnp.asarray(codes), jax_embed.blockdiag_table_t(tabs), VOCAB))
        return ps, po, cov

    args = [[jnp.asarray(t) for t in tables]] + [jnp.asarray(a) for a in (xo, kb, bb, ks, ko, sb)]
    ref, vjp = jax.vjp(jax.jit(f), *args)
    grads_ref = vjp(tuple(jnp.asarray(x) for x in gs))

    tt = [torch.from_numpy(t).requires_grad_(True) for t in tables]
    t = [torch.from_numpy(a).requires_grad_(True) for a in (xo, kb, bb, ks, ko, sb)]
    txo = t[0].to(TDT[dtype])
    txo.retain_grad()
    spec = (torch.from_numpy(codes), embed.blockdiag_table_t(tt), VOCAB)
    ps, po, cov, attn = bin_attnpool.binned_attnpool_proj_t(
        None, t[1], t[2], act, txo, torch.from_numpy(pm), t[3], t[4], t[5], embed_spec=spec)
    for got, r, name in zip((ps, po, cov), ref, ("pooled_self", "pooled_other", "coverage")):
        _check(got.detach(), r, dtype, name)
    assert not attn.requires_grad
    torch.autograd.backward([ps, po, cov], [torch.from_numpy(x) for x in gs])
    for f_, (a, r) in enumerate(zip(tt, grads_ref[0])):
        _check(a.grad, r, dtype, f"table {f_}")
    _check(txo.grad.float(), jnp.asarray(grads_ref[1], jnp.float32), dtype, "dx_other")
    names = ("d_kb", "d_bb", "d_ks", "d_ko", "d_sb")
    for a, r, name in zip(t[1:], grads_ref[2:], names):
        # the exact d_sb is 0 (a per-head shift of every score leaves each
        # molecule's softmax unchanged): both sides hold rounding residue,
        # held to the scale of d_ks
        scale = np.abs(np.asarray(grads_ref[4])).max() if name == "d_sb" else None
        _check(a.grad, r, dtype, name, scale)


# ---- models ---------------------------------------------------------------- #


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


@pytest.fixture(scope="module")
def batches():
    t = np.random.default_rng(0).normal(size=(len(SMILES), 2)).astype(np.float32)
    jb = jax_bin_pack(jax_collate([jax_features(s, 3) for s in SMILES], t, num_hops=3),
                      ab=32, mb=8)
    feats = [compute_features(s, 3) for s in SMILES]
    pb = bin_pack_batch(collate(feats, t, num_hops=3), ab=32, mb=8)
    flat = attach_flat_layouts(collate(feats, t, num_hops=3))
    return jb, pb.to("cpu"), flat.to("cpu"), t


BASE = dict(hidden_dim=32, embedding_dim=8, num_message_passing_layers=2, output_dim=2,
            num_shells=3, ffn_num_layers=2, task_type="multitask", shell_conv_dropout=0.0,
            ffn_dropout=0.0)
# route, and which of the port's sites fold (JAX: the stack under its
# projection fold, the attention pool on the feature-major path)
ROUTES = {
    "stack_attention": (dict(), ("stack", "pool")),
    "config3": (dict(use_partial_charges=True, use_stereochemistry=True), ("pool",)),
    "config1_mean": (dict(num_shells=1, pooling_type="mean", output_dim=1), ("stack",)),
    "one_layer": (dict(num_message_passing_layers=1), ()),
    "no_layers": (dict(num_message_passing_layers=0), ()),
}


def _check_update(got_p, ref_p, ref_g, lr):
    for k, v in ref_p.items():
        zero = np.abs(ref_g[k]) <= 1e-7
        np.testing.assert_allclose(got_p[k][~zero], v[~zero], rtol=5e-4, atol=5e-5, err_msg=k)
        assert np.all(np.abs(got_p[k][zero] - v[zero]) <= lr + 5e-5), k


@pytest.mark.parametrize("route", list(ROUTES))
def test_train_step_with_fold_matches_jax(batches, folds, route):
    jb, pb, _, t = batches
    extra, sites = ROUTES[route]
    kw = {**BASE, **extra}
    if kw["num_shells"] == 1:
        t = t[:, :1]
        jb = jax_bin_pack(jax_collate([jax_features(s, 1) for s in SMILES], t, num_hops=1),
                          ab=32, mb=8)
        pb = bin_pack_batch(collate([compute_features(s, 1) for s in SMILES], t, num_hops=1),
                            ab=32, mb=8).to("cpu")
    task = "multitask" if kw["output_dim"] > 1 else "regression"
    kw["task_type"] = task
    lr, clip = 1e-3, 1.0
    flat = init_params(GNNConfig(**kw), seed=6)
    jcfg = jax_trainer.TrainConfig(learning_rate=lr, loss_function="l1", grad_clip=clip,
                                   task_type=task)
    jmodel = JaxGNN(JaxConfig(**kw))
    params = _tree(flat)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(jax_trainer.make_loss_fn(jmodel, jcfg)))(
        params, jb)
    # the step's update (trainer.make_train_step's apply_update): clip + Adam, times lr
    opt = jax_trainer.make_optimizer(jcfg)

    @jax.jit
    def update(g, p):
        u, _ = opt.update(g, opt.init(p), p)
        return optax.apply_updates(p, jax.tree_util.tree_map(lambda x: x * lr, u))

    new_ref = update(grads_ref, params)

    cfg = GNNConfig(**kw)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    tcfg = trainer.TrainConfig(grad_clip=clip, task_type=task)
    opt_t = trainer.make_optimizer(model, tcfg)
    loss = trainer.make_loss_fn(tcfg)(model(pb, train=True).predictions, pb.targets, pb.graph_mask)
    loss.backward()
    assert {s for s in ("stack", "pool") if folds[s]} == set(sites), (route, folds)
    assert all(folds[s] == 2 for s in sites), folds  # forward and backward
    loss = float(loss.detach())
    print(f"{route} step: loss port {loss:.7f} jax {float(loss_ref):.7f}")
    np.testing.assert_allclose(loss, float(loss_ref), rtol=5e-4, atol=5e-5)
    got_g = params_to_flax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                            for k, p in model.named_parameters()}, cfg)
    ref_g = _flat(grads_ref)
    assert set(got_g) == set(ref_g)
    print(f"{route} step: grads worst max|d| "
          f"{max(np.abs(got_g[k] - ref_g[k]).max() for k in ref_g):.2e}")
    for k in ref_g:
        np.testing.assert_allclose(got_g[k], ref_g[k], rtol=5e-4, atol=5e-5, err_msg=k)
    opt_t.step(lr)
    _check_update(params_to_flax(model.state_dict(), cfg), _flat(new_ref), ref_g, lr)


def _train_forward(model, batch, fold, monkeypatch):
    """Predictions and every gradient of one training forward and backward."""
    if fold:
        monkeypatch.setenv("AIMNET_EMBED_FOLD", "1")
    else:
        monkeypatch.delenv("AIMNET_EMBED_FOLD")
    model.zero_grad()
    pred = model(batch, train=True, drop_seed=11).predictions
    pred.square().sum().backward()
    return pred.detach(), {k: p.grad.clone() for k, p in model.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_on_and_off_agree(batches, folds, monkeypatch, dtype):
    _, pb, _, _ = batches
    cfg = GNNConfig(**{**BASE, "compute_dtype": dtype, "shell_conv_dropout": 0.1})
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed=3)))
    p_on, g_on = _train_forward(model, pb, True, monkeypatch)
    assert folds["stack"] == 2 and folds["pool"] == 2
    p_off, g_off = _train_forward(model, pb, False, monkeypatch)
    assert folds["stack"] == 2 and folds["pool"] == 2  # no lookup from codes
    assert torch.equal(p_on, p_off)
    assert set(g_on) == set(g_off)
    # the tables' gradients: two fp32 d_bd sums against the gather's bf16
    # demb cotangents summed by F.embedding's backward
    for k in g_on:
        _check(g_on[k].float().numpy(), g_off[k].float().numpy(), "bfloat16", k)


@pytest.mark.parametrize("case", ["serving", "rows", "flat"])
def test_fold_leaves_serving_rows_and_flat_unchanged(batches, folds, monkeypatch, case):
    _, pb, flat, _ = batches
    kw = {**BASE, "parity_mode": case != "rows"}
    cfg = GNNConfig(**kw)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed=8)))
    batch = flat if case == "flat" else pb
    if case == "serving":
        outs = []
        for fold in (True, False):
            if fold:
                monkeypatch.setenv("AIMNET_EMBED_FOLD", "1")
            else:
                monkeypatch.delenv("AIMNET_EMBED_FOLD")
            with torch.inference_mode():
                outs.append(model.eval()(batch).predictions)
        assert torch.equal(*outs)
    else:
        p_on, g_on = _train_forward(model, batch, True, monkeypatch)
        p_off, g_off = _train_forward(model, batch, False, monkeypatch)
        assert torch.equal(p_on, p_off)
        assert set(g_on) == set(g_off) and all(torch.equal(g_on[k], g_off[k]) for k in g_on)
    assert folds == {"stack": 0, "pool": 0}


def test_cli_trains_with_fold_and_jax_loads_the_artifact(tmp_path, folds):
    rng = np.random.default_rng(0)
    smiles = (SMILES + ["CC(C)O", "CCN(CC)CC", "c1ccoc1", "CC#N"]) * 2
    n_atoms = np.array([compute_features(s, 3).num_atoms for s in smiles], np.float32)
    df = pd.DataFrame({"smiles": smiles, "a": n_atoms * 0.5 + rng.normal(size=len(smiles)) * 0.1,
                       "b": -n_atoms + rng.normal(size=len(smiles)) * 0.1})
    csv = str(tmp_path / "train.csv")
    df.to_csv(csv, index=False)
    path = str(tmp_path / "model.npz")
    summary = cli.main([
        "--data_path", csv, "--multi_target_columns", "a,b", "--task_type", "multitask",
        "--epochs", "2", "--batch_size", "16", "--hidden_dim", "32", "--embedding_dim", "8",
        "--num_message_passing_layers", "2", "--ffn_num_layers", "2", "--learning_rate", "3e-3",
        "--model_save_path", path, "--device", "cpu", "--seed", "3"])
    hist = summary["history"]
    assert len(hist) == 2 and np.isfinite([h["train_loss"] for h in hist]).all()
    assert folds["stack"] > 0 and folds["pool"] > 0
    art = jax_load_artifact(path)
    assert art.model_config.hidden_dim == 32 and art.extra["target_columns"] == ["a", "b"]
    ours, theirs = load_artifact(path).params, _flat(art.params)
    assert set(ours) == set(theirs) and "params/atom_type_embedding" in ours
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
