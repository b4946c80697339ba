"""Weight bridge of the PyTorch port: ``init_params`` gives exactly the
names, order and shapes of the JAX ``GNN.init`` tree, ``params_from_flax``
reproduces every tensor in the port's state dict, and both packages read
each other's artifacts."""

import jax
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.checkpoint import _flatten
from aimnet_x2d_tpu.checkpoint import load_artifact as jax_load_artifact
from aimnet_x2d_tpu.data.synthetic import make_synthetic_batch
from aimnet_x2d_tpu.models import GNN as JaxGNN
from aimnet_x2d_tpu.models import GNNConfig as JaxConfig
from aimnet_x2d_tpu_torch.checkpoint import (
    init_params,
    load_artifact,
    params_from_flax,
    save_artifact,
    torch_name,
)
from aimnet_x2d_tpu_torch.models.gnn import GNN, GNNConfig

torch.set_num_threads(1)

SMALL = [
    dict(hidden_dim=32, embedding_dim=8, num_message_passing_layers=2, output_dim=3),
    dict(hidden_dim=40, embedding_dim=4, num_message_passing_layers=3, output_dim=2,
         pooling_type="mean", ffn_num_layers=1, parity_params=False),
    dict(hidden_dim=24, embedding_dim=8, num_message_passing_layers=2, output_dim=1,
         pooling_type="sum", shell_conv_num_mlp_layers=1, num_shells=2, ffn_hidden_dim=16,
         loss_function="evidential", attention_num_heads=2),
]
FLAGSHIP = dict(hidden_dim=512, output_dim=12, num_shells=3, num_message_passing_layers=3,
                embedding_dim=64, ffn_num_layers=3, pooling_type="attention",
                task_type="multitask", compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def jax_batch():
    return make_synthetic_batch(num_graphs=3, mean_atoms=8, num_hops=3, num_tasks=1, seed=0)


def _jax_shapes(kw, batch, abstract=False):
    """(name, shape) of the JAX tree; the concrete init keeps creation
    order, the abstract one (jax.eval_shape, for the flagship) sorts keys."""
    model = JaxGNN(JaxConfig(**kw))
    if abstract:
        tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch)
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return sorted(
            ("/".join(str(k.key) for k in path), tuple(leaf.shape)) for path, leaf in leaves
        )
    flat = _flatten(model.init(jax.random.PRNGKey(0), batch))
    return [(k, tuple(v.shape)) for k, v in flat.items()]


@pytest.mark.parametrize("kw", SMALL + [FLAGSHIP], ids=["attn", "mean", "sum", "flagship"])
def test_init_params_matches_flax_tree(kw, jax_batch):
    flagship = kw is FLAGSHIP
    want = _jax_shapes(kw, jax_batch, abstract=flagship)
    got = [(k, tuple(v.shape)) for k, v in init_params(GNNConfig(**kw), seed=0).items()]
    assert (sorted(got) if flagship else got) == want


@pytest.mark.parametrize("kw", SMALL, ids=["attn", "mean", "sum"])
def test_params_from_flax_reproduces_every_tensor(kw):
    flat = init_params(GNNConfig(**kw), seed=3)
    model = GNN(GNNConfig(**kw))
    model.load_state_dict(params_from_flax(flat), strict=True)
    sd = model.state_dict()
    assert len(sd) == len(flat)
    for key, value in flat.items():
        name, transpose = torch_name(key)
        want = value.T if transpose else value
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=key)


def test_init_params_distributions():
    flat = init_params(GNNConfig(**SMALL[0]), seed=0)
    k = flat["params/embedding_projection/kernel"]
    assert np.abs(k).max() <= np.sqrt(6.0 / sum(k.shape)) + 1e-7
    assert not flat["params/embedding_projection/bias"].any()
    w = flat["params/message_passing_layers_0/input_proj_kernel"]
    assert np.abs(w).max() <= 1.0 / np.sqrt(w.shape[0]) + 1e-7
    assert flat["params/message_passing_layers_0/input_proj_bias"].any()
    assert not np.array_equal(w, init_params(GNNConfig(**SMALL[0]), seed=1)[
        "params/message_passing_layers_0/input_proj_kernel"])


def test_artifacts_shared_with_jax(tmp_path):
    cfg = GNNConfig(**SMALL[0])
    flat = init_params(cfg, seed=5)
    path = str(tmp_path / "m.npz")
    save_artifact(path, flat, cfg, extra={"max_hops": 3})
    art = load_artifact(path)
    assert art.model_config == cfg and art.extra == {"max_hops": 3}
    assert list(art.params) == list(flat)
    jart = jax_load_artifact(path)
    assert jart.model_config.to_dict() == cfg.to_dict()
    jflat = _flatten(jart.params)
    for k, v in flat.items():
        np.testing.assert_array_equal(jflat[k], v)
