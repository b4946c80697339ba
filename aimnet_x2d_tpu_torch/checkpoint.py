"""Model artifacts and the weight bridge to the JAX package
(counterpart of aimnet_x2d_tpu/checkpoint.py).

An artifact is one ``.npz`` file: the flattened flax parameters under
``param/<path>`` keys (``params/embedding_projection/kernel`` ...) and a
JSON blob under ``__artifact_meta__`` holding the model config, the
preprocessing statistics and extras.  Both packages read and write the same
files.  :func:`params_from_flax` turns the flat flax parameters into the
port's state dict and :func:`params_to_flax` turns it back, bit for bit;
:func:`init_params` makes a fresh flat parameter dict, with numpy only,
with exactly the names and shapes of the JAX ``GNN.init``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from .data.preprocessing import PreprocessingPipeline
from .models.gnn import GNNConfig, _unsupported

_META_KEY = "__artifact_meta__"
_PARAM_PREFIX = "param/"


@dataclasses.dataclass
class Artifact:
    params: Dict[str, np.ndarray]  # flat flax names, e.g. "params/ffn/block_0/linear1/kernel"
    model_config: GNNConfig
    pipeline: Optional[PreprocessingPipeline]
    extra: Dict[str, Any]


def save_artifact(
    path: str,
    params: Dict[str, np.ndarray],
    model_config: GNNConfig,
    pipeline: Optional[PreprocessingPipeline] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write flat flax-named ``params`` and the metadata to ``path``
    (``.npz`` is appended when missing)."""
    meta = {
        "format_version": 1,
        "model_config": model_config.to_dict(),
        "preprocessing": pipeline.state_dict() if pipeline is not None else None,
        "extra": extra or {},
    }
    payload = {_PARAM_PREFIX + k: np.asarray(v) for k, v in params.items()}
    payload[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **payload)


def _resolve(path: str) -> str:
    if os.path.exists(path):
        return path
    if os.path.exists(path + ".npz"):
        return path + ".npz"
    raise FileNotFoundError(path)


def load_artifact(path: str) -> Artifact:
    with np.load(_resolve(path)) as data:
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode("utf-8"))
        flat = {
            k[len(_PARAM_PREFIX):]: data[k] for k in data.files if k.startswith(_PARAM_PREFIX)
        }
    cfg = GNNConfig.from_dict(meta["model_config"])
    pipeline = (
        PreprocessingPipeline.from_state_dict(meta["preprocessing"])
        if meta.get("preprocessing")
        else None
    )
    return Artifact(params=flat, model_config=cfg, pipeline=pipeline, extra=meta.get("extra", {}))


# flax module names -> the port's module paths
_RENAMES = (
    (re.compile(r"^message_passing_layers_(\d+)$"), r"message_passing_layers.\1"),
    (re.compile(r"^attention_weights_(\d+)$"), r"attention_weights.\1"),
    (re.compile(r"^block_(\d+)$"), r"blocks.\1"),
)
_MLP = re.compile(r"^mlp_(\d+)_linear_(\d+)$")


def torch_name(flax_key: str) -> "tuple[str, bool]":
    """(port state-dict name, whether the array is transposed) of a flat
    flax parameter name."""
    parts = flax_key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    *mods, leaf = parts
    out = []
    for m in mods:
        mm = _MLP.match(m)
        if mm:
            out.append(f"mlp.{mm.group(1)}.{int(mm.group(2)) - 1}")
            continue
        for pat, rep in _RENAMES:
            if pat.match(m):
                m = pat.sub(rep, m)
                break
        out.append(m)
    transpose = False
    if leaf == "kernel":
        out.append("weight")
        transpose = True
    elif leaf.endswith("_kernel"):  # input_proj_kernel, global_skip_proj_kernel
        out += [leaf[: -len("_kernel")], "weight"]
        transpose = True
    elif leaf.endswith("_bias"):
        out += [leaf[: -len("_bias")], "bias"]
    elif leaf.endswith("_embedding") and not mods:  # raw embedding tables
        out += [leaf, "weight"]
    else:  # bias, temperature
        out.append(leaf)
    return ".".join(out), transpose


def params_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax parameters (numpy) -> the port's state dict (fp32 torch
    tensors; kernels transposed to torch's (out, in))."""
    sd = {}
    for key, value in flat.items():
        name, transpose = torch_name(key)
        arr = np.asarray(value, np.float32)
        # np.array keeps 0-d arrays 0-d (ascontiguousarray would make them 1-d)
        sd[name] = torch.from_numpy(np.array(arr.T if transpose else arr, order="C"))
    return sd


def params_to_flax(state_dict: Dict[str, torch.Tensor], cfg: GNNConfig) -> Dict[str, np.ndarray]:
    """The port's state dict -> flat flax parameters (float32 numpy, kernels
    back in flax's (in, out) orientation), under the names of the JAX
    ``GNN.init`` for ``cfg``: the inverse of :func:`params_from_flax`."""
    out = {}
    for key in init_params(cfg, 0):
        name, transpose = torch_name(key)
        arr = state_dict[name].detach().cpu().float().numpy()
        out[key] = np.array(arr.T if transpose else arr, order="C")
    return out


def init_params(cfg: GNNConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Fresh parameters, made with numpy from ``seed``, under the flat flax
    names and shapes of the JAX ``GNN.init`` (dead parameters included).
    Initializers follow the JAX package: Xavier-uniform with zero bias for
    the top-level layers and the attention heads, torch's default
    U(+-1/sqrt(fan_in)) for shell-convolution and FFN layers."""
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"{why} is not ported yet")
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def uni(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def xavier(name, n_in, n_out):
        p[f"params/{name}/kernel"] = uni((n_in, n_out), math.sqrt(6.0 / (n_in + n_out)))
        p[f"params/{name}/bias"] = np.zeros(n_out, np.float32)

    def torch_linear(name, n_in, n_out):
        bound = 1.0 / math.sqrt(n_in)
        p[f"params/{name}/kernel"] = uni((n_in, n_out), bound)
        p[f"params/{name}/bias"] = uni((n_out,), bound)

    fs = dict(cfg.feature_sizes)
    E, H, F = cfg.embedding_dim, cfg.hidden_dim, cfg.ffn_dim
    for name in ("atom_type", "hydrogen_count", "degree", "hybridization"):
        p[f"params/{name}_embedding"] = uni((fs[name], E), math.sqrt(6.0 / (fs[name] + E)))
    xavier("embedding_projection", 4 * E, H)
    if cfg.parity_params:
        xavier("long_range_projection", H, F)
    D = cfg.x_other_dim
    if cfg.use_stereochemistry:
        if cfg.parity_params:
            xavier("stereochemical_embedding", 3 * H, H)
        xavier("stereochemical_embedding_2", 3 * D, D)
    in_dim = D * (cfg.num_shells + 1)
    for l in range(cfg.num_message_passing_layers):
        pre = f"params/message_passing_layers_{l}"
        bound = 1.0 / math.sqrt(in_dim)
        p[f"{pre}/input_proj_kernel"] = uni((in_dim, D), bound)
        p[f"{pre}/input_proj_bias"] = uni((D,), bound)
        p[f"{pre}/global_skip_proj_kernel"] = uni((in_dim, D), bound)
        p[f"{pre}/global_skip_proj_bias"] = uni((D,), bound)
        for i in range(cfg.shell_conv_num_mlp_layers):
            torch_linear(f"message_passing_layers_{l}/mlp_{i}_linear_1", D, D)
            torch_linear(f"message_passing_layers_{l}/mlp_{i}_linear_2", D, D)
    xavier("concat_self_other", H, H)
    if cfg.pooling_type == "attention":
        p["params/pooling/temperature"] = np.asarray(cfg.attention_temperature, np.float32)
        for i in range(cfg.attention_num_heads):
            xavier(f"pooling/attention_weights_{i}", H, 1)
    xavier("post_pooling_projection", H, F)
    n = cfg.ffn_num_layers
    for i in range(n):
        torch_linear(f"ffn/block_{i}/linear1", F, F)
        torch_linear(f"ffn/block_{i}/linear2", F, F)
    xavier("skip_transform", F, F)
    xavier("output_layer", 2 * F, cfg.final_output_dim)
    return p
