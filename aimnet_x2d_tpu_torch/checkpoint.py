"""Model artifacts and the weight bridge to the JAX package
(counterpart of aimnet_x2d_tpu/checkpoint.py).

An artifact is one ``.npz`` file: the flattened flax parameters under
``param/<path>`` keys (``params/embedding_projection/kernel`` ...) and a
JSON blob under ``__artifact_meta__`` holding the model config, the
preprocessing statistics and extras.  Both packages read and write the same
files.  :func:`params_from_flax` turns the flat flax parameters into the
port's state dict and :func:`params_to_flax` turns it back, bit for bit;
:func:`init_params` makes a fresh flat parameter dict, with numpy only,
with exactly the names and shapes of the JAX ``GNN.init``
(:func:`param_specs` lists them without making arrays).
:func:`transfer_params` copies matching weights of a pretrained artifact
(transfer learning), and :class:`TrainCheckpointer` keeps the periodic
training checkpoints that a run resumes from.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, Optional, Tuple

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
    for key in param_specs(cfg):
        name, transpose = torch_name(key)
        arr = state_dict[name].detach().cpu().float().numpy()
        out[key] = np.array(arr.T if transpose else arr, order="C")
    return out


def transfer_params(pretrained: Dict[str, np.ndarray], target: Dict[str, np.ndarray],
                    verbose: bool = True) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Copy the leaves of ``pretrained`` whose flat flax name and shape match
    a leaf of ``target`` (torch's ``load_state_dict(strict=False)``, as the
    JAX ``transfer_params``); returns (params, copied, kept fresh).  As in
    the JAX package (quirk Q4), the transferred weights are the ones
    training starts from."""
    out = dict(target)
    copied = 0
    for k, v in target.items():
        if k in pretrained and np.shape(pretrained[k]) == np.shape(v):
            out[k] = np.asarray(pretrained[k])
            copied += 1
    skipped = len(target) - copied
    if verbose:
        print(f"[transfer] copied {copied} tensors, kept {skipped} fresh")
    return out, copied, skipped


class TrainCheckpointer:
    """Periodic training checkpoints in ``directory`` with resume (the JAX
    package keeps them with orbax; these are the port's own files): the
    parameters, the optimizer state, host-side state (LR, scheduler,
    early-stop counters) and the best-so-far parameters of one epoch, in
    ``epoch_<N>.pt`` written with ``torch.save`` and read back with
    ``torch.load(weights_only=True)``.  The newest ``keep`` are kept."""

    _NAME = re.compile(r"^epoch_(\d+)\.pt$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _epochs(self):
        found = (self._NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def save(self, epoch: int, params: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
             aux: Optional[Dict[str, float]] = None,
             best_params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Tensors are copied to the CPU; the file is written whole, then
        renamed into place."""
        def cpu(sd):
            return None if sd is None else {k: v.detach().cpu() for k, v in sd.items()}

        state = {"epoch": epoch, "params": cpu(params),
                 "opt_state": {k: [t.detach().cpu() for t in v] if isinstance(v, list) else v
                               for k, v in opt_state.items()},
                 "aux": dict(aux or {}), "best_params": cpu(best_params)}
        tmp = self._path(epoch) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(epoch))
        for old in self._epochs()[: -self.keep]:
            os.remove(self._path(old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def restore(self):
        """(epoch, params, opt_state, aux, best_params or None) of the newest
        checkpoint, tensors on the CPU; None when there is none."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        s = torch.load(self._path(epoch), map_location="cpu", weights_only=True)
        return s["epoch"], s["params"], s["opt_state"], s["aux"], s["best_params"]


def param_specs(cfg: GNNConfig) -> Dict[str, Tuple[str, Tuple[int, ...], float]]:
    """Flat flax name -> (init, shape, arg) of every parameter of the JAX
    ``GNN.init`` for ``cfg`` (dead parameters included), in its order, with
    no arrays made: init ``"uniform"`` draws U(+-arg), ``"zeros"`` is zero
    and ``"const"`` is ``arg``.  Initializers follow the JAX package:
    Xavier-uniform with zero bias for the top-level layers and the attention
    heads, torch's default U(+-1/sqrt(fan_in)) for shell-convolution and FFN
    layers."""
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"{why} is not ported yet")
    p: Dict[str, Tuple[str, Tuple[int, ...], float]] = {}

    def xavier(name, n_in, n_out):
        p[f"params/{name}/kernel"] = ("uniform", (n_in, n_out), math.sqrt(6.0 / (n_in + n_out)))
        p[f"params/{name}/bias"] = ("zeros", (n_out,), 0.0)

    def torch_linear(name, n_in, n_out):
        bound = 1.0 / math.sqrt(n_in)
        p[f"params/{name}/kernel"] = ("uniform", (n_in, n_out), bound)
        p[f"params/{name}/bias"] = ("uniform", (n_out,), bound)

    fs = dict(cfg.feature_sizes)
    E, H, F = cfg.embedding_dim, cfg.hidden_dim, cfg.ffn_dim
    for name in ("atom_type", "hydrogen_count", "degree", "hybridization"):
        p[f"params/{name}_embedding"] = ("uniform", (fs[name], E), math.sqrt(6.0 / (fs[name] + E)))
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
        p[f"{pre}/input_proj_kernel"] = ("uniform", (in_dim, D), bound)
        p[f"{pre}/input_proj_bias"] = ("uniform", (D,), bound)
        p[f"{pre}/global_skip_proj_kernel"] = ("uniform", (in_dim, D), bound)
        p[f"{pre}/global_skip_proj_bias"] = ("uniform", (D,), bound)
        for i in range(cfg.shell_conv_num_mlp_layers):
            torch_linear(f"message_passing_layers_{l}/mlp_{i}_linear_1", D, D)
            torch_linear(f"message_passing_layers_{l}/mlp_{i}_linear_2", D, D)
    xavier("concat_self_other", H, H)
    if cfg.pooling_type == "attention":
        p["params/pooling/temperature"] = ("const", (), cfg.attention_temperature)
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


def init_params(cfg: GNNConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Fresh parameters, made with numpy from ``seed``, under the flat flax
    names and shapes of the JAX ``GNN.init`` (:func:`param_specs`); the
    uniform ones are drawn in the names' order."""
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}
    for key, (init, shape, arg) in param_specs(cfg).items():
        if init == "uniform":
            p[key] = rng.uniform(-arg, arg, shape).astype(np.float32)
        elif init == "zeros":
            p[key] = np.zeros(shape, np.float32)
        else:
            p[key] = np.asarray(arg, np.float32)
    return p
