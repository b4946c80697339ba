"""The GNN model, serving forward (counterpart of aimnet_x2d_tpu/models/gnn.py).

Forward on the binned, feature-major fast path (the JAX ``use_stack`` path):

1. four embedding lookups -> concat, feature-major (4*emb, A)
2. embedding_projection -> act, split into x_self and x_other
   (x_other_dim = int(0.3 * hidden), quirk Q2)
3. the fused message-passing stack on x_other (ops/bin_mp.py kernel)
4. pooling of [x_self, x_other] with concat_self_other folded in
   (attention, mean or sum; ops/bin_wpool.py kernel)
5. post_pooling_projection -> FFN -> [h, skip_transform(h)] -> output_layer

Charges, stereochemistry, 1-layer stacks, max pooling, the flat layout,
dropout and training are later slices of the port; the model raises
NotImplementedError for them rather than running anything else.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..data.batching import MolBatch
from ..ops.bin_mp import StackWeights, binned_mp_stack_t, stack_weights
from ..ops.embed import embed_concat_onehot_t
from ..utils.activation import get_activation_function
from .layers import Linear, MultiLayerPerceptron, ShellConvolutionLayer, mm32
from .pooling import (
    POOLING_TYPES,
    MultiHeadAttentionPooling,
    binned_mean_pool_t,
    binned_sum_pool_t,
    pool_then_project,
)

# Feature index-space sizes = |vocabulary| + 1 OOV bucket.
DEFAULT_FEATURE_SIZES: Dict[str, int] = {
    "atom_type": 119,
    "hydrogen_count": 9,
    "degree": 7,
    "hybridization": 7,
}

_EMBEDDINGS = ("atom_type", "hydrogen_count", "degree", "hybridization")


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """Static model configuration; the same fields and serialized form as
    the JAX package's ``GNNConfig``, so artifacts are shared."""

    hidden_dim: int = 512
    output_dim: int = 1
    num_shells: int = 3
    num_message_passing_layers: int = 3
    embedding_dim: int = 64
    ffn_hidden_dim: Optional[int] = None
    ffn_num_layers: int = 3
    ffn_dropout: float = 0.05
    pooling_type: str = "attention"
    task_type: str = "regression"
    use_partial_charges: bool = False
    use_stereochemistry: bool = False
    activation_type: str = "silu"
    shell_conv_num_mlp_layers: int = 2
    shell_conv_dropout: float = 0.05
    attention_num_heads: int = 4
    attention_temperature: float = 1.0
    loss_function: str = "l1"
    parity_mode: bool = True
    parity_params: bool = True
    graph_axis: Optional[str] = None
    compute_dtype: str = "float32"
    remat: bool = False
    feature_sizes: Tuple[Tuple[str, int], ...] = tuple(DEFAULT_FEATURE_SIZES.items())

    @property
    def x_other_dim(self) -> int:
        return int(0.3 * self.hidden_dim)

    @property
    def x_self_dim(self) -> int:
        return self.hidden_dim - self.x_other_dim

    @property
    def ffn_dim(self) -> int:
        return self.ffn_hidden_dim if self.ffn_hidden_dim is not None else self.hidden_dim

    @property
    def final_output_dim(self) -> int:
        return self.output_dim * 4 if self.loss_function == "evidential" else self.output_dim

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["feature_sizes"] = dict(self.feature_sizes)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GNNConfig":
        d = dict(d)
        fs = d.get("feature_sizes", DEFAULT_FEATURE_SIZES)
        if isinstance(fs, dict):
            d["feature_sizes"] = tuple(fs.items())
        known = {f.name for f in dataclasses.fields(GNNConfig)}
        return GNNConfig(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class GNNOutput:
    predictions: torch.Tensor  # (B, T) or (B, 4T) raw outputs, fp32
    attention_weights: Optional[torch.Tensor]  # (H, A) or None
    partial_charges: Optional[torch.Tensor]  # always None on this path
    atom_embeddings: Optional[torch.Tensor]  # (A, hidden) fp32, when asked for
    mol_embeddings: torch.Tensor  # (B, hidden) pooled, fp32


def _unsupported(cfg: GNNConfig) -> Optional[str]:
    if not cfg.parity_mode:
        return "true per-hop aggregation (parity_mode=False)"
    if cfg.use_partial_charges or cfg.use_stereochemistry:
        return "partial charges / stereochemistry (config 3)"
    if cfg.num_message_passing_layers < 2:
        return "single-layer message passing"
    if cfg.graph_axis is not None:
        return "graph-partitioned execution"
    if cfg.pooling_type not in POOLING_TYPES:
        return f"{cfg.pooling_type} pooling"
    return None


class GNN(nn.Module):
    def __init__(self, config: GNNConfig):
        super().__init__()
        why = _unsupported(config)
        if why is not None:
            raise NotImplementedError(f"{why} is not ported yet")
        cfg = self.config = config
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        fs = dict(cfg.feature_sizes)
        for name in _EMBEDDINGS:
            setattr(self, f"{name}_embedding", nn.Embedding(fs[name], cfg.embedding_dim))
            nn.init.zeros_(getattr(self, f"{name}_embedding").weight)
        H = cfg.hidden_dim
        self.embedding_projection = Linear(4 * cfg.embedding_dim, H)
        if cfg.parity_params:
            # dead parameter kept for checkpoint parity (quirk Q5)
            self.long_range_projection = Linear(H, cfg.ffn_dim)
        self.message_passing_layers = nn.ModuleList(
            ShellConvolutionLayer(cfg.x_other_dim, cfg.num_shells, cfg.shell_conv_num_mlp_layers)
            for _ in range(cfg.num_message_passing_layers)
        )
        self.concat_self_other = Linear(H, H)
        if cfg.pooling_type == "attention":
            self.pooling = MultiHeadAttentionPooling(H, cfg.attention_num_heads)
        self.post_pooling_projection = Linear(H, cfg.ffn_dim, cdt)
        self.ffn = MultiLayerPerceptron(
            cfg.ffn_dim, cfg.ffn_dim, cfg.ffn_dim, cfg.ffn_num_layers, cfg.activation_type,
            use_skip=True, dtype=cdt,
        )
        self.skip_transform = Linear(cfg.ffn_dim, cfg.ffn_dim, cdt)
        self.output_layer = Linear(2 * cfg.ffn_dim, cfg.final_output_dim)
        self._stack_cache: Optional[Tuple[tuple, StackWeights]] = None

    def stack_weights(self) -> StackWeights:
        """The MP layers' weights in the stack kernel's prepped form, built
        once per load of the weights (cast, transposed, padded) and reused
        by every forward until a parameter is replaced or modified."""
        params = list(self.message_passing_layers.parameters())
        key = tuple((p.data_ptr(), p._version) for p in params) + (self.compute_dtype,)
        if self._stack_cache is None or self._stack_cache[0] != key:
            with torch.no_grad():
                sw = stack_weights(
                    [layer.stack_weights() for layer in self.message_passing_layers],
                    self.compute_dtype,
                )
            self._stack_cache = (key, sw)
        return self._stack_cache[1]

    def forward(self, batch: MolBatch, atom_embeddings: bool = False) -> GNNOutput:
        """``batch``: a binned MolBatch of torch tensors (``MolBatch.to``).
        ``atom_embeddings``: also return the (A, hidden) atom embeddings,
        which cost an A x hidden x hidden product and are skipped otherwise."""
        cfg = self.config
        if batch.bin_adj is None or batch.pool_mat is None:
            raise NotImplementedError("the flat (non-binned) layout is not ported yet")
        act = get_activation_function(cfg.activation_type)
        dt = self.compute_dtype
        cdt = dt if dt == torch.bfloat16 else None

        # 1-2. embeddings, projection and split, feature-major
        tables = [getattr(self, f"{n}_embedding").weight for n in _EMBEDDINGS]
        xT = embed_concat_onehot_t(tables, [getattr(batch, n) for n in _EMBEDDINGS], dtype=dt)
        W, b = self.embedding_projection.weight, self.embedding_projection.bias
        xs = cfg.x_self_dim

        def proj_rows(w, bb):
            return act(mm32(w, xT, cdt).to(dt) + bb.to(dt)[:, None])

        x_self = proj_rows(W[:xs], b[:xs])  # (xs, A)
        x_other = proj_rows(W[xs:], b[xs:])  # (D, A)

        # 3. message passing: one fused stack
        x_other = binned_mp_stack_t(
            x_other.contiguous(), batch.bin_adj, self.stack_weights(), act=cfg.activation_type
        )

        # 4. combine (atom-embedding tap) and pool
        k_cs = self.concat_self_other.weight.T  # (in, out)
        b_cs = self.concat_self_other.bias
        atom_emb = None
        if atom_embeddings:
            y = mm32(x_self.T, k_cs[:xs], cdt) + mm32(x_other.T, k_cs[xs:], cdt)
            atom_emb = ((y.to(dt) + b_cs.to(dt)) if cdt is not None else y + b_cs).float()
        pm = batch.pool_mat
        attention_weights = None
        if cfg.pooling_type == "attention":
            mol, attention_weights = self.pooling([x_self, x_other], pm, (k_cs, b_cs))
        elif cfg.pooling_type == "mean":
            pooled = [binned_mean_pool_t(p, pm) for p in (x_self, x_other)]
            mol = pool_then_project(pooled, (pm.sum(dim=2) > 0).reshape(-1), k_cs, b_cs, dt)
        else:  # sum
            pooled = [binned_sum_pool_t(p, pm) for p in (x_self, x_other)]
            mol = pool_then_project(pooled, pm.sum(dim=2).reshape(-1), k_cs, b_cs, dt)

        # 5. head
        h = self.ffn(self.post_pooling_projection(mol))
        final = torch.cat([h, self.skip_transform(h)], dim=-1).float()
        predictions = self.output_layer(final)
        return GNNOutput(
            predictions=predictions,
            attention_weights=attention_weights,
            partial_charges=None,
            atom_embeddings=atom_emb,
            mol_embeddings=mol,
        )
