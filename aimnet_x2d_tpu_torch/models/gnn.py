"""The GNN model (counterpart of aimnet_x2d_tpu/models/gnn.py).

A batch comes in one of two layouts (data/dataset.py decides): binned,
when every molecule fits a bin, or flat.

Forward on the binned, feature-major fast path (the JAX ``t_path``):

1. four embedding lookups -> concat, feature-major (4*emb, A)
2. embedding_projection -> act, split into x_self and x_other
   (x_other_dim = int(0.3 * hidden), quirk Q2)
3. message passing on x_other, by one of four routes (:func:`mp_route`):
   - ``stack``: the fused stack of every layer (ops/bin_mp.py, kernel 1);
   - ``inject`` (partial charges and stereochemistry, config 3): per layer
     one fused round of charge equilibration, cis/trans and tetrahedral
     stereo, the stereo projection, the layer and its residual
     (ops/bin_inject.py, kernel 4);
   - ``layer`` (one of the two features, or a single layer): per layer the
     injections as plain PyTorch (the JAX package runs them as XLA:
     ``bin_inject.charge_rows``, :func:`stereochemistry_t`), then the
     single-layer kernel with its residual (kernel 1d);
   - ``none`` (no message-passing layers): x_other is the projection
     itself (the JAX row-major binned arithmetic up to fp32 reassociation);
4. pooling of [x_self, x_other] with concat_self_other folded in
   (attention, mean or sum; ops/bin_wpool.py kernels), or, for max
   pooling, concat_self_other on the atoms then the masked max (plain
   PyTorch; the JAX package has no kernel for it)
5. post_pooling_projection -> FFN -> [h, skip_transform(h)] -> output_layer

With partial charges, row 0 of the final x_other is the per-atom charge
(``GNNOutput.partial_charges``).

``forward(batch, train=True)`` is the training forward of the JAX train
step (``train_mode=True``, dropout on), differentiable end to end.  On the
stack route the stack takes the embeddings and folds the x_other projection
in (kernels 1, 1b, 1c); on the other routes the projection is plain autograd
and each layer's kernel has its own backward (4, 1d).  Attention pooling
takes the embeddings and folds the x_self projection in (kernel 3); mean,
sum and max pooling take x_self from plain autograd, and mean and sum pool
through the weighted pool's forward and backward kernels (2, 2b).  With
``AIMNET_EMBED_FOLD=1`` (the JAX package's switch, read on each training
forward) the stack and the attention pool take the atoms' code rows and
the block-diagonal table instead of the embeddings where JAX folds (its
feature-major path: the stack route, and the layer routes with charges or
stereochemistry; kernel 1c-vocab), and the tables get their gradient from
the kernels; under ``torch.inference_mode()`` (MC-dropout serving, JAX's
stochastic forward) nothing folds.  The step's dropout seed is one int32 (each single-layer call gets
``layer_drop_seed(seed, l)`` on the per-layer routes, as in JAX), and the
FFN's dropout masks come from a ``torch.Generator``.

Forward on the row-major route: flat batches (the JAX path of batches with
a molecule larger than a bin), and binned batches of models with true
per-hop aggregation (``parity_mode=False``: JAX's stack routes need parity
mode, so its binned batches then take its row-major path), serving and
training alike: the embeddings (fp32 gather, or in bf16 the rounded
tables), the x_self and x_other projections, each layer preceded by the
row-major injections of config 3 (:func:`charge_equilibration`,
:func:`stereochemistry`; binned batches sum over the membership matrix and
the per-bin signed adjacency, flat ones over segments) and followed by
``+ x_other`` (``ShellConvolutionLayer.forward``: in parity mode the edge
aggregation of kernel 7, ops/fused_edge.py, else one sum per hop), the
atom-embedding tap, and the pools with concat_self_other folded in: on
binned batches attention through kernel 6 (ops/bin_pool.py) and mean and
sum over the membership matrix, on flat ones the segment pools of
models/pooling.py; max over the atom embeddings.  Its dropout masks
(layers and FFN) come from the ``generator``.

Forward on halo graph shards (a batch with ``halo_send_idx``, from
parallel/halo.py): the rank's atoms row-major through the embeddings and
projections, then the layers over the graph axis (``GNNConfig.graph_axis``,
default ``"graph"``, resolved by parallel/mesh.py), by one of two routes:

- binned shards in parity mode (the JAX ``use_halo_stack`` route), per
  layer: config 3's injections feature-major (:func:`charge_equilibration_t_seg`,
  whose per-molecule sums are psummed over the graph axis, and
  :func:`stereochemistry_t` on the shard's pair lists, since chunked
  fragments may put a pair's ends in different bins), the halo exchange,
  the local per-bin aggregation plus the halo rows' contribution
  (ops/halo.py), kernel 5 on ``[x ; agg]`` (``binned_mp_layer_ext_t``) and
  the residual; kernel 4 does not run there, as in JAX;
- flat shards, and per-hop models on either layout (the row-major halo
  route, JAX's layer loop with ``halo_send_idx``): the row-major injections
  (the charge sums psummed) and ``ShellConvolutionLayer.forward``, whose
  edges read ``[x ; halo_exchange(x)]`` and sum by ``index_add`` (JAX takes
  ``segment_sum``, no kernel, with a graph axis).

Then the atom embeddings and the segment pools with their per-molecule sums
psummed over the graph axis (models/pooling.py), so molecules split across
ranks pool exactly; with partial charges each rank's charges are row 0 of
its final x_other.  On every route the stereo context's any-centre flag is
a pmax over the axis.  Dropout on the halo stack: the step's seed plus the
graph rank, then ``layer_drop_seed`` per layer, as JAX draws it.

Forward on edge shards (JAX's edge-replicated mode: ``GNNConfig.graph_axis``
set and a batch without ``halo_send_idx``, from data/batching.py
``shard_edges``): every rank holds all the atoms and a slice of the edges.
The row-major route runs as on one rank, except that each layer psums its
fp32 partial aggregate over the graph axis (``ShellConvolutionLayer``;
kernel 7 does not run, as JAX takes no kernel with a graph axis).  Charge
equilibration, the stereo context and the pools take no axis: the atoms are
replicated, so their sums are already whole (JAX's ``pool_axis`` is None
without halo).  Dropout masks are drawn as on one rank from the
``generator``, which the graph ranks of one data rank seed alike.

With ``remat`` (the CLI's ``--gradient_checkpointing``) the training
forward recomputes each layer in the backward pass instead of keeping its
activations (``torch.utils.checkpoint``; JAX ``nn.remat``) on the per-layer
routes: the inject and layer routes' kernel call, the row-major
``ShellConvolutionLayer`` call (the halo exchange with it on halo shards)
and the halo stack's kernel-5 call.  The recomputation draws the same
dropout: the kernels take the same seed, and the generator of the plain
dropout is put back to its state at the layer's forward for the
recomputation, then to where it was (:func:`_remat`).  The fused stack saves
only its input anyway (JAX remats nothing there).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..data.batching import MolBatch
from ..ops import bin_inject
from ..ops.bin_mp import (
    binned_mp_layer_ext_t,
    binned_mp_layer_t,
    binned_mp_layer_train_t,
    binned_mp_stack_t,
    binned_mp_stack_train_t,
    layer_drop_seed,
    stack_weights,
)
from ..ops.bin_attnpool import embed_fold_enabled
from ..ops.embed import blockdiag_table_t, code_rows, embed_concat_onehot, embed_concat_onehot_t
from ..ops.halo import binned_local_agg_t, halo_agg_contrib_t, halo_exchange_t
from ..ops.segment import segment_sum
from ..parallel import mesh
from ..utils.activation import get_activation_function
from .layers import Linear, MultiLayerPerceptron, ShellConvolutionLayer, mm32
from .pooling import (
    POOLING_TYPES,
    MultiHeadAttentionPooling,
    atom_counts,
    binned_max_pool,
    binned_mean_pool,
    binned_mean_pool_t,
    binned_sum_pool,
    binned_sum_pool_t,
    max_pool,
    mean_pool,
    pool_then_project,
    sum_pool,
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
    partial_charges: Optional[torch.Tensor]  # (A,) fp32 with partial charges, else None
    atom_embeddings: Optional[torch.Tensor]  # (A, hidden) fp32, when asked for
    mol_embeddings: torch.Tensor  # (B, hidden) pooled, fp32


def _unsupported(cfg: GNNConfig) -> Optional[str]:
    if cfg.use_partial_charges and cfg.x_other_dim < 2:
        return "partial charges with fewer than 2 x_other features"
    if cfg.pooling_type not in POOLING_TYPES:
        return f"{cfg.pooling_type} pooling"
    return None


def _remat(on: bool, fn, x: torch.Tensor, generator: Optional[torch.Generator] = None):
    """``fn(x)``; with ``on``, under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are dropped after the forward and recomputed when the
    backward needs them, so ``fn`` must bind what a loop changes (the
    recomputation runs after the loop).  Checkpoint restores only the
    default generators, so ``generator``'s state at the forward is replayed
    for the recomputation, and its later state put back after it."""
    if not (on and torch.is_grad_enabled()):
        return fn(x)
    from torch.utils.checkpoint import checkpoint

    if generator is None:
        return checkpoint(fn, x, use_reentrant=False)
    state = generator.get_state()

    @contextlib.contextmanager
    def replay():
        later = generator.get_state()
        generator.set_state(state)
        try:
            yield
        finally:
            generator.set_state(later)

    return checkpoint(fn, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), replay()))


def mp_route(cfg: GNNConfig) -> str:
    """How the message-passing layers run on the binned layout (module
    docstring): ``rows`` (the row-major route) with true per-hop
    aggregation, ``none`` without layers, ``inject`` with both charges and
    stereochemistry, ``layer`` with one of them or a single layer, else
    ``stack``."""
    if not cfg.parity_mode:
        return "rows"
    if cfg.num_message_passing_layers == 0:
        return "none"
    if cfg.use_partial_charges and cfg.use_stereochemistry:
        return "inject"
    if cfg.use_partial_charges or cfg.use_stereochemistry or cfg.num_message_passing_layers == 1:
        return "layer"
    return "stack"


# ---- the injections (the JAX package's XLA code between its kernels) -------- #


@dataclasses.dataclass
class StereoContext:
    """Per-batch stereo tables, built once on the batch's device (the JAX
    ``GNN._stereo_context``): on binned batches the signed int8 per-bin
    cis/trans adjacency (nb, ab, ab) (trans +1, cis -1 per directed pair,
    duplicates counted; None on flat batches and halo shards, which sum
    over the pair lists), the clipped centre rows (C, 4) and their flat
    scatter index (C*4,) (masked rows point at A), the mask of atoms next to
    a centre (A,), and whether the batch has any centre (0-d bool; on halo
    shards any rank's, a pmax over the graph axis)."""

    stereo_adj: Optional[torch.Tensor]
    tet_nbrs: torch.Tensor
    tet_flat: torch.Tensor
    tet_mask: torch.Tensor
    tet_nz: torch.Tensor
    any_tet: torch.Tensor


def stereo_context(batch: MolBatch, ax: Optional[mesh.Axis] = None) -> StereoContext:
    """The batch's stereo tables; ``ax``: the graph axis of a halo shard,
    whose chunked fragments may put a cis/trans pair's ends in different
    bins, so it keeps the pair lists (JAX ``_stereo_context``)."""
    A = batch.num_atom_slots
    dev = batch.atom_type.device
    sadj = None
    if batch.bin_adj is not None and batch.halo_send_idx is None:
        nb, ab, _ = batch.bin_adj.shape
        idx, vals = [], []
        for pairs, mask, v in ((batch.cis_pairs, batch.cis_mask, -1.0),
                               (batch.trans_pairs, batch.trans_mask, 1.0)):
            src, dst = pairs[:, 0].long(), pairs[:, 1].long()
            flat = (dst // ab) * (ab * ab) + (dst % ab) * ab + src % ab
            idx.append(torch.where(mask & (dst < A), flat, torch.full_like(flat, nb * ab * ab)))
            vals.append(torch.full(flat.shape, v, device=dev))
        sadj = torch.zeros(nb * ab * ab + 1, device=dev).index_add_(0, torch.cat(idx),
                                                                    torch.cat(vals))
        sadj = sadj[:-1].reshape(nb, ab, ab)
        # a few directed pairs a stereo bond land in one entry; a sum past
        # int8's range would wrap silently in the cast (one read on the host)
        if bool(sadj.abs().amax() > 127):
            raise ValueError("a signed cis/trans adjacency entry sums past +-127 and does not "
                             "fit int8: the batch repeats one cis/trans pair over 127 times")
        sadj = sadj.to(torch.int8)
    tet_flat = torch.where(batch.tet_mask[:, None], batch.tet_nbrs.long(),
                           torch.full_like(batch.tet_nbrs, A, dtype=torch.long)).reshape(-1)
    any_tet = batch.tet_mask.any()
    if ax is not None:
        # the reference zeroes every atom off a centre when the BATCH has one
        any_tet = ax.pmax(any_tet.int().reshape(1))[0] > 0
    return StereoContext(
        stereo_adj=sadj,
        tet_nbrs=batch.tet_nbrs.long().clamp(0, A - 1),
        tet_flat=tet_flat,
        tet_mask=batch.tet_mask,
        tet_nz=torch.bincount(tet_flat, minlength=A + 1)[:A] > 0,
        any_tet=any_tet,
    )


def atom_total_charge(batch: MolBatch) -> torch.Tensor:
    """(A,) fp32: each real atom carries its molecule's total charge,
    padding atoms 0 (built once per batch)."""
    B = batch.total_charge.shape[0]
    mol = batch.atom_mol.long().clamp(0, B - 1)
    return torch.where(batch.atom_mask, batch.total_charge.float()[mol],
                       torch.zeros((), device=mol.device)).contiguous()


def _tet_features(x: torch.Tensor, ctx: StereoContext) -> torch.Tensor:
    """Row-major tetrahedral feature (JAX ``_tetrahedral_features``), in x's
    dtype: each centre's 4 neighbour rows (C, 4, D) normalized, the
    antisymmetric roll polynomial scaled by tanh(mean |row| / 3) (zero on
    masked centres) scattered into the neighbours and added to x; every
    other atom zero when the batch has any centre, else x itself."""
    A, D = x.shape
    C = ctx.tet_nbrs.shape[0]
    emb_raw = x.index_select(0, ctx.tet_nbrs.reshape(-1)).reshape(C, 4, D)
    mags = torch.linalg.vector_norm(emb_raw, dim=-1, keepdim=True)
    emb = emb_raw / mags.clamp(min=1e-8)
    sq = emb * emb
    s1, s2, s3 = (torch.roll(sq, -k, dims=1) for k in (1, 2, 3))
    e1, e2, e3 = (torch.roll(emb, -k, dims=1) for k in (1, 2, 3))
    chir = s1 * (e2 - e3) + s2 * (e3 - e1) + s3 * (e1 - e2)
    chir = chir * torch.tanh(mags.mean(dim=1, keepdim=True) / 3.0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    chir = torch.where(ctx.tet_mask[:, None, None], chir, zero).reshape(-1, D)
    updated = x + x.new_zeros(A + 1, D).index_add(0, ctx.tet_flat, chir)[:A]
    return torch.where(ctx.any_tet, torch.where(ctx.tet_nz[:, None], updated, zero), x)


def _cis_trans_rows(x: torch.Tensor, batch: MolBatch) -> torch.Tensor:
    """The cis/trans contribution from the pair lists, row-major x (A, D),
    in x's dtype: -x[src] of each cis pair and +x[src] of each trans pair
    summed into their destinations (JAX ``_cis_trans_features``' segment
    path)."""
    A = x.shape[0]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    src = [torch.where(mask[:, None], x.index_select(0, pairs[:, 0].long().clamp(0, A - 1)), zero)
           for pairs, mask in ((batch.cis_pairs, batch.cis_mask),
                               (batch.trans_pairs, batch.trans_mask))]
    return (segment_sum(-src[0], batch.cis_pairs[:, 1], A)
            + segment_sum(src[1], batch.trans_pairs[:, 1], A))


def stereochemistry_t(x: torch.Tensor, kb: torch.Tensor, b: torch.Tensor,
                      ctx: StereoContext, batch: Optional[MolBatch] = None) -> torch.Tensor:
    """Stereo injection (quirks Q6/Q7; JAX ``_stereochemistry_t``),
    feature-major x (D, A), in x's dtype as JAX runs it: cct = x + (x S^T)
    per bin, or, on a halo shard (no ``ctx.stereo_adj``), x plus the pair
    lists' contribution of ``batch``, whose pairs may cross bins; tet = the
    tetrahedral feature; then kb^T [x; cct; tet] (one fp32 sum, one cast) +
    b.  ``kb`` (3D, D) and ``b`` (D,) are the stereo projection's fp32
    masters."""
    dt = x.dtype
    D, A = x.shape
    if ctx.stereo_adj is not None:
        nb, ab, _ = ctx.stereo_adj.shape
        xb = x.reshape(D, nb, ab).permute(1, 0, 2).float()
        agg = torch.matmul(xb, ctx.stereo_adj.float().transpose(1, 2)).permute(1, 0, 2)
        cct = x + agg.reshape(D, A).to(dt)
    else:
        cct = x + _cis_trans_rows(x.T, batch).T
    tet = _tet_features(x.T, ctx).T
    y = sum(mm32(kb[i * D : (i + 1) * D].T, p, dt) for i, p in enumerate((x, cct, tet)))
    return y.to(dt) + b.to(dt)[:, None]


def stereochemistry(x: torch.Tensor, kb: torch.Tensor, b: torch.Tensor, ctx: StereoContext,
                    batch: MolBatch) -> torch.Tensor:
    """Row-major stereo injection (JAX ``_stereochemistry``), x (A, D) in its
    dtype: cct = x + the cis/trans contribution (binned: the per-bin signed
    adjacency times x, fp32 sums cast to x's dtype; flat batches and halo
    shards: :func:`_cis_trans_rows`); tet = the tetrahedral feature; then
    [x, cct, tet] kb, each part by its row block of kb rounded to x's dtype
    (fp32 sums, one cast), + b."""
    dt = x.dtype
    A, D = x.shape
    if ctx.stereo_adj is not None:
        nb, ab, _ = ctx.stereo_adj.shape
        contrib = torch.matmul(ctx.stereo_adj.to(dt).float(), x.reshape(nb, ab, D).float())
        cct = x + contrib.reshape(A, D).to(dt)
    else:
        cct = x + _cis_trans_rows(x, batch)
    y = sum(mm32(p, kb[i * D : (i + 1) * D], dt)
            for i, p in enumerate((x, cct, _tet_features(x, ctx))))
    return y.to(dt) + b.to(dt)


def charge_equilibration(x: torch.Tensor, batch: MolBatch,
                         ax: Optional[mesh.Axis] = None) -> torch.Tensor:
    """Row-major partial-charge equilibration (quirk Q3; JAX
    ``_charge_equilibration``): channels 0 and 1 of x (A, D) are the charge
    q and an electronegativity f (clipped at 1e-6); per molecule Q and
    F = max(sum f + 1e-6, 1e-6); f <- f / F, q <- q + f (Q_total - Q).
    Binned batches sum over the membership matrix in fp32 (atoms of no
    molecule keep q and get f = 0); flat ones sum segments in x's dtype,
    each atom reading its molecule (padding the last one's, as JAX's
    clamped gather does).  On a halo shard (``ax``, the graph axis) the
    segment sums are this rank's partials, psummed over the axis (autograd's
    too) so a molecule split across ranks equilibrates whole.  The new q
    and f are fp32, so a bf16 x comes back fp32, as JAX's concatenate
    promotes it."""
    q, f, rest = x[:, :1], x[:, 1:2].clamp(min=1e-6), x[:, 2:]
    B = batch.total_charge.shape[0]
    pm = batch.pool_mat
    if pm is not None and ax is None:
        nb, mb, ab = pm.shape
        ohf = pm.float()
        QF = torch.einsum("bma,bac->bmc", ohf, torch.cat([q, f], -1).reshape(nb, ab, 2).float())
        F_u = (QF[..., 1:2] + 1e-6).clamp(min=1e-6)
        dQ = batch.total_charge.float().reshape(nb, mb, 1) - QF[..., 0:1]
        per_atom = torch.einsum("bma,bmc->bac", ohf, torch.cat([1.0 / F_u, dQ], -1)).reshape(-1, 2)
        f_new = f * per_atom[:, 0:1]
        q_new = q + f_new * per_atom[:, 1:2]
    else:
        seg = torch.where(batch.atom_mask, batch.atom_mol.long(),
                          torch.full_like(batch.atom_mol, B, dtype=torch.long))
        # per-molecule sums in fp32, rounded once to x's dtype (the JAX
        # config's rule: scatter accumulation stays fp32), forward and
        # backward (the gathers' backward sums each molecule's atoms): a
        # bf16 running sum stalls at 256 for a molecule of hundreds of
        # atoms, at a value that depends on the order of the adds
        zero = torch.zeros((), device=x.device)
        mask = batch.atom_mask[:, None]
        QF = segment_sum(torch.where(mask, torch.cat([q, f], -1).float(), zero), seg, B)
        if ax is not None:
            QF = ax.psum(QF)
        Q_u, F_u = QF[:, :1].to(x.dtype), QF[:, 1:].to(x.dtype)
        F_u = (F_u + 1e-6).clamp(min=1e-6)
        dQ = batch.total_charge.float()[:, None] - Q_u
        mol = batch.atom_mol.long().clamp(max=B - 1)
        f_new = f / F_u.float().index_select(0, mol).to(x.dtype)
        q_new = q + f_new * dQ.index_select(0, mol)
    return torch.cat([q_new, f_new, rest], dim=-1)


def charge_equilibration_t_seg(x: torch.Tensor, batch: MolBatch,
                               ax: Optional[mesh.Axis]) -> torch.Tensor:
    """Feature-major charge equilibration by segment sums (quirk Q3; JAX
    ``_charge_equilibration_t_seg``), the halo shard's twin of
    ``bin_inject.charge_rows``: rows 0 and 1 of x (D, A) are q and f; the
    per-molecule Q and F are fp32 segment sums of this rank's atoms,
    psummed over the graph axis ``ax`` (autograd's too) so a molecule split
    across ranks equilibrates whole; the new rows are cast back to x's
    dtype."""
    B = batch.total_charge.shape[0]
    q = x[0:1].float()
    f = x[1:2].float().clamp(min=1e-6)
    seg = torch.where(batch.atom_mask, batch.atom_mol.long(),
                      torch.full_like(batch.atom_mol, B, dtype=torch.long))
    zero = torch.zeros((), device=x.device)
    QF = segment_sum(torch.where(batch.atom_mask[:, None], torch.cat([q, f]).T, zero), seg, B)
    if ax is not None:
        QF = ax.psum(QF)
    F_u = (QF[:, 1] + 1e-6).clamp(min=1e-6)
    dQ = batch.total_charge.float() - QF[:, 0]
    mol = batch.atom_mol.long().clamp(max=B - 1)
    f_new = f * (1.0 / F_u).index_select(0, mol)[None]
    q_new = q + f_new * dQ.index_select(0, mol)[None]
    return torch.cat([q_new.to(x.dtype), f_new.to(x.dtype), x[2:]])


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
            ShellConvolutionLayer(cfg.x_other_dim, cfg.num_shells, cfg.shell_conv_num_mlp_layers,
                                  cfg.activation_type, cfg.shell_conv_dropout, cdt,
                                  cfg.parity_mode)
            for _ in range(cfg.num_message_passing_layers)
        )
        if cfg.use_stereochemistry:
            if cfg.parity_params:
                # dead parameter kept for checkpoint parity (JAX gnn.py:339-347)
                self.stereochemical_embedding = Linear(3 * H, H)
            # the stereo projection, shared by every layer
            D = cfg.x_other_dim
            self.stereochemical_embedding_2 = Linear(3 * D, D)
        self.concat_self_other = Linear(H, H)
        if cfg.pooling_type == "attention":
            self.pooling = MultiHeadAttentionPooling(H, cfg.attention_num_heads)
        self.post_pooling_projection = Linear(H, cfg.ffn_dim, cdt)
        self.ffn = MultiLayerPerceptron(
            cfg.ffn_dim, cfg.ffn_dim, cfg.ffn_dim, cfg.ffn_num_layers, cfg.activation_type,
            use_skip=True, dtype=cdt, dropout=cfg.ffn_dropout,
        )
        self.skip_transform = Linear(cfg.ffn_dim, cfg.ffn_dim, cdt)
        self.output_layer = Linear(2 * cfg.ffn_dim, cfg.final_output_dim)
        self.route = mp_route(cfg)
        self._prep_cache: Optional[tuple] = None

    def _stereo_proj(self):
        """The stereo projection's fp32 masters in flax orientation: kb
        (3D, D) and b (D,)."""
        lin = self.stereochemical_embedding_2
        return lin.weight.T, lin.bias

    def prepped_weights(self):
        """The MP layers' weights in the kernels' prepped form (cast,
        transposed, padded), built once per load of the weights and reused
        by every serving forward until a parameter is replaced or modified:
        one ``StackWeights`` of every layer on the stack route, one per
        layer on the layer route, one ``InjectWeights`` per layer on the
        inject route."""
        mods = [self.message_passing_layers]
        if self.route == "inject":
            mods.append(self.stereochemical_embedding_2)
        params = [p for m in mods for p in m.parameters()]
        key = tuple((p.data_ptr(), p._version) for p in params) + (self.compute_dtype,)
        if self._prep_cache is None or self._prep_cache[0] != key:
            dt = self.compute_dtype
            layers = [layer.stack_weights() for layer in self.message_passing_layers]
            with torch.no_grad():
                if self.route == "stack":
                    prepped = stack_weights(layers, dt)
                elif self.route == "layer":
                    prepped = [stack_weights([lw], dt) for lw in layers]
                else:
                    kb, b = self._stereo_proj()
                    prepped = [bin_inject.prep_inject(kb, b, lw, dt) for lw in layers]
            self._prep_cache = (key, prepped)
        return self._prep_cache[1]

    def _message_passing(self, batch: MolBatch, x: torch.Tensor, train: bool,
                         drop_seed: Optional[int]) -> torch.Tensor:
        """The inject and layer routes over x_other (D, A) in the compute
        dtype: per layer kernel 4, or the injections then kernel 1d.  The
        training form takes the fp32 masters (autograd); serving takes the
        prepped weights.  Without layers (route ``none``) x passes through."""
        if self.route == "none":
            return x
        cfg = self.config
        act = cfg.activation_type
        dt = self.compute_dtype
        rate = cfg.shell_conv_dropout if train else 0.0
        ctx = stereo_context(batch) if cfg.use_stereochemistry else None
        prepped = None if train else self.prepped_weights()
        single = self.route == "layer" and not (cfg.use_partial_charges or cfg.use_stereochemistry)
        tca = atom_total_charge(batch) if cfg.use_partial_charges else None
        if self.route == "inject":
            anyt = ctx.any_tet.float().reshape(1)
            tables = (tca, batch.pool_mat, batch.tet_bin, anyt, ctx.stereo_adj, batch.bin_adj)
        for l, layer in enumerate(self.message_passing_layers):
            # one layer draws its own seed in JAX; per-layer calls fold l in
            seed = (drop_seed if single else layer_drop_seed(drop_seed, l)) if rate > 0 else 0
            if self.route == "inject":
                if train:
                    kb, b = self._stereo_proj()
                    x = _remat(cfg.remat, lambda x_, w=layer.stack_weights(), seed=seed:
                               bin_inject.binned_inject_mp_layer_train_t(
                                   x_, *tables, kb, b, w, dt, act, rate, seed), x)
                else:
                    x = bin_inject.binned_inject_mp_layer_t(x.contiguous(), *tables, prepped[l], act)
                continue
            if cfg.use_partial_charges:
                x = bin_inject.charge_rows(x, tca, batch.pool_mat)
            if cfg.use_stereochemistry:
                x = stereochemistry_t(x, *self._stereo_proj(), ctx)
            if train:
                x = _remat(cfg.remat, lambda x_, w=layer.stack_weights(), seed=seed:
                           binned_mp_layer_train_t(x_, batch.bin_adj, w, dt, act, rate, seed), x)
            else:
                x = binned_mp_layer_t(x.contiguous(), batch.bin_adj, prepped[l], act)
        return x

    def forward(
        self,
        batch: MolBatch,
        atom_embeddings: bool = False,
        train: bool = False,
        drop_seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> GNNOutput:
        """``batch``: a binned or flat MolBatch of torch tensors
        (``MolBatch.to``).  ``atom_embeddings``: also return the (A, hidden)
        atom embeddings, which cost an A x hidden x hidden product and are
        skipped otherwise.  ``train``: the training forward (see the module
        docstring), with the binned layers' dropout seed ``drop_seed`` (drawn
        from ``generator`` when not given) and the FFN's (and the flat
        layers') dropout masks from ``generator``; training with a dropout
        rate above 0 and no generator raises."""
        cfg = self.config
        if batch.halo_send_idx is not None:
            return self._forward_halo(batch, atom_embeddings, train, drop_seed, generator)
        if batch.pool_mat is None or self.route == "rows" or cfg.graph_axis is not None:
            return self._forward_rows(batch, atom_embeddings, train, generator)
        if train:
            return self._forward_train(batch, drop_seed, generator)
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

        # 3. message passing
        if self.route == "stack":
            x_other = binned_mp_stack_t(
                x_other.contiguous(), batch.bin_adj, self.prepped_weights(), act=cfg.activation_type
            )
        else:
            x_other = self._message_passing(batch, x_other, False, None)

        # 4. combine (atom-embedding tap) and pool
        pm = batch.pool_mat
        atom_emb = None
        if atom_embeddings or cfg.pooling_type == "max":
            atom_emb = self._atom_embeddings(x_self.T, x_other.T)
        attention_weights = None
        if cfg.pooling_type == "attention":
            k_cs = self.concat_self_other.weight.T  # (in, out)
            mol, attention_weights = self.pooling([x_self, x_other], pm,
                                                  (k_cs, self.concat_self_other.bias))
        elif cfg.pooling_type == "max":
            mol = binned_max_pool(atom_emb, pm)
        else:
            mol = self._linear_pool(x_self, x_other, pm)
        atom_emb = atom_emb.float() if atom_embeddings else None
        return self._head(mol, attention_weights, atom_emb, self._charges(x_other), None)

    def _atom_embeddings(self, x_self: torch.Tensor, x_other: torch.Tensor) -> torch.Tensor:
        """(A, hidden) in the compute dtype: concat_self_other applied to the
        row-major [x_self (A, d_s), x_other (A, d_o)] by row blocks of its
        kernel (the concat is never formed), as the JAX package's
        atom-embedding tap."""
        dt = self.compute_dtype
        cdt = dt if dt == torch.bfloat16 else None
        k_cs, b_cs = self.concat_self_other.weight.T, self.concat_self_other.bias
        xs = self.config.x_self_dim
        y = mm32(x_self, k_cs[:xs], cdt) + mm32(x_other, k_cs[xs:], cdt)
        return (y.to(dt) + b_cs.to(dt)) if cdt is not None else y + b_cs

    def _linear_pool(self, x_self: torch.Tensor, x_other: torch.Tensor,
                     pm: torch.Tensor) -> torch.Tensor:
        """Mean or sum pooling of each part through the weighted-pool kernels,
        then concat_self_other on the pooled parts, its bias scaled by each
        slot's coverage (mean) or atom count (sum): (B, hidden) fp32."""
        mean = self.config.pooling_type == "mean"
        pool = binned_mean_pool_t if mean else binned_sum_pool_t
        counts = pm.sum(dim=2).reshape(-1)
        return pool_then_project([pool(p, pm) for p in (x_self, x_other)],
                                 counts > 0 if mean else counts,
                                 self.concat_self_other.weight.T, self.concat_self_other.bias,
                                 self.compute_dtype)

    def _charges(self, x_other: torch.Tensor) -> Optional[torch.Tensor]:
        return x_other[0].float() if self.config.use_partial_charges else None

    def _head(self, mol, attention_weights, atom_emb, charges, generator) -> GNNOutput:
        h = self.ffn(self.post_pooling_projection(mol), generator)
        final = torch.cat([h, self.skip_transform(h)], dim=-1).float()
        return GNNOutput(
            predictions=self.output_layer(final),
            attention_weights=attention_weights,
            partial_charges=charges,
            atom_embeddings=atom_emb,
            mol_embeddings=mol.float(),
        )

    def _forward_train(self, batch: MolBatch, drop_seed: Optional[int],
                       generator: Optional[torch.Generator]) -> GNNOutput:
        cfg = self.config
        dt = self.compute_dtype
        cdt = dt if dt == torch.bfloat16 else None
        act = get_activation_function(cfg.activation_type)
        tables = [getattr(self, f"{n}_embedding").weight for n in _EMBEDDINGS]
        ids = [getattr(batch, n) for n in _EMBEDDINGS]
        # The embedding fold (AIMNET_EMBED_FOLD) applies where JAX is on its
        # feature-major path (t_path: the stack, or layers with charges or
        # stereochemistry): the stack folds, and the attention pool does.
        # With both folded no (E, A) embedding array is built.  Under
        # inference mode (MC-dropout serving) the forward is never
        # differentiated, and, as JAX's stochastic forward (train_mode
        # False), it does not fold.
        t_path = self.route == "stack" or (
            self.route in ("inject", "layer") and (cfg.use_partial_charges or cfg.use_stereochemistry))
        fold = t_path and embed_fold_enabled() and not torch.is_inference_mode_enabled()
        fold_stack = fold and self.route == "stack"
        fold_pool = fold and cfg.pooling_type == "attention"
        embed_spec = (code_rows(ids), blockdiag_table_t(tables),
                      tuple(t.shape[0] for t in tables)) if fold else None
        embT = None
        if not (fold_stack and fold_pool):
            embT = embed_concat_onehot_t(tables, ids, dtype=dt)
        W, b = self.embedding_projection.weight, self.embedding_projection.bias
        xs = cfg.x_self_dim
        rate = cfg.shell_conv_dropout
        if cfg.ffn_dropout > 0.0 and generator is None:
            raise ValueError("training with FFN dropout needs a generator")
        if rate > 0.0 and drop_seed is None:
            if generator is None:
                raise ValueError("training with dropout needs drop_seed or a generator")
            drop_seed = int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=generator,
                                          device=generator.device))
        if self.route == "stack":
            x_other = binned_mp_stack_train_t(
                embT, batch.bin_adj, [layer.stack_weights() for layer in self.message_passing_layers],
                dt, act=cfg.activation_type, dropout=rate, seed=drop_seed or 0,
                proj_weights=(W[xs:].T, b[xs:]), embed_spec=embed_spec if fold_stack else None,
            )
        else:
            x_other = act(mm32(W[xs:], embT, cdt).to(dt) + b[xs:].to(dt)[:, None])
            x_other = self._message_passing(batch, x_other, True, drop_seed)
        pm = batch.pool_mat
        attn = None
        if cfg.pooling_type == "attention":
            k_cs = self.concat_self_other.weight.T
            mol, attn = self.pooling.forward_train(
                embT, W[:xs].T, b[:xs], cfg.activation_type, x_other, pm,
                (k_cs, self.concat_self_other.bias), embed_spec if fold_pool else None,
            )
        else:
            x_self = act(mm32(W[:xs], embT, cdt).to(dt) + b[:xs].to(dt)[:, None])
            if cfg.pooling_type == "max":
                mol = binned_max_pool(self._atom_embeddings(x_self.T, x_other.T), pm)
            else:
                mol = self._linear_pool(x_self, x_other, pm)
        return self._head(mol, attn, None, self._charges(x_other), generator)

    def _forward_rows(self, batch: MolBatch, atom_embeddings: bool, train: bool,
                      generator: Optional[torch.Generator]) -> GNNOutput:
        """Serving and training forward on the row-major route, flat or
        binned (the module docstring; JAX ``GNN.__call__`` without
        ``t_path``), and on edge shards when the config has a graph axis."""
        cfg = self.config
        binned = batch.pool_mat is not None
        ax = mesh.axis(cfg.graph_axis) if cfg.graph_axis is not None else None
        if (ax is None and cfg.parity_mode
                and (batch.fused_fwd is None or batch.fused_bwd is None)):
            raise ValueError("a flat batch needs its edge layouts (data.batching.attach_flat_layouts)")
        layer_rate = cfg.shell_conv_dropout if cfg.num_message_passing_layers else 0.0
        if train and generator is None and max(layer_rate, cfg.ffn_dropout) > 0.0:
            raise ValueError("training with dropout needs a generator")
        gen = generator if train else None
        act = get_activation_function(cfg.activation_type)
        dt = self.compute_dtype
        cdt = dt if dt == torch.bfloat16 else None

        # 1-2. embeddings (A, 4*emb), projection and split, row-major
        tables = [getattr(self, f"{n}_embedding").weight for n in _EMBEDDINGS]
        emb = embed_concat_onehot(tables, [getattr(batch, n) for n in _EMBEDDINGS], dtype=dt)
        W, b = self.embedding_projection.weight, self.embedding_projection.bias
        xs = cfg.x_self_dim

        def proj_cols(w, bb):
            y = mm32(emb, w.T, cdt).to(dt) if cdt is not None else emb @ w.T
            return act(y + bb.to(y.dtype))

        x_self = proj_cols(W[:xs], b[:xs])  # (A, xs)
        x_other = proj_cols(W[xs:], b[xs:])  # (A, D)

        # 3. message passing
        x_other = self._rows_message_passing(batch, x_other, gen, ax)
        charges = x_other[:, 0].float() if cfg.use_partial_charges else None
        x_other = x_other.to(x_self.dtype)

        # 4. combine (atom-embedding tap) and pool
        pm, B = batch.pool_mat, batch.total_charge.shape[0]
        mol_id, mask = batch.atom_mol, batch.atom_mask
        k_cs, b_cs = self.concat_self_other.weight.T, self.concat_self_other.bias
        atom_emb = None
        if atom_embeddings or cfg.pooling_type == "max":
            atom_emb = self._atom_embeddings(x_self, x_other)
        attention_weights = None
        mean = cfg.pooling_type == "mean"
        if cfg.pooling_type == "attention":
            if binned:
                mol, attention_weights = self.pooling.forward_rows([x_self, x_other], pm,
                                                                   (k_cs, b_cs))
            else:
                mol, attention_weights = self.pooling.forward_flat([x_self, x_other], mol_id,
                                                                   mask, B, (k_cs, b_cs))
        elif cfg.pooling_type == "max":
            mol = binned_max_pool(atom_emb, pm) if binned else max_pool(atom_emb, mol_id, mask, B)
        elif binned:
            # the lane-aligned concat pooled at once, then the bias scaled by
            # each slot's coverage (mean) or atom count (sum)
            pool = binned_mean_pool if mean else binned_sum_pool
            counts = pm.sum(dim=2).reshape(-1)
            mol = pool_then_project([pool(torch.cat([x_self, x_other], -1), pm).T],
                                    counts > 0 if mean else counts, k_cs, b_cs, dt)
        else:
            # parts promoted to fp32 before the segment sums
            pool = mean_pool if mean else sum_pool
            counts = atom_counts(mol_id, mask, B)
            mol = pool_then_project([pool(p.float(), mol_id, mask, B).T for p in (x_self, x_other)],
                                    counts > 0 if mean else counts, k_cs, b_cs, dt)
        atom_emb = atom_emb.float() if atom_embeddings else None
        return self._head(mol, attention_weights, atom_emb, charges, gen)

    def _rows_message_passing(self, batch: MolBatch, x: torch.Tensor,
                              generator: Optional[torch.Generator],
                              ax: Optional[mesh.Axis] = None,
                              pool_ax: Optional[mesh.Axis] = None) -> torch.Tensor:
        """The row-major layers over x_other (A, D): per layer the
        injections of config 3, the layer, then the residual; a charge
        equilibration promotes x to fp32 from there on.  ``ax``, the graph
        axis, goes to the layers (``ShellConvolutionLayer``: on a halo shard
        each reads its remote sources from the halo exchange, on an edge
        shard it psums its partial aggregate); ``pool_ax``, the axis of the
        per-molecule sums (JAX's ``pool_axis``, set on halo shards only,
        whose atoms are split over the ranks), psums the charge sums and the
        stereo context's any-centre flag.  On edge shards the atoms are
        replicated, so a psum there would count every molecule G times."""
        cfg = self.config
        ctx = stereo_context(batch, pool_ax) if cfg.use_stereochemistry else None
        for layer in self.message_passing_layers:
            if cfg.use_partial_charges:
                x = charge_equilibration(x, batch, pool_ax)
            if ctx is not None:
                x = stereochemistry(x, *self._stereo_proj(), ctx, batch)
            x = _remat(cfg.remat, lambda x_, layer=layer: layer(x_, batch, generator, ax), x,
                       generator) + x
        return x

    def _halo_stack(self, batch: MolBatch, x_other: torch.Tensor, ax: mesh.Axis, rate: float,
                    drop_seed: Optional[int], generator: Optional[torch.Generator]
                    ) -> torch.Tensor:
        """The layers on a binned halo shard, feature-major (JAX
        ``use_halo_stack``): per layer the injections of config 3 (the
        segment charge equilibration psummed over the graph axis, the stereo
        injection on the pair lists), the halo exchange, the local per-bin
        aggregation plus the halo rows' contribution (ops/halo.py), kernel 5
        on ``[x ; agg]`` and the residual.  Returns x_other row-major (A, D)
        in its input dtype."""
        cfg = self.config
        dt = self.compute_dtype
        base = None
        if rate > 0.0:
            if drop_seed is None:
                drop_seed = int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=generator,
                                              device=generator.device))
            # the hash keys on local atom columns: fold the graph rank in
            base = (int(drop_seed) + ax.index + 2**31) % 2**32 - 2**31
        ctx = stereo_context(batch, ax) if cfg.use_stereochemistry else None
        xT = x_other.to(dt).T.contiguous()
        for l, layer in enumerate(self.message_passing_layers):
            if cfg.use_partial_charges:
                xT = charge_equilibration_t_seg(xT, batch, ax)
            if ctx is not None:
                xT = stereochemistry_t(xT, *self._stereo_proj(), ctx, batch)
            haloT = halo_exchange_t(xT, batch.halo_send_idx, ax)
            agg = binned_local_agg_t(xT, batch.bin_adj, dt)
            agg = agg + halo_agg_contrib_t(haloT, batch.halo_adj, dt)
            xa = torch.cat([xT, agg.to(dt)], dim=0)
            seed = layer_drop_seed(base, l) if base is not None else 0
            xT = _remat(cfg.remat, lambda xa_, w=layer.stack_weights(), seed=seed:
                        binned_mp_layer_ext_t(xa_, w, dt, cfg.activation_type, rate, seed),
                        xa) + xT
        return xT.T.to(x_other.dtype)

    def _forward_halo(self, batch: MolBatch, atom_embeddings: bool, train: bool,
                      drop_seed: Optional[int],
                      generator: Optional[torch.Generator]) -> GNNOutput:
        """Serving and training forward on a halo shard (the module
        docstring): binned shards in parity mode take the halo stack
        (kernel 5, JAX ``use_halo_stack``), flat shards and per-hop models
        the row-major halo route (JAX's layer loop with ``halo_send_idx``)."""
        cfg = self.config
        ax = mesh.axis(cfg.graph_axis or "graph")
        rate = cfg.shell_conv_dropout if train else 0.0
        if train and max(rate, cfg.ffn_dropout) > 0.0 and generator is None:
            raise ValueError("training with dropout needs a generator")
        act = get_activation_function(cfg.activation_type)
        dt = self.compute_dtype
        cdt = dt if dt == torch.bfloat16 else None

        # 1-2. embeddings, projection and split, row-major (A_loc, .)
        tables = [getattr(self, f"{n}_embedding").weight for n in _EMBEDDINGS]
        emb = embed_concat_onehot(tables, [getattr(batch, n) for n in _EMBEDDINGS], dtype=dt)
        W, b = self.embedding_projection.weight, self.embedding_projection.bias
        xs = cfg.x_self_dim

        def proj_cols(w, bb):
            y = mm32(emb, w.T, cdt).to(dt) if cdt is not None else emb @ w.T
            return act(y + bb.to(y.dtype))

        x_self = proj_cols(W[:xs], b[:xs])
        x_other = proj_cols(W[xs:], b[xs:])

        # 3. message passing
        if cfg.parity_mode and batch.bin_adj is not None and batch.halo_adj is not None:
            x_other = self._halo_stack(batch, x_other, ax, rate, drop_seed, generator)
        else:
            x_other = self._rows_message_passing(batch, x_other, generator if train else None,
                                                 ax, pool_ax=ax)
        charges = x_other[:, 0].float() if cfg.use_partial_charges else None
        x_other = x_other.to(x_self.dtype)

        # 4. atom embeddings, then pools psummed over the graph axis
        atom_emb = self._atom_embeddings(x_self, x_other)
        mol_id, mask, B = batch.atom_mol, batch.atom_mask, batch.total_charge.shape[0]
        attention_weights = None
        if cfg.pooling_type == "attention":
            mol, attention_weights = self.pooling.forward_halo(atom_emb, mol_id, mask, B, ax)
        else:
            pool = {"mean": mean_pool, "sum": sum_pool, "max": max_pool}[cfg.pooling_type]
            mol = pool(atom_emb, mol_id, mask, B, ax)
        atom_emb = atom_emb.float() if atom_embeddings else None
        return self._head(mol, attention_weights, atom_emb, charges, generator if train else None)

