"""Fixed-shape padded molecular batches (counterpart of
aimnet_x2d_tpu/data/batching.py).

``MolFeatures``, ``bucket_size`` and ``collate`` are copies of the JAX
package's host code (numpy only), so both packages build identical arrays
from identical molecules.  ``MolBatch`` is a plain dataclass of numpy arrays;
``MolBatch.to(device)`` hands the model a copy whose arrays are torch tensors.

A batch has one of two layouts: binned (data/binning.py: ``bin_adj``,
``pool_mat`` and ``tet_bin`` set) or flat, whose edge layouts for the
aggregation kernel (ops/fused_edge.py: ``fused_fwd`` keyed by destination,
``fused_bwd`` keyed by source) :func:`attach_flat_layouts` builds on the
host.  The fields of the other layout are None.  :func:`shard_edges` cuts a
batch into edge shards for the edge-replicated graph mode.

Padding convention: padded edges point at atom slot ``A`` and padded atoms
at graph slot ``B`` (one past the end); boolean masks mark real entries.
Cis/trans pairs are appended again in reversed order (quirk Q7) and only
4-neighbour chiral centres are kept, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.fused_edge import EdgeLayout, build_layouts


@dataclasses.dataclass
class MolFeatures:
    """Host-side featurizer output for one molecule (ragged, numpy).

    Equivalent content to the reference's ``compute_all`` dict
    (reference: src/datasets/features.py:325-334).
    """

    edge_hops: list  # list over hops of (2, E_h) int32 [src_row0, dst_row1]? see note
    atom_type: np.ndarray  # int (N,)
    hydrogen_count: np.ndarray
    degree: np.ndarray
    hybridization: np.ndarray
    tet_nbrs: np.ndarray  # (C, 4) int32 — neighbor indices of chiral centers
    cis_pairs: np.ndarray  # (P, 2) int32 directed pairs
    trans_pairs: np.ndarray  # (Q, 2) int32
    total_charge: float
    atomic_numbers: np.ndarray  # int32 (N,)
    smiles: str = ""

    @property
    def num_atoms(self) -> int:
        return int(self.atom_type.shape[0])

    @property
    def num_edges(self) -> int:
        return int(sum(e.shape[1] for e in self.edge_hops))


@dataclasses.dataclass
class MolBatch:
    """A padded, fixed-shape batch of molecular graphs.

    Field meanings follow the JAX package's ``MolBatch``: ``edge_dst`` is the
    aggregation target and ``edge_src`` the gathered atom.  On the binned
    layout (data/binning.py) atoms are laid out bins x ab and molecules
    bins x mb; ``bin_adj[b, i, j]`` counts the edges j -> i inside bin b and
    ``pool_mat[b, m, a]`` marks atom a of bin b as a member of the bin's
    m-th molecule.
    """

    # Atom-level int features, shape (A,)
    atom_type: np.ndarray
    hydrogen_count: np.ndarray
    degree: np.ndarray
    hybridization: np.ndarray
    atom_mol: np.ndarray  # (A,) graph id; padding -> B
    atom_mask: np.ndarray  # (A,) bool

    # Edge-level, shape (E,)
    edge_src: np.ndarray  # padding -> 0
    edge_dst: np.ndarray  # padding -> A
    edge_hop: np.ndarray  # 1..K for real edges, 0 for padding
    edge_mask: np.ndarray

    # Graph-level, shape (B, ...)
    total_charge: np.ndarray  # (B,) float32
    targets: np.ndarray  # (B, T) float32
    graph_mask: np.ndarray  # (B,) bool

    # Stereochemistry
    tet_nbrs: np.ndarray  # (C, 4) int32; padding rows -> A
    tet_mask: np.ndarray
    cis_pairs: np.ndarray  # (P, 2) int32 [src, dst]; padding -> A
    cis_mask: np.ndarray
    trans_pairs: np.ndarray
    trans_mask: np.ndarray

    edges_dst_sorted: bool = False

    # Binned layout (data/binning.py); None on flat batches.
    bin_adj: Optional[np.ndarray] = None  # (nb, ab, ab) int8
    pool_mat: Optional[np.ndarray] = None  # (nb, mb, ab) int8
    tet_bin: Optional[np.ndarray] = None  # (nb, 4, Tc) int32

    # Flat layout (attach_flat_layouts); None on binned batches.
    fused_fwd: Optional[EdgeLayout] = None  # CSR keyed by destination
    fused_bwd: Optional[EdgeLayout] = None  # CSR keyed by source

    # Halo shards (parallel/halo.py); None on ordinary batches.
    # halo_send_idx (G, Hp) int32: row g lists the local atoms this shard
    # sends to graph rank g, -1 pads.  halo_adj (G*Hp, A_loc) int8 counts the
    # edges from each halo row to each local atom (binned shards: every edge
    # not in bin_adj, so the two cover each edge once).
    halo_send_idx: Optional[np.ndarray] = None
    halo_adj: Optional[np.ndarray] = None

    @property
    def num_atom_slots(self) -> int:
        return self.atom_type.shape[-1]

    @property
    def num_graph_slots(self) -> int:
        return self.total_charge.shape[-1]

    def to(self, device: "str | torch.device", copy=None) -> "MolBatch":
        """Copy with every array or tensor field (and the edge layouts'
        arrays) as a torch tensor on ``device``; ``copy`` (a tensor -> its copy on
        the device), when given, makes each copy instead of ``.to(device)``
        (the train loop's prefetch copies on a stream of its own)."""
        copy = copy or (lambda t: t.to(device))
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v = copy(torch.from_numpy(np.ascontiguousarray(v)))
            elif isinstance(v, torch.Tensor):
                v = copy(v)
            elif isinstance(v, EdgeLayout):
                v = v.to(device, copy)
            out[f.name] = v
        return MolBatch(**out)


def stack_batches(batches: Sequence[MolBatch]) -> MolBatch:
    """Stack equal-shape host batches on a new leading axis (the graph- or
    data-rank axis); fields that are not arrays come from the first.
    Kernel-7 layouts differ from batch to batch and do not stack: batches
    that carry them raise (a stacked shard would read the first's)."""
    out = {}
    for f in dataclasses.fields(MolBatch):
        vals = [getattr(b, f.name) for b in batches]
        if any(isinstance(v, EdgeLayout) for v in vals):
            raise ValueError("flat batches with kernel-7 layouts do not stack; attach the "
                             "layouts to each shard after indexing (attach_flat_layouts)")
        out[f.name] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals[0]
    return MolBatch(**out)


def index_batch(batch: MolBatch, *idx: int) -> MolBatch:
    """The shard ``batch[idx]`` of a stacked host batch, every array field
    indexed on its leading axes."""
    return MolBatch(**{f.name: (v[idx] if isinstance(v, np.ndarray) else v)
                       for f in dataclasses.fields(MolBatch)
                       for v in [getattr(batch, f.name)]})


# Bucket ladder: smallest power-of-two-ish size >= n, aligned to TPU lanes.
_DEFAULT_ALIGN = 8


def bucket_size(n: int, align: int = _DEFAULT_ALIGN, ladder: Sequence[float] = (1.0, 1.25, 1.5, 1.75)) -> int:
    """Round ``n`` up to a small set of bucket sizes to bound recompiles.

    Buckets are {m * 2^k} for m in ``ladder``, aligned to ``align``.
    """
    if n <= align:
        return align
    k = int(np.ceil(np.log2(n)))
    candidates = []
    for kk in (k - 1, k):
        for m in ladder:
            c = int(m * (1 << kk))
            c = ((c + align - 1) // align) * align
            if c >= n:
                candidates.append(c)
    return min(candidates)


def collate(
    mols: Sequence[MolFeatures],
    targets: np.ndarray,
    *,
    num_hops: int,
    atom_slots: int | None = None,
    edge_slots: int | None = None,
    graph_slots: int | None = None,
    tet_slots: int | None = None,
    pair_slots: int | None = None,
    sort_edges: bool = True,
) -> MolBatch:
    """Collate ragged per-molecule features into one padded MolBatch.

    ``targets`` has shape (len(mols), T).  Slot counts default to bucketed
    sizes derived from the actual totals; pass explicit values for a fully
    static training shape.
    """
    B = len(mols)
    targets = np.asarray(targets, dtype=np.float32)
    if targets.ndim == 1:
        targets = targets[:, None]

    n_atoms = np.array([m.num_atoms for m in mols], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(n_atoms)[:-1]])
    total_atoms = int(n_atoms.sum())

    A = atom_slots or bucket_size(total_atoms)
    Bslots = graph_slots or B
    if A < total_atoms:
        raise ValueError(f"atom_slots={A} < total atoms {total_atoms}")
    if Bslots < B:
        raise ValueError(f"graph_slots={Bslots} < batch {B}")

    def _cat(key):
        if not mols:  # empty device shard (short final chunk)
            return np.zeros(0, np.int32)
        return np.concatenate([getattr(m, key) for m in mols]).astype(np.int32)

    atom_type = np.zeros(A, np.int32)
    hydrogen_count = np.zeros(A, np.int32)
    degree = np.zeros(A, np.int32)
    hybridization = np.zeros(A, np.int32)
    atom_type[:total_atoms] = _cat("atom_type")
    hydrogen_count[:total_atoms] = _cat("hydrogen_count")
    degree[:total_atoms] = _cat("degree")
    hybridization[:total_atoms] = _cat("hybridization")

    atom_mol = np.full(A, Bslots, np.int32)
    atom_mol[:total_atoms] = np.repeat(np.arange(B, dtype=np.int32), n_atoms)
    atom_mask = np.zeros(A, bool)
    atom_mask[:total_atoms] = True

    # --- edges: concat across molecules and hops, offset atom ids ---
    srcs, dsts, hops = [], [], []
    for i, m in enumerate(mols):
        off = offsets[i]
        for h in range(num_hops):
            if h < len(m.edge_hops) and m.edge_hops[h].shape[1] > 0:
                e = m.edge_hops[h]
                # Reference convention: row 0 = origin atom (message target),
                # row 1 = the h-hop neighbor (message source).
                dsts.append(e[0] + off)
                srcs.append(e[1] + off)
                hops.append(np.full(e.shape[1], h + 1, np.int32))
    if srcs:
        src = np.concatenate(srcs).astype(np.int32)
        dst = np.concatenate(dsts).astype(np.int32)
        hop = np.concatenate(hops)
    else:
        src = np.zeros(0, np.int32)
        dst = np.zeros(0, np.int32)
        hop = np.zeros(0, np.int32)

    total_edges = src.shape[0]
    E = edge_slots or bucket_size(max(total_edges, 1))
    if E < total_edges:
        raise ValueError(f"edge_slots={E} < total edges {total_edges}")

    if sort_edges and total_edges > 0:
        # Sort dst-major (hop minor): the parity-mode union-of-hops
        # aggregation keys on dst alone, so globally nondecreasing dst lets
        # the TPU segment sum take the sorted path.
        order = np.lexsort((hop, dst))
        src, dst, hop = src[order], dst[order], hop[order]

    edge_src = np.zeros(E, np.int32)
    edge_dst = np.full(E, A, np.int32)
    edge_hop = np.zeros(E, np.int32)
    edge_mask = np.zeros(E, bool)
    edge_src[:total_edges] = src
    edge_dst[:total_edges] = dst
    edge_hop[:total_edges] = hop
    edge_mask[:total_edges] = True

    # --- graph-level ---
    total_charge = np.zeros(Bslots, np.float32)
    total_charge[:B] = np.array([m.total_charge for m in mols], np.float32)
    T = targets.shape[1]
    tgt = np.zeros((Bslots, T), np.float32)
    tgt[:B] = targets
    graph_mask = np.zeros(Bslots, bool)
    graph_mask[:B] = True

    # --- stereochemistry ---
    tet_rows = []
    for i, m in enumerate(mols):
        if m.tet_nbrs.size:
            # keep only exactly-4-neighbor centers (reference:
            # src/datasets/molecular.py:365)
            t = m.tet_nbrs
            if t.ndim == 2 and t.shape[1] == 4:
                tet_rows.append(t + offsets[i])
    tet = np.concatenate(tet_rows).astype(np.int32) if tet_rows else np.zeros((0, 4), np.int32)
    C = tet_slots or bucket_size(max(tet.shape[0], 1))
    tet_nbrs = np.full((C, 4), A, np.int32)
    tet_mask = np.zeros(C, bool)
    tet_nbrs[: tet.shape[0]] = tet
    tet_mask[: tet.shape[0]] = True

    def _pairs(key):
        rows = []
        for i, m in enumerate(mols):
            p = getattr(m, key)
            if p.size:
                rows.append(p.reshape(-1, 2) + offsets[i])
        arr = np.concatenate(rows).astype(np.int32) if rows else np.zeros((0, 2), np.int32)
        # Reference appends reversed copies again (quirk Q7;
        # src/datasets/molecular.py:388-397): each directed pair appears twice.
        if arr.shape[0]:
            arr = np.concatenate([arr, arr[:, ::-1]])
        return arr

    cis = _pairs("cis_pairs")
    trans = _pairs("trans_pairs")
    P = pair_slots or bucket_size(max(cis.shape[0], trans.shape[0], 1))
    if P < max(cis.shape[0], trans.shape[0]):
        raise ValueError("pair_slots too small")

    def _pad_pairs(arr):
        out = np.full((P, 2), A, np.int32)
        msk = np.zeros(P, bool)
        out[: arr.shape[0]] = arr
        msk[: arr.shape[0]] = True
        return out, msk

    cis_pairs, cis_mask = _pad_pairs(cis)
    trans_pairs, trans_mask = _pad_pairs(trans)

    return MolBatch(
        atom_type=atom_type,
        hydrogen_count=hydrogen_count,
        degree=degree,
        hybridization=hybridization,
        atom_mol=atom_mol,
        atom_mask=atom_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_hop=edge_hop,
        edge_mask=edge_mask,
        total_charge=total_charge,
        targets=tgt,
        graph_mask=graph_mask,
        tet_nbrs=tet_nbrs,
        tet_mask=tet_mask,
        cis_pairs=cis_pairs,
        cis_mask=cis_mask,
        trans_pairs=trans_pairs,
        trans_mask=trans_mask,
        edges_dst_sorted=bool(sort_edges),
    )


def shard_edges(batch: MolBatch, num_shards: int) -> list:
    """Split a batch's edges into ``num_shards`` contiguous slices of
    ``ceil(E / num_shards)`` for edge-replicated execution (the JAX
    package's ``shard_edges``): every atom, graph and stereo array is
    replicated on each shard, the edge count is padded to a multiple of
    ``num_shards`` (sources 0, destinations A, hop 0, mask False), and each
    layer sums its shard's partial aggregate over the graph axis
    (models/layers.py).  The shards carry no kernel-7 layouts: those
    describe every edge of the batch, so a shard reading them would count
    each edge ``num_shards`` times after the sum."""
    E = batch.edge_src.shape[0]
    A = batch.num_atom_slots
    per = -(-E // num_shards)
    pad = per * num_shards - E

    def _pad_edge(arr, fill):
        return np.pad(arr, (0, pad), constant_values=fill) if pad else arr

    src = _pad_edge(batch.edge_src, 0)
    dst = _pad_edge(batch.edge_dst, A)
    hop = _pad_edge(batch.edge_hop, 0)
    mask = _pad_edge(batch.edge_mask, False)
    shards = []
    for s in range(num_shards):
        sl = slice(s * per, (s + 1) * per)
        shards.append(dataclasses.replace(batch, edge_src=src[sl], edge_dst=dst[sl],
                                          edge_hop=hop[sl], edge_mask=mask[sl],
                                          fused_fwd=None, fused_bwd=None))
    return shards


def attach_flat_layouts(batch: MolBatch) -> MolBatch:
    """A copy of the flat ``batch`` with its edge layouts for the
    aggregation kernel, built on the host with numpy (the JAX package's
    ``attach_fused_layouts``; every batch size gets them)."""
    fwd, bwd = build_layouts(batch.edge_src, batch.edge_dst, batch.edge_mask,
                             batch.num_atom_slots)
    return dataclasses.replace(batch, fused_fwd=fwd, fused_bwd=bwd)
