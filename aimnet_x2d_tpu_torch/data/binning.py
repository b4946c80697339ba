"""Bin-packed batch layout (counterpart of aimnet_x2d_tpu/data/binning.py).

Molecules are packed whole, in order, into bins of ``ab`` atom slots.  Every
edge then lives inside one bin, so the message-passing aggregation becomes a
dense per-bin product with the int8 multiplicity matrix ``bin_adj`` and the
per-molecule pools become products with the membership matrix ``pool_mat``.
Molecule slots are ``bins x mb`` (molecule m of bin b is slot b*mb+m); the
order of molecules is preserved, so a masked selection of graph-level
outputs yields input order.

The functions here are copies of the JAX package's host code, so both
packages lay out identical batches: in-order packing for serving and
evaluation (outputs stay aligned with input rows), and size-descending
packing (``size_sort``) for training loaders, whose batch is a set of
molecules and packs tighter in that order.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from .batching import MolBatch, bucket_size

DEFAULT_AB = 256
DEFAULT_MB = 48


class BinningError(ValueError):
    """Batch cannot be bin-packed (e.g. a molecule exceeds ``ab`` atoms)."""


def adaptive_mb_cap(mol_sizes: np.ndarray, ab: int, mb: int) -> int:
    """Adaptive molecule cap: everything molecule-shaped (pooling matmuls,
    FFN, losses) scales with bins × mb_eff, and mb_eff is set by the
    single worst bin — a run of small molecules can inflate it well past
    the typical fill (observed 24 vs 14 mean on the synthetic flagship
    batch: 53% slot occupancy).  Capping packing at ~ab/median closes
    such bins early; for typical mixes it binds exactly when a bin is
    already ≳75% full by atoms, so the bin count is unchanged while the
    molecule axis shrinks (measured: same 2560 bins, 61440 → 40960 mol
    slots at the 32k flagship batch; a TPU measurement of the JAX package)."""
    sizes = mol_sizes[mol_sizes > 0]
    if sizes.size == 0:
        return mb
    med = max(float(np.median(sizes)), 1.0)
    cap = bucket_size(int(np.ceil(ab / med)), align=8)
    return min(mb, max(cap, 8))


def plan_bins(mol_sizes: np.ndarray, ab: int, mb: int):
    """Greedy in-order packing of whole molecules into (ab atoms, mb mols)
    bins.  Returns (bin_of_mol, local_of_mol, new_atom_start, num_bins)."""
    B = mol_sizes.shape[0]
    bin_of = np.zeros(B, np.int32)
    local = np.zeros(B, np.int32)
    start = np.zeros(B, np.int64)
    b, fill, nmols = 0, 0, 0
    for m in range(B):
        s = int(mol_sizes[m])
        if s > ab:
            raise BinningError(f"molecule of {s} atoms exceeds bin size {ab}")
        if fill + s > ab or nmols >= mb:
            b += 1
            fill = 0
            nmols = 0
        bin_of[m] = b
        local[m] = nmols
        start[m] = b * ab + fill
        fill += s
        nmols += 1
    return bin_of, local, start, b + 1


def tet_bin_tables(
    tet_nbrs: np.ndarray,
    tet_mask: np.ndarray,
    nb: int,
    ab: int,
    pins: "dict | None" = None,
    pins_lock=None,
) -> np.ndarray:
    """(nb, 4, Tc) int32 per-bin tetrahedral-center table from the FINAL
    (bin-space) tet rows: entry [b, k, t] = bin-local column of neighbor k
    of bin b's t-th center, -1 padding.  Shared by both binned builders so
    their ``tet_bin`` fields stay bit-exact; ``pins['tetb']`` pins Tc
    across batches (same static-shape contract as bins/mb)."""
    rows = np.asarray(tet_nbrs)
    mask = np.asarray(tet_mask)
    real = np.nonzero(mask)[0]
    bins = rows[real, 0] // ab if real.size else np.zeros(0, np.int64)
    order = np.argsort(bins, kind="stable")
    real, bins = real[order], bins[order]
    need = int(np.bincount(bins).max()) if real.size else 1
    tc = bucket_size(need, align=8)
    if pins is not None:
        with pins_lock if pins_lock is not None else contextlib.nullcontext():
            tc = max(tc, pins.get("tetb", 0))
            pins["tetb"] = tc
    out = np.full((nb, 4, tc), -1, np.int32)
    if real.size:
        slot = np.arange(real.size) - np.searchsorted(bins, bins)
        out[bins, :, slot] = rows[real] % ab
    return out


def plan_bin_counts(mol_sizes: np.ndarray, ab: int, mb: int):
    """(num_bins, max_mols_in_one_bin) of :func:`plan_bins`'s greedy
    packing without materializing the per-molecule plan — O(bins · log B)
    instead of a Python loop over molecules, so loaders can cheaply
    pre-plan many epochs of batches to seed their bin pins
    .  ``mb`` is the (already
    adaptive) molecule cap, as passed to plan_bins."""
    sizes = np.asarray(mol_sizes, np.int64)
    B = sizes.shape[0]
    if B == 0:
        return 1, 1
    if sizes.max() > ab:
        raise BinningError(
            f"molecule of {int(sizes.max())} atoms exceeds bin size {ab}"
        )
    cs = np.concatenate([[0], np.cumsum(sizes)])
    i, nb, mx = 0, 0, 0
    while i < B:
        j = int(np.searchsorted(cs, cs[i] + ab, side="right")) - 1
        j = min(j, i + mb)
        if j <= i:  # can't happen (sizes <= ab), defensive
            j = i + 1
        mx = max(mx, j - i)
        nb += 1
        i = j
    return nb, mx


def plan_bins_sorted(mol_sizes: np.ndarray, ab: int, mb: int):
    """:func:`plan_bins` on the size-descending order, the results mapped
    back to input molecule positions (training loaders only)."""
    sizes = np.asarray(mol_sizes)
    perm = np.argsort(-sizes, kind="stable")
    b_s, l_s, s_s, nbins = plan_bins(sizes[perm], ab, mb)
    bin_of = np.empty_like(b_s)
    local = np.empty_like(l_s)
    start = np.empty_like(s_s)
    bin_of[perm] = b_s
    local[perm] = l_s
    start[perm] = s_s
    return bin_of, local, start, nbins


def bin_pack_batch(
    batch: MolBatch,
    *,
    ab: int = DEFAULT_AB,
    mb: int = DEFAULT_MB,
    pins: dict | None = None,
    size_sort: bool = False,
) -> MolBatch:
    """Re-lay a collated batch into the binned layout and attach the dense
    per-bin aggregation/pooling matrices.

    ``pins`` (mutated) carries {"bins": n} so loaders keep one static shape;
    the bin count is bucket-laddered.  ``size_sort`` packs molecules in
    size-descending order (:func:`plan_bins_sorted`, training only) and
    regroups the edge and stereo rows into packed-molecule order, as the JAX
    package does.  Raises :class:`BinningError` when a molecule exceeds
    ``ab`` atoms.
    """
    amask = np.asarray(batch.atom_mask)
    amol = np.asarray(batch.atom_mol)
    B_real = int(np.asarray(batch.graph_mask).sum())
    A0 = batch.num_atom_slots
    mol_sizes = np.bincount(amol[amask], minlength=B_real)

    mb = adaptive_mb_cap(mol_sizes, ab, mb)
    if size_sort:
        bin_of, local, start, nbins = plan_bins_sorted(mol_sizes, ab, mb)
        mol_rank = np.empty(B_real, np.int64)
        mol_rank[np.argsort(-mol_sizes, kind="stable")] = np.arange(B_real)
    else:
        bin_of, local, start, nbins = plan_bins(mol_sizes, ab, mb)
        mol_rank = None

    nbins_padded = bucket_size(nbins, align=8)
    # molecule-slot axis sized to the OBSERVED max molecules per bin (not
    # the packing cap ``mb``): everything molecule-shaped — pooling matmuls,
    # FFN, losses — scales with bins×mb_eff, and the cap is ~2× looser than
    # reality for typical molecule-size mixes
    mb_eff = bucket_size(int(local.max()) + 1 if local.size else 1, align=8)
    if pins is not None:
        nbins_padded = max(nbins_padded, pins.get("bins", 0))
        pins["bins"] = nbins_padded
        mb_eff = max(mb_eff, pins.get("mb", 0))
        pins["mb"] = mb_eff
    A2 = nbins_padded * ab
    B2 = nbins_padded * mb_eff
    mb = mb_eff

    # old atom index -> new atom index (padding rows -> A2)
    starts0 = np.concatenate([[0], np.cumsum(mol_sizes)[:-1]])
    old2new = np.full(A0 + 1, A2, np.int64)
    total_atoms = int(mol_sizes.sum())
    within = np.arange(total_atoms) - np.repeat(starts0, mol_sizes)
    old2new[:total_atoms] = np.repeat(start, mol_sizes) + within
    new_atom = old2new[:total_atoms]

    def _scatter_atoms(arr, fill=0):
        out = np.full((A2,) + arr.shape[1:], fill, arr.dtype)
        out[new_atom] = arr[:total_atoms]
        return out

    mol_slot = (bin_of.astype(np.int64) * mb + local).astype(np.int32)

    atom_mol2 = np.full(A2, B2, np.int32)
    atom_mol2[new_atom] = mol_slot[amol[:total_atoms]]
    atom_mask2 = np.zeros(A2, bool)
    atom_mask2[new_atom] = True

    # --- edges: indices remapped; per-edge bin derivable from dst ---
    emask = np.asarray(batch.edge_mask)
    src2 = np.where(emask, old2new[np.asarray(batch.edge_src)], 0).astype(np.int32)
    dst2 = np.where(emask, old2new[np.asarray(batch.edge_dst)], A2).astype(np.int32)
    edge_hop2 = np.asarray(batch.edge_hop)
    emask2 = emask
    if mol_rank is not None:
        # real edges regrouped into packed-molecule order (stable within a
        # molecule), padding after them
        real = np.nonzero(emask)[0]
        emol = amol[np.asarray(batch.edge_dst)[real]]
        order = real[np.argsort(mol_rank[emol], kind="stable")]
        E_slots = src2.shape[0]
        ns = np.zeros(E_slots, np.int32)
        nd = np.full(E_slots, A2, np.int32)
        nh = np.zeros(E_slots, edge_hop2.dtype)
        nm = np.zeros(E_slots, bool)
        ns[: order.size] = src2[order]
        nd[: order.size] = dst2[order]
        nh[: order.size] = edge_hop2[order]
        nm[: order.size] = True
        src2, dst2, edge_hop2, emask2 = ns, nd, nh, nm

    # --- dense per-bin adjacency (multiplicity counts hop-duplicate edges,
    # preserving the union-over-hops Q1 semantics exactly) ---
    es, ed = src2[emask].astype(np.int64), dst2[emask].astype(np.int64)
    flat = (ed // ab) * (ab * ab) + (ed % ab) * ab + (es % ab)
    uniq, counts = np.unique(flat, return_counts=True)
    if counts.size and counts.max() > 127:
        raise BinningError(f"edge multiplicity {counts.max()} exceeds int8")
    adj = np.zeros(nbins_padded * ab * ab, np.int8)
    adj[uniq] = counts
    adj = adj.reshape(nbins_padded, ab, ab)

    # --- molecule-membership pooling matrix ---
    pool = np.zeros((nbins_padded, mb, ab), np.int8)
    pool[new_atom // ab, atom_mol2[new_atom] % mb, new_atom % ab] = 1

    # --- graph-level arrays into the slotted molecule space ---
    def _scatter_mols(arr, fill=0.0):
        out = np.full((B2,) + arr.shape[1:], fill, arr.dtype)
        out[mol_slot] = arr[:B_real]
        return out

    graph_mask2 = np.zeros(B2, bool)
    graph_mask2[mol_slot] = True

    def _remap_idx(ix):
        ix = np.asarray(ix)
        return old2new[np.clip(ix, 0, A0)].astype(np.int32)

    def _sorted_rows(rows, mask, width, blocks=1):
        """Remapped stereo rows regrouped into packed-molecule order (cis and
        trans keep their [originals | reversed] two-block structure)."""
        rows = np.asarray(rows)
        mask = np.asarray(mask)
        out = np.full((rows.shape[0], width), A2, np.int32)
        msk = np.zeros(rows.shape[0], bool)
        real = np.nonzero(mask)[0]
        if real.size == 0:
            return out, msk
        per = real.size // blocks
        pos = 0
        for b in range(blocks):
            blk = real[b * per : (b + 1) * per]
            rmol = amol[np.clip(rows[blk, 0], 0, A0 - 1)]
            order = blk[np.argsort(mol_rank[rmol], kind="stable")]
            out[pos : pos + order.size] = old2new[np.clip(rows[order], 0, A0)].astype(np.int32)
            msk[pos : pos + order.size] = True
            pos += order.size
        return out, msk

    if mol_rank is not None:
        tet_nbrs2, tet_mask2 = _sorted_rows(batch.tet_nbrs, batch.tet_mask, 4)
        cis2, cis_mask2 = _sorted_rows(batch.cis_pairs, batch.cis_mask, 2, blocks=2)
        trans2, trans_mask2 = _sorted_rows(batch.trans_pairs, batch.trans_mask, 2, blocks=2)
    else:
        tet_nbrs2 = np.where(
            np.asarray(batch.tet_mask)[:, None], _remap_idx(batch.tet_nbrs), A2
        ).astype(np.int32)
        tet_mask2 = np.asarray(batch.tet_mask)
        cis2 = np.where(
            np.asarray(batch.cis_mask)[:, None], _remap_idx(batch.cis_pairs), A2
        ).astype(np.int32)
        cis_mask2 = np.asarray(batch.cis_mask)
        trans2 = np.where(
            np.asarray(batch.trans_mask)[:, None], _remap_idx(batch.trans_pairs), A2
        ).astype(np.int32)
        trans_mask2 = np.asarray(batch.trans_mask)

    tet_bin = tet_bin_tables(tet_nbrs2, tet_mask2, nbins_padded, ab, pins=pins)

    return dataclasses.replace(
        batch,
        atom_type=_scatter_atoms(np.asarray(batch.atom_type)),
        hydrogen_count=_scatter_atoms(np.asarray(batch.hydrogen_count)),
        degree=_scatter_atoms(np.asarray(batch.degree)),
        hybridization=_scatter_atoms(np.asarray(batch.hybridization)),
        atom_mol=atom_mol2,
        atom_mask=atom_mask2,
        edge_src=src2,
        edge_dst=dst2,
        edge_hop=edge_hop2,
        edge_mask=emask2,
        total_charge=_scatter_mols(np.asarray(batch.total_charge)),
        targets=_scatter_mols(np.asarray(batch.targets)),
        graph_mask=graph_mask2,
        tet_nbrs=tet_nbrs2,
        tet_mask=tet_mask2,
        cis_pairs=cis2,
        cis_mask=cis_mask2,
        trans_pairs=trans2,
        trans_mask=trans_mask2,
        bin_adj=adj,
        pool_mat=pool,
        tet_bin=tet_bin,
        # both plans keep dst-major edge order: in-order packing remaps real
        # atoms monotonically, and the sorted plan regroups whole molecules
        edges_dst_sorted=batch.edges_dst_sorted,
    )
