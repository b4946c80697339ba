#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aimnet_x2d_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--molecules N]

Phases, each of which fails the run when it fails:

1. print the card's name and power limit, and ``[deps]``: whether ``h5py``
   and ``yaml`` import (the HDF5 phases run only where ``h5py`` does; a
   skipped phase prints why); turn TF32 off for fp32 products;
2. build the CUDA kernels from ``aimnet_x2d_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source, all at once) and, beside them, the native
   featurizer and batch builder from ``native/*.cpp`` (g++ into
   ``build/native/``); ``[native]``: the native featurizer against the
   pure-Python one, array for array, on the first 512 SMILES, the first
   512 with stereo content and 8 molecules of 260-600 atoms (host times on
   1 and FEAT_THREADS threads), and one 2048-molecule binned batch of the
   native builder against the Python collate + bin-pack (host times); the
   script's datasets are then featurized natively on FEAT_THREADS threads;
3. ``[kernel]``: hold each serving kernel against its plain PyTorch version
   at the flagship serving shapes (a batch of 2048 molecules of the
   script's SMILES), in fp32 and bf16, and time kernel, plain version and
   library yardstick; the stack (kernel 1) reruns bit-equal, is timed as
   profiler device time by kernel name beside a CUDA-graph replay, and
   must run the tile kernel in bf16 and the kernel of one block a bin in
   fp32; the weighted pool (kernel 2) also on a pool matrix
   that is not one-hot, bit-equal on a rerun, timed as device time from
   ``torch.profiler`` in turns with its library call (an einsum that
   weights inside the call), beside the event time of back-to-back calls
   and the wrapper's host time per call;
4. ``[serve]``: write a flagship artifact (hidden 512, bf16, random weights
   from the seed, fitted scaler), run a CSV of the script's SMILES through
   the port's CLI on ``cuda`` with the launch counters reset just before,
   check every row is present and finite and both kernels ran, and compare
   one batch with the same model run on the CPU (plain versions);
   ``[mc-serve]``: the flagship with dropout 0.05 serves 2048 SMILES
   through the CLI with ``--mc_samples 8``: kernel 1's training form and
   kernel 3's forward launch 8 times, no serving or backward kernel, the
   outputs finite with std > 0; one sample at a fixed drop_seed with
   ffn_dropout 0 against the CPU plain versions (E2E_TOL); one sample's
   and one deterministic forward's CUDA-event time on the 2048 batch;
   ``[evid-serve]``: an evidential flagship artifact through the CLI with
   ``--inference_mode evidential`` (serving kernels 1 and 2), the four
   columns per target against the CPU run (E2E_TOL), uncertainties finite
   and positive; ``[rank-serve]``: ``[serve]``'s artifact and CSV served by
   ``python -m torch.distributed.run --nproc_per_node 2 -m
   aimnet_x2d_tpu_torch.cli`` (two gloo ranks sharing the card, each a
   contiguous half of the CSV, rank 0 merging): every rank exits 0, every
   row in input order, no rank file left, within E2E_TOL of ``[serve]``'s
   output, mol/s by rank beside ``[serve]``'s; ``[embed-serve]``:
   ``predict(..., return_embeddings=True)`` with ``[serve]``'s artifact over
   its SMILES on the card, the predictions bit-equal to the call without
   embeddings, molecule and atom embeddings of the first 256 within
   E2E_TOL of the CPU's plain run and their molecule index equal, mol/s with
   and without; where ``h5py`` imports also the CLI's ``--save_embeddings
   --include_atom_embeddings`` file, read back;
5. ``[train-kernel]``: hold each training kernel (stack forward with
   dropout and the projection fold, stack backward, attention pool forward
   and backward) against its plain version at the flagship training shapes
   (a size-sorted batch of 2048), bf16, and time kernel and plain version;
   the stack forward reruns bit-equal, is timed as in phase 3 (the tile
   kernel's route asserted), equals the serving form bit for bit without
   dropout, and is split by phase (the kernel of one block a bin and the
   tile kernel) by an instrumented build of ``csrc/mp_stack.cu``
   (``-DMP_STACK_MARKS``, built beside the kernels in phase 2), with the
   tile kernel's waits on its weight ring;
   the stack backward (kernel 1b) and the attention pool's backward (kernel
   3) also rerun bit-equal, timed as profiler device time split by part
   (walk or pool kernel, contraction, partial sums, fold) with the wrapper's
   host time and a CUDA-graph replay; 1b's fp32 form checked and timed; the
   pool's backward kernels split by phase by an instrumented build of
   ``csrc/attnpool.cu`` (``-DATTNPOOL_MARKS``, built beside the kernels in
   phase 2); bf16 must run the tiled kernel with one grouped contraction;
   the projection fold's backward (kernel 1c, ``mp_stack_bwd_proj``) alone,
   from a cotangent of x0: against its plain version, rerun bit-equal, timed
   as 1b's, its route (bf16: the wgmma kernel), and its kernels -- the one
   of a block a bin and the wgmma kernel -- split by phase by an
   instrumented build of ``csrc/mp_stack_bwd.cu`` (``-DMP_STACK_BWD_MARKS``);
6. ``[train]``: train the flagship model (bf16, dropout 0.05, 12 synthetic
   targets from the seed) through the port's CLI at batch 2048 with the
   launch counters reset just before; then 24 steps of the train step on
   card-resident batches, timed, with a falling loss, launches per step and
   a profiler breakdown of one step; then one step on a small batch on the
   card and on the CPU (plain versions) from the same weights, both
   backpropagating the CPU's cotangent of the loss, all gradients compared;
   ``[prefetch]`` (between the CLI and the timed steps): the train loop's
   input pipeline (``trainer.prefetch_batches``, pinned copies on a stream
   of their own, the native builder's scratch rotated in pinned sets): per
   CLI epoch the main thread's wait on the device queue, the copy stream's
   time and the host ms a step, beside the parent's; epoch 0's batches
   through it equal to the serial loader's (batch 2048 and 256); ``train``'s
   first two epochs' losses bit-equal to a serial loop's;
   ``[hyperopt]``: the CLI's search (``--hyperparameter_file
   example_hyperparams.yaml --num_trials 3 --epochs 2 --mixed_precision``,
   seed HYPEROPT_SEED: hidden 256 and 384, both pooling types) on
   ``[train]``'s CSV, every trial ok with finite losses, each trial's
   configuration, seconds and kernel launches printed, the best artifact
   reloaded and served on the card within E2E_TOL of the CPU;
   ``[hdf5-train]`` (``--iterable_dataset`` on the same CSV, 2 epochs, a
   falling loss) and ``[hdf5-serve]`` (``--inference_hdf5`` on its test
   file equal to ``--inference_csv`` on the same molecules), where ``h5py``
   imports;
7. config 3 (partial charges + stereochemistry, BASELINE.json config 3) at
   the flagship width, on SMILES of which about half carry a tetrahedral
   centre or a cis/trans double bond:
   - ``[c3-kernel]``: the inject kernels (kernel 4, forward and backward)
     and kernel 1d (serving form, training form, backward) against their
     plain versions at the config-3 training shape, bf16, timed, with
     bounds (1d's forwards rerun bit-equal and are timed as the stack's in
     phase 3; 1d's backward as 1b's in phase 5, fp32 form included); the
     inject forward (the tiled kernel, x' rows equal to the plain
     version's) and the inject backward (the cast of its cotangent, the
     kernel -- the tiled one -- and d_kb, d_b from the grouped contraction)
     rerun bit-equal and timed as profiler device time split by kernel name,
     and kernel 4's forward and backward kernels, old and tiled, split by
     phase by an instrumented build of ``csrc/inject.cu``
     (``-DINJECT_MARKS``, built beside the kernels in phase 2); the batch
     must hold tetrahedral centres and cis/trans pairs;
   - ``[c3-serve]``: phase 4 for a config-3 artifact (counters of the
     inject kernel, kernel 1d and the pool; the multi-layer stack must
     not run);
   - ``[c3-routes]``: one batch of config 3, charges only, stereo only and
     a 1-layer model on the card and on the CPU, each route launching its
     own kernels;
   - ``[c3-train]``: phase 6 for config 3, the CLI writing the test split's
     partial charges too, 12 timed steps;
8. config 1 (BASELINE.json config 1 at the CLI defaults: 1 shell, mean
   pooling, 1 target, bf16, dropout 0.05), on its own 1-shell featurization
   of the flagship's SMILES:
   - ``[c1-kernel]``: the weighted pool's backward (kernel 2b, dx and dw)
     against its plain version, fp32 and bf16, D 359 and 153, the training
     batch's mb, two mb that are not multiples of 16 and a pool matrix
     that is not one-hot, w = 1 and a random w on the real atoms, reruns
     bit-equal; timed at the training batch without dw (as mean and sum
     pooling run it, beside its library call, an einsum that weights
     inside the call) and with dw, each with its own bound, device time
     as in phase 3;
   - ``[c1-serve]``: phase 4 for a config-1 artifact;
   - ``[c1-train]``: phase 6 for config 1; the weighted pool's kernels run,
     the attention pool's never;
   - ``[c1-finetune]``: the CLI again, from ``[c1-train]``'s artifact to a
     12-target head with ``--transfer_learning --freeze_pretrained
     --layer_wise_lr_decay --checkpoint_dir --checkpoint_every 1``, 2
     epochs: every frozen tensor bit-equal to the transferred one, the head
     moved; then the same command with ``--epochs 3`` resumes after epoch 1;
   - ``[pool-routes]``: one batch through sum- and max-pool models, served
     and one train step, card against CPU, each launching only its route's
     kernels (no weighted pool for max);
9. the flat layout: the flagship on the script's SMILES with 1 in 100
   replaced by a molecule of 260-600 atoms with hydrogens (a linear alkane,
   a PEG chain or a glycine peptide), so every batch holds a molecule
   larger than a 256-atom bin and goes flat:
   - ``[flat-kernel]``: the edge aggregation (kernel 7, forward on the
     destination-keyed layout and backward on the source-keyed one) and
     the windowed segment sum (kernel 8) against their plain versions on
     the flat serving batch, D 153 and 359, fp32 and bf16, each twice
     (bit-equal), kernel 7's route; each form as profiler device
     time beside a CUDA-graph replay, the main path's with bounds and the
     library yardsticks (``torch.sparse.mm`` of the batch's multiplicity
     adjacency; ``index_add_``); both split by phase by an instrumented
     build of ``csrc/fused_edge.cu`` (``-DFUSED_EDGE_MARKS``); then kernel
     8's op driven once as its caller would, on the batch's edges (it lies
     on no model path, in either package);
   - ``[flat-serve]``: phase 4 on the first 2048 of those SMILES (one
     batch): kernel 7 launches 3 times per batch (its launches by route
     printed) and no binned kernel launches; card against CPU on 128
     molecules that hold 2 large ones;
   - ``[flat-train]``: phase 6 on them: kernel 7 launches 3 times forward
     and 3 times backward per step (launches by route printed), no binned
     kernel launches; the one step
     card against CPU runs with both dropouts off (the flat layers draw
     their masks from a generator);
   - ``[synthetic]``: ``data/synthetic.make_synthetic_batch`` (2048 ring
     molecules with stereo rows) with kernel 7's layouts, served at the
     flagship's widths on the card (kernel 7 three times) against the same
     forward on the CPU, E2E_TOL;
10. true per-hop aggregation (``--true_multi_hop``, the row-major route on
   binned batches):
   - ``[pool6-kernel]``: kernel 6 (``bin_pool_fwd``, ``bin_pool_bwd``: the
     binned attention pool of row-major arrays) against its plain version
     at the flagship training shape on the loader's pool matrix, fp32 and
     bf16, timed with the byte bound; each direction reruns bit-equal, is
     timed as profiler device time beside a CUDA-graph replay, must run on
     64-atom tiles (the route counts), and is split by phase, the kernel of
     one block a bin and the tiles, by an instrumented build of
     ``csrc/bin_pool.cu`` (``-DBIN_POOL_MARKS``, built beside the kernels);
     the kernels of one block a bin are held against their plain versions
     through the wrappers at ab 768, where the tiles do not go;
   - ``[mh-serve]``: phase 4 for the flagship with per-hop aggregation:
     kernel 6 launches, no stack, layer, inject, attention-pool,
     weighted-pool or edge kernel;
   - ``[mh-train]``: phase 6 for it, ``--true_multi_hop`` on the CLI;
     kernel 6 forward and backward once a step, none of those others;
11. ``[c3-flat]``: config 3 on the flat layout, on the script's SMILES with
   stereo content, 1 in 100 replaced by a molecule larger than a bin (so
   every split of the CLI's training holds one and goes flat): phase 4 on
   the first 2048 (``[c3-flat-serve]``) and phase 6 with ``--output_partial_charges``
   (``[c3-flat-train]``); kernel 7 launches 3 times forward (and 3
   backward per step), no binned kernel;
12. the embedding fold (``AIMNET_EMBED_FOLD=1``, kernel 1c-vocab), run
   right after the phases it rides on:
   - ``[fold-kernel]`` (after phase 5): the four folded kernels
     (``mp_stack_fwd_train_vocab``, ``mp_stack_bwd_vocab``,
     ``attnpool_fwd_vocab``, ``attnpool_bwd_vocab``) against their plain
     versions at the flagship training shapes on the batch's own codes,
     fp32 and bf16, timed with bounds; each backward twice, bit-equal; the
     stack's forward equal to the emb form's bit for bit and timed as in
     phase 3; the projection's and the pool's backwards timed as in phase 5
     and, in bf16, split by phase, the projection's on the wgmma kernel
     (its route counts);
   - ``[fold-train]`` (after phase 6): phase 6 with the switch set in the
     CLI's environment: the folded kernels launch once a step and the
     stack's and pool's emb forms never; then, on one batch, the training
     forward with the switch on against off (bit-equal) and the step in
     blocks off, on, on, off: host-clock medians, launches and device time;
   - ``[fold-routes]`` (after phase 8): one config-3 and one config-1 train
     step under the switch, card against CPU; the pool folds only for
     config 3, the stack only for config 1;
13. halo graph-partitioned training (``--graph_shards``), ranks sharing the
   one card over gloo:
   - ``[halo-kernel]``: kernel 5 (``mp_ext_fwd`` serving and training
     forms, ``mp_ext_bwd``) against its plain version on one graph rank's
     share of a 2048-molecule training batch (G 2), fp32 and bf16, the
     backward twice (bit-equal), timed with bounds, the backward as
     profiler device time split by kernel name: bf16 launches the stack's
     walk, fp32 the slab kernel, each one grouped contraction and one
     partial sum a call and no split-K ``wgrad``; the forward's forms rerun
     bit-equal, are timed as profiler device time beside a CUDA-graph
     replay, must run the wgmma kernel in bf16 and the kernel of one block a
     tile in fp32 (the route counts), and the bf16 training form is split by
     phase -- the old kernel by product and epilogue, the wgmma kernel's
     warpgroups by waits, products, epilogues and store -- by an
     instrumented build of ``csrc/mp_ext.cu`` (``-DMP_EXT_MARKS``);
   - ``[halo-step]``: one train step of 4 ranks (data 2 x graph 2) on
     halo shards of the flat SMILES (their large molecules chunked, so
     ``halo_adj`` carries cross-bin rows), bf16 and fp32: loss and
     gradients against the single-rank step on the same molecules, and
     parameters bit-identical across the ranks;
   - ``[c3-halo-step]``, in the same start of the 4 ranks: config 3 (both
     features) on binned halo shards of the stereo SMILES and a 197-atom
     stereo molecule the cut splits, bf16 and fp32, against the
     single-rank step on the binned layout; kernel 5 (3, 3) a rank, kernel
     4 never;
   - ``[edge-step]``, in the same start of the 4 ranks: the flagship on
     edge shards (``BatchLoader(stack_devices=2, edge_shards=2)``, JAX's
     edge-replicated mode: every atom on both graph ranks, half the edges
     on each, each layer's partial aggregate psummed) of 512 flat SMILES a
     data rank, bf16 and fp32, against the single-rank flat step (kernel
     7); no kernel on the ranks, kernel 7 never; then each rank's host ms
     a step (``utils/profiling.StepTimer``) and one step's device ms from
     the ``utils/profiling.trace`` file it writes (missing or empty fails);
   - ``[halo-train]``: the flagship CLI with ``--graph_shards 2`` on 2 ranks
     (as ``torchrun`` runs it), 3 epochs at batch 2048: kernel 5's
     launches summed over the ranks, then timed steps per rank (host and
     device ms), then the artifact served by the single-rank ``run_csv``;
     ``[c3-halo-train]``, in the same start of the 2 ranks: the same for
     config 3 on ``[c3-train]``'s CSV (a falling loss, kernel 4 never), 4
     timed steps; ``[rows-halo-step]``, in the first group: one serving
     forward of 2 flat halo shards (the row-major halo route) of the flat
     SMILES' largest molecule, which the cut splits, and the molecules
     after it, against the one-rank forward (kernel 7), E2E_TOL;
14. print the ``[bwd-record]`` line, the script's total seconds (the backward forms of kernels 1b, 1d,
   3, 1c-vocab's pool, 4 and 5, kernel 4's forward and the stack's forward
   forms -- kernels 1, 1d and 1c-vocab's stack site: device time, split,
   host time; the ``[train]``, ``[c3-train]``, ``[c1-train]``
   and ``[fold-train]`` steps' device times), the ``kernels`` JSON line, the
   card line and, last, the result line ``{"ok": true, "device": {...}}``.
   Each row of the kernels line names how its times were taken in
   ``timing``: "events" (CUDA events around back-to-back calls from
   Python, host gaps included), "profiler" (the kernels' device time from
   ``torch.profiler``; kernels 2, 2b, 4's forward, the stack's forwards
   (1, 1d, 1c-vocab's stack site) and the backwards of 1b, 1d, 3,
   1c-vocab's pool, 4 and 5) or
   "profiler+graph" (some of them from a CUDA-graph replay where the
   profiler saw no device events).

On a machine with several cards the halo phases' ranks each get a card of
their own, over NCCL.

It imports nothing of JAX.  Without CUDA it exits non-zero and prints no
result.  Work files go to ``build/smoke/`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s of HBM3,
# bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Tolerances, as max|kernel - plain| / max|plain|:
# - fp32: both sides accumulate every product in fp32 and differ only in the
#   order of the sums (<= 2*256 terms per dot), compounded over 3 layers;
# - bf16 stack: an fp32 sum that lands on the other side of a bf16
#   rounding boundary flips one intermediate by 2**-8 relative, and the
#   flip propagates through the later layers (the issue's bf16 bar, 5e-2);
# - pools: identical rounded products summed in fp32 in another order.
TOL = {
    ("mp_stack_fwd", torch.float32): 1e-4,
    ("mp_stack_fwd", torch.bfloat16): 5e-2,
    ("wpool_fwd", torch.float32): 1e-5,
    ("wpool_fwd", torch.bfloat16): 1e-5,
    # kernel 2b: dx is the same rounded cotangent times w on both sides, dw
    # the same fp32 products (bf16 x bf16 is exact in fp32) summed over D in
    # another order; the bf16 bar is therefore the fp32 one
    ("wpool_bwd", torch.float32): 1e-5,
    ("wpool_bwd", torch.bfloat16): 1e-5,
}
# Tolerance of the card's bf16 predictions against the CPU run of the same
# model (plain versions, same bf16 cast points), as max|diff| / max|cpu|.
E2E_TOL = 5e-2
# Training kernels and the card-vs-CPU gradients, bf16: the same bar (an
# fp32 sum that rounds to the other bf16 neighbour moves an intermediate by
# 2**-8, and the flip propagates through the layers and the backward walk).
TRAIN_TOL = 5e-2
# The stack backward's fp32 forms against their plain versions: the same
# fp32 products, summed over every atom of the batch in another order (the
# card tests' fp32 bar).
FP32_TOL = 1e-4
TRAIN_STEPS = 24
C3_TRAIN_STEPS = 12
C1_TRAIN_STEPS = 24
FLAT_EVERY = 100  # one molecule larger than a bin in every FLAT_EVERY SMILES
FLAT_SERVE = 2048  # SMILES the flat layout's serving phases run (one batch)
# Kernels 7 and 8 against their plain versions: fp32 outputs hold the same
# fp32 values summed in another order; after the cast to bf16 a sum that
# lands next to a rounding boundary may move by one bf16 step (2**-8).
FLAT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Kernel 6 against its plain version: fp32, the same fp32 products summed in
# another order (the weight gradients over every atom of the batch); bf16,
# an fp32 head-mean weight that lands on the other side of a bf16 rounding
# boundary moves one atom's pooled term by 2**-8 (the bf16 bar, 5e-2).
POOL6_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
MH_TRAIN_STEPS = 12
FOLD_TRAIN_STEPS = 12
FEAT_THREADS = 4  # the native featurizer's threads: the CLI's --num_workers default
MC_SAMPLES = 8  # [mc-serve]'s --mc_samples
MC_SEED = 1234  # the fixed drop_seed of [mc-serve]'s one-sample card-vs-CPU check


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_smiles(n: int, seed: int, stereo: bool = False) -> list:
    """``n`` valid QM9-like SMILES: a terminal group, one to four divalent
    chain units, a terminal group (7-40 atoms with hydrogens).  With
    ``stereo``, about half of them also carry a tetrahedral centre
    (``[C@H](X)`` / ``[C@@H](X)``), a cis/trans double bond (``/C=C/``,
    ``/C=C\\``) or both, each between two of the chain's parts."""
    rng = np.random.default_rng(seed)
    heads = ["C", "O", "N", "F", "Cl", "N#C", "FC(F)(F)", "OC(=O)", "CC", "C=C"]
    units = ["C", "CC", "O", "N", "C(C)", "C(=O)", "C=C", "C#C", "C(O)", "C(N)",
             "c1ccc(cc1)", "C1CCC(CC1)", "C1CC1", "S"]
    tails = ["C", "O", "N", "F", "Cl", "C#N", "C(F)(F)F", "C(=O)O", "CC", "C=O"]
    chiral = ["[C@H](C)", "[C@@H](C)", "[C@H](O)", "[C@@H](N)", "[C@H](F)", "[C@@H](Cl)"]
    double = ["/C=C/", "/C=C\\"]
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 5))
        parts = [heads[rng.integers(len(heads))]]
        parts += [units[rng.integers(len(units))] for _ in range(k)]
        parts.append(tails[rng.integers(len(tails))])
        if stereo and rng.random() < 0.5:
            kind = int(rng.integers(3))  # 0 centre, 1 double bond, 2 both
            if kind != 1:
                parts.insert(int(rng.integers(1, len(parts))), chiral[rng.integers(len(chiral))])
            if kind != 0:
                parts.insert(int(rng.integers(1, len(parts))), double[rng.integers(len(double))])
        out.append("".join(parts))
    return out


def large_smiles(rng) -> str:
    """One molecule of 260-600 atoms with hydrogens: a linear alkane C_nH_2n+2
    (3n + 2 atoms), a PEG chain HO(CH2CH2O)_nH or a glycine peptide
    H(NHCH2CO)_nOH (7n + 3 atoms each)."""
    kind = int(rng.integers(3))
    if kind == 0:
        return "C" * int(rng.integers(87, 200))
    n = int(rng.integers(37, 86))
    return "O" + "CCO" * n if kind == 1 else "NCC(=O)" * n + "O"


def flat_smiles(n: int, seed: int, stereo: bool = False) -> list:
    """``make_smiles(n, seed, stereo)`` with every ``FLAT_EVERY``-th one, from
    index 20 on (so the first 128 hold two), replaced by a large molecule."""
    out = make_smiles(n, seed, stereo)
    rng = np.random.default_rng(seed + 5)
    for i in range(20, n, FLAT_EVERY):
        out[i] = large_smiles(rng)
    return out


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_TRIES = 5


def kernel_profile(fn, iters: int, tries: int = PROFILE_TRIES):
    """{kernel name: (launches a call, mean self device µs a launch)} of
    ``fn``, from ``torch.profiler`` sessions of ``iters`` back-to-back
    calls.  A session in which every kernel's launch count is a multiple of
    ``iters`` is taken as it is.  The profiler at times loses kernel records
    (on an H100 under torch 2.11: a small kernel's record in one call of
    ten, and late in a long run up to half of all records), so after
    ``tries`` sessions without a whole one (1 where ``fn`` meets other
    processes in collectives, which must all call it alike), each kernel's
    launches a call are the most any session showed, rounded up (every
    kernel of the functions timed here launches a fixed number of times a
    call), and its time a launch the mean over all its records, which is
    said on a line of its own.  None when no session recorded device time."""
    from torch.profiler import ProfilerActivity, profile

    sessions = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels: dict = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                n, us = kernels.get(e.key, (0, 0.0))
                kernels[e.key] = (n + e.count, us + e.self_device_time_total)
        if not kernels:
            return None
        if all(n % iters == 0 for n, _ in kernels.values()):
            return {k: (n // iters, us / n) for k, (n, us) in kernels.items()}
        sessions.append(kernels)
    merged: dict = {}
    for kernels in sessions:
        for k, (n, us) in kernels.items():
            n0, us0, most = merged.get(k, (0, 0, 0))
            merged[k] = (n0 + n, us0 + us, max(most, -(-n // iters)))
    short = sum(most * iters * len(sessions) - n for n, _, most in merged.values())
    print(f"[timing] the profiler lost kernel records in all {len(sessions)} sessions "
          f"({short} of {sum(most for _, _, most in merged.values()) * iters * len(sessions)}): "
          "launches a call from the fullest session, time a launch the mean of the records kept",
          flush=True)
    return {k: (most, us / n) for k, (n, us, most) in merged.items()}


def graph_ms(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn`` from CUDA events around the replay
    of a CUDA graph of ``iters`` calls (no launch gaps between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the self device time of every
    kernel it launches, from ``torch.profiler`` (``kernel_profile``); where
    the profiler records no device time, ``graph_ms``, which is said on a
    line of its own and counted in ``device_ms.graph_timed``, so that a row
    of the kernels line names its method (``timing_of``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    kernels = kernel_profile(fn, iters)
    if kernels:
        return sum(n * us for n, us in kernels.values()) / 1e3
    device_ms.graph_timed += 1
    print("[timing] the profiler recorded no device time: timing a CUDA-graph replay with events "
          "instead", flush=True)
    return graph_ms(fn, iters)


device_ms.graph_timed = 0


def timing_of(graph_timed_before: int) -> str:
    """The kernels line's ``timing`` of a row timed with ``device_ms`` since
    ``device_ms.graph_timed`` read ``graph_timed_before``: "profiler", or
    "profiler+graph" where some call fell back to a graph replay."""
    return "profiler" if device_ms.graph_timed == graph_timed_before else "profiler+graph"


def host_us(fn, calls: int = 100) -> float:
    """Host time of one call of ``fn`` in µs: the host clock around
    ``calls`` back-to-back calls with no synchronize among them (what the
    caller's thread spends to enqueue the work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * elapsed / calls


# the timed forms' parts, by the profiler's kernel names: the stack
# forward (kernels 1, 1c-vocab's stack site, 1d; the tile kernel or the one
# of a block a bin), the walk (the stack's and kernel 5's), kernel 4's
# inject kernels, the attention pool's
# backward kernels, the weight-gradient contraction, its partial sums, the
# fold's kernel, the casts to the compute dtype (and other copies) and the
# gathers of the weight streams
BWD_PARTS = (("stack forward", ("stack_fwd_tile_kernel", "mp_stack_kernel")),
             ("walk", ("bwd_walk_kernel", "bwd_layer_kernel", "ext_bwd_kernel")),
             ("inject", ("inject_bwd", "inject_fwd")), ("pool", ("attnpool_bwd", "attnpool_fwd")),
             ("ext forward", ("ext_fwd",)), ("pool6", ("bin_pool",)),
             ("contraction", ("wgrad_group", "wgrad_kernel", "wgrad_vocab")),
             ("partial sums", ("sum_partials",)), ("fold", ("bwd_proj", "proj_bwd")),
             ("casts and copies", ("copy_kernel",)),
             ("weight stream", ("index", "gather", "CatArray")))
BWD_RECORD: dict = {}  # [bwd-record]: the backward's device times and splits, by form
STEP_DEVICE_MS: dict = {}  # profile_step's one-step device time, by phase tag
SERVE_MPS: dict = {}  # run_csv's molecules/s, by serving phase tag


def device_parts(fn, parts=BWD_PARTS, iters: int = 10, warmup: int = 3):
    """``device_ms`` of ``fn`` with its split by part: (total ms, {part: ms}
    per call, {kernel name: launches per call}), each profiler kernel
    counted in the first part one of whose name fragments it holds, else in
    "other"; the split and the names are None where the profiler records no
    device time (``device_ms`` then times a graph)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    kernels = kernel_profile(fn, iters)
    if not kernels:
        return device_ms(fn, iters, warmup), None, None
    split = {name: 0.0 for name, _ in parts}
    split["other"] = 0.0
    for key, (n, us) in kernels.items():
        part = next((name for name, keys in parts if any(k in key for k in keys)), "other")
        split[part] += n * us / 1e3
    return sum(split.values()), split, {key: n for key, (n, _) in kernels.items()}


def bwd_record(tag: str, name: str, dt, fn, ms_plain: float):
    """Time one backward form for the record: device time and its split
    (``device_parts``), a CUDA-graph replay, the wrapper's host time a call;
    printed, and kept in BWD_RECORD.  A profile whose total is more than 25%
    off the replay (on an H100 under torch 2.11 a whole session at times
    reads every kernel at about half its time) is taken again, up to twice,
    which is said on a line of its own.  Returns (device
    ms, timing, {kernel name: launches a call} or None)."""
    graph_timed = device_ms.graph_timed
    ms, split, names = device_parts(fn)
    gms = graph_ms(fn)
    for _ in range(2):
        if split is None or abs(ms - gms) <= 0.25 * gms:
            break
        print(f"[timing] {name}: the profiler's {ms:.4f} ms and a graph replay's {gms:.4f} ms "
              "differ by more than 25%: profiling again", flush=True)
        ms, split, names = device_parts(fn)
        gms = graph_ms(fn)
    hus = host_us(fn, calls=10)
    dname = "bf16" if dt == torch.bfloat16 else "fp32"
    parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items()) if split else "not measured"
    print(f"[{tag}] {name} {dname}: device {ms:.4f} ms a call ({parts}); a CUDA-graph replay "
          f"{gms:.4f} ms a call; host {hus:.1f} us a call; plain {ms_plain:.4f} ms", flush=True)
    if names:
        print(f"[{tag}] {name} {dname} kernels a call: "
              + "; ".join(f"{k[:90]} x{v}" for k, v in sorted(names.items())), flush=True)
    BWD_RECORD[f"{name} {dname}"] = dict(device_ms=ms, split=split, graph_ms=gms, host_us=hus,
                                         plain_ms=ms_plain)
    return ms, timing_of(graph_timed), names


def launches_named(names, fragment: str) -> float:
    """Launches a call of the profiler kernels whose names hold ``fragment``."""
    return sum(v for k, v in (names or {}).items() if fragment in k)


def check_stack_route(tag: str, name: str, names, dt) -> None:
    """Print which kernel a stack forward call launched (the profiler's
    names of one call): bf16 must run the tile kernel where the port has
    it, fp32 the kernel of one block a bin; one launch a call."""
    from aimnet_x2d_tpu_torch.ops import bin_mp

    if names is None:
        print(f"[{tag}] {name}: route not measured (no profiler records)", flush=True)
        return
    tiles = launches_named(names, "stack_fwd_tile_kernel")
    bins = launches_named(names, "mp_stack_kernel")
    print(f"[{tag}] {name} {str(dt)[6:]}: "
          f"{'the tile kernel' if tiles else 'the kernel of one block a bin'} ({tiles} + {bins} "
          "launches a call)", flush=True)
    want = dt == torch.bfloat16
    if bool(tiles) != want or tiles + bins != 1:
        raise AssertionError(f"{name} {dt}: kernels {names}")


def in_turns(fns: dict) -> dict:
    """``device_ms`` of each of ``fns`` twice, in turns: in the order given,
    then in the reverse order (library, kernel, kernel, library); returns
    name -> (first, second)."""
    first = {name: device_ms(fn) for name, fn in fns.items()}
    second = {name: device_ms(fns[name]) for name in reversed(list(fns))}
    return {name: (first[name], second[name]) for name in fns}


# Yardsticks of kernels 2 and 2b: one PyTorch call each that computes the
# kernel's function, on operands in x's dtype (x3 (D, nb, ab), w2 (nb, ab),
# pm (nb, mb, ab), g3 (D, nb, mb)); the weighting is inside the call.  The
# port never calls them; tests/test_torch_wpool_yardsticks.py holds them to
# the plain versions.  No single call computes 2b's dw.
def wpool_fwd_library(x3, w2, pm):
    return torch.einsum("dba,ba,bma->dbm", x3, w2, pm)


def wpool_bwd_dx_library(g3, pm, w2):
    return torch.einsum("dbm,bma,ba->dba", g3, pm, w2)


def rand_pm(nb: int, mb: int, ab: int, gen, multi: bool = False) -> torch.Tensor:
    """A random int8 pool matrix (nb, mb, ab): each atom in one slot or
    none.  ``multi``: not one-hot, as the kernels must still take it: every
    7th atom of a slot carries 2 there and -1 in the next slot, and slot 0
    of every bin is empty."""
    dev = gen.device
    owner = torch.randint(-1, mb, (nb, ab), generator=gen, device=dev)
    slots = torch.arange(mb, device=dev)[None, :, None]
    pm = (owner[:, None, :] == slots).to(torch.int8)
    if multi:
        two = ((torch.arange(ab, device=dev) % 7 == 0)[None, :] & (owner >= 0))[:, None, :]
        pm = torch.where(two, 2 * pm, pm)
        pm = pm - (two & (((owner + 1) % mb)[:, None, :] == slots)).to(torch.int8)
        pm[:, 0] = 0
    return pm.contiguous()


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output has non-finite values")
    abs_err = float((got - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def flagship_config(pkg):
    # bench.py's flagship (hidden 512 -> x_self 359 / x_other 153, 4x64
    # embeddings, 3 MP layers over 3 shells, 4-head attention pooling,
    # 3-layer FFN, 12 outputs), bf16 compute, serving without dropout
    return pkg.models.gnn.GNNConfig(
        hidden_dim=512, output_dim=12, num_shells=3, num_message_passing_layers=3,
        embedding_dim=64, ffn_num_layers=3, pooling_type="attention",
        task_type="multitask", activation_type="silu", shell_conv_dropout=0.0,
        ffn_dropout=0.0, compute_dtype="bfloat16",
    )


def train_config(cfg):
    """The flagship in training: shell_conv_dropout and ffn_dropout at the
    CLI default of 0.05 (the serving config turns them off)."""
    import dataclasses

    return dataclasses.replace(cfg, shell_conv_dropout=0.05, ffn_dropout=0.05)


def check_kernels(pkg, cfg, batch, seed: int) -> dict:
    """Phase 3: each kernel against its plain version at the serving
    shapes; returns per-kernel numbers for the kernels line."""
    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax
    from aimnet_x2d_tpu_torch.ops import bin_mp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = pkg.models.gnn.GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed)))
    model.to(dev)
    layers_ws = [layer.stack_weights() for layer in model.message_passing_layers]
    adj = batch.bin_adj
    pm = batch.pool_mat
    nb, ab, _ = adj.shape
    A = nb * ab
    D = cfg.x_other_dim
    n_real = int(batch.atom_mask.sum())
    nnz_adj = int((adj != 0).sum())
    L, nblk = cfg.num_message_passing_layers, cfg.shell_conv_num_mlp_layers
    print(f"[shapes] nb={nb} ab={ab} mb={pm.shape[1]} A={A} real atoms={n_real} "
          f"adjacency nonzeros={nnz_adj}", flush=True)
    res = {}

    # --- kernel 1: the MP stack
    for dt in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            sw = bin_mp.stack_weights(layers_ws, dt)
        x = torch.randn(D, A, generator=gen, device=dev).to(dt)
        got = bin_mp.mp_stack_fwd(x, adj, sw, cfg.activation_type)
        again = bin_mp.mp_stack_fwd(x, adj, sw, cfg.activation_type)
        ref = bin_mp.mp_stack_plain(x, adj, sw, cfg.activation_type)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"mp_stack_fwd {dt}: a rerun is not bit-equal")
        abs_err, rel = rel_err(got, ref)
        tol = TOL[("mp_stack_fwd", dt)]
        plain_ms = time_ms(lambda: bin_mp.mp_stack_plain(x, adj, sw, cfg.activation_type), iters=5)
        ms, timing, names = bwd_record("kernel", "mp_stack_fwd", dt, lambda: bin_mp.mp_stack_fwd(
            x, adj, sw, cfg.activation_type), plain_ms)
        check_stack_route("kernel", "mp_stack_fwd", names, dt)
        isz = torch.tensor([], dtype=dt).element_size()
        w_bytes = L * (2 * D * 2 * D + 2 * D + nblk * (2 * D * D + 2 * D)) * isz
        nbytes = 2 * D * A * isz + nb * ab * ab + w_bytes
        ops = L * (2 * nnz_adj * D + n_real * (2 * 2 * 2 * D * D + nblk * 2 * 2 * D * D))
        bound_ms = 1e3 * max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[dt])
        bound_by = "bytes" if nbytes / HBM_BYTES_S > ops / PEAK_FLOPS[dt] else "operations"
        print(f"[kernel] mp_stack_fwd {str(dt)[6:]} D={D} nb={nb}: max_abs_err={abs_err:.3e} "
              f"rel={rel:.3e} (tol {tol:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}; {ops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB)", flush=True)
        if not rel <= tol:
            raise AssertionError(f"mp_stack_fwd {dt}: rel err {rel:.3e} > {tol:g}")
        res[("mp_stack_fwd", dt)] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, timing=timing,
        )

    res.update(check_wpool_fwd(cfg, batch, seed))
    return res


def check_wpool_fwd(cfg, batch, seed: int) -> dict:
    """``[kernel]`` for kernel 2 (``wpool_fwd``): against its plain version
    on x_self's and x_other's rows, fp32 and bf16, at the serving batch's
    pool matrix, two random ones with mb not a multiple of 16 and one that
    is not one-hot, the output bit-equal on a rerun; then timed at the
    serving batch (both launches of a batch): device time from the
    profiler, in turns with the library yardstick, beside the event time
    of back-to-back calls and the wrapper's host time per call."""
    from aimnet_x2d_tpu_torch.ops import bin_wpool

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    pm = batch.pool_mat
    nb, mb, ab = pm.shape
    A = nb * ab
    Ds = (cfg.x_self_dim, cfg.x_other_dim)
    pms = [pm, rand_pm(nb, 20, ab, gen), rand_pm(nb, 44, ab, gen), rand_pm(nb, mb, ab, gen, True)]
    w = torch.rand(A, generator=gen, device=dev) * batch.atom_mask.float()
    npm = int((pm != 0).sum())
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[("wpool_fwd", dt)]
        graph_timed = device_ms.graph_timed
        tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   bound_by="bytes", event_ms=0.0, host_us=0.0)
        for k, pm_ in enumerate(pms):
            mb_ = pm_.shape[1]
            for d in Ds:
                x = torch.randn(d, A, generator=gen, device=dev).to(dt)
                got = bin_wpool.wpool_fwd(x, w, pm_)
                ref_out = bin_wpool.wpool_plain(x, w, pm_)
                again = bin_wpool.wpool_fwd(x, w, pm_)
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, ref_out)
                kind = "not one-hot" if k == 3 else "one-hot"
                print(f"[kernel] wpool_fwd {str(dt)[6:]} D={d} mb={mb_} ({kind}): "
                      f"max_abs_err={abs_err:.3e} rel={rel:.3e} (tol {tol:g})", flush=True)
                if not rel <= tol or not torch.equal(got, again):
                    raise AssertionError(f"wpool_fwd {dt} D={d} mb={mb_} ({kind}): rel err "
                                         f"{rel:.3e} > {tol:g}, or a rerun differs")
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
                if k:
                    continue
                # main-path shapes: both launches of a batch
                x3, w2, pm_dt = x.reshape(d, nb, ab), w.reshape(nb, ab).to(dt), pm.to(dt)
                t = in_turns({"library": lambda: wpool_fwd_library(x3, w2, pm_dt),
                              "kernel": lambda: bin_wpool.wpool_fwd(x, w, pm)})
                plain = device_ms(lambda: bin_wpool.wpool_plain(x, w, pm), iters=5)
                ev = time_ms(lambda: bin_wpool.wpool_fwd(x, w, pm))
                hu = host_us(lambda: bin_wpool.wpool_fwd(x, w, pm))
                nbytes = d * A * x.element_size() + 4 * A + nb * mb * ab + 4 * d * nb * mb
                ops = 2 * d * npm
                bound = 1e3 * max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[torch.float32])
                print(f"[kernel] wpool_fwd {str(dt)[6:]} D={d}: device ms kernel "
                      f"{t['kernel'][0]:.4f} / {t['kernel'][1]:.4f}, library {t['library'][0]:.4f}"
                      f" / {t['library'][1]:.4f}; plain {plain:.4f}; bound {bound:.4f} (bytes, "
                      f"{nbytes / 1e6:.2f} MB); "
                      f"events over back-to-back calls {ev:.4f} ms; host {hu:.1f} us a call",
                      flush=True)
                tot["ms"] += sum(t["kernel"]) / 2
                tot["library_ms"] += sum(t["library"]) / 2
                tot["plain_ms"] += plain
                tot["bound_ms"] += bound
                tot["event_ms"] += ev
                tot["host_us"] += hu / len(Ds)
        print(f"[kernel] wpool_fwd {str(dt)[6:]} per batch (D={Ds[0]} + D={Ds[1]}, nb={nb}, "
              f"mb={mb}, ab={ab}), device ms: kernel {tot['ms']:.4f} library {tot['library_ms']:.4f}"
              f" plain {tot['plain_ms']:.4f} bound {tot['bound_ms']:.4f} (bytes): "
              f"{tot['ms'] / tot['bound_ms']:.2f}x the bound, {tot['ms'] / tot['library_ms']:.2f}x "
              f"the library call; events {tot['event_ms']:.4f} ms; host {tot['host_us']:.1f} us "
              f"a call", flush=True)
        tot["timing"] = timing_of(graph_timed)
        res[("wpool_fwd", dt)] = tot
    return res


def profile_forward(model, batch, top: int = 8) -> None:
    """Device time of one forward, by kernel (torch.profiler, two forwards
    profiled, ``kernel_profile``)."""
    model(batch)
    torch.cuda.synchronize()
    kernels = kernel_profile(lambda: model(batch), 2)
    if not kernels:
        print("[profile] device time not measured (no device time in the profiler trace)",
              flush=True)
        return
    per = {key: n * us for key, (n, us) in kernels.items()}  # µs a forward
    total = sum(per.values())
    print(f"[profile] one forward, device time {total / 1e3:.3f} ms summed over kernels:", flush=True)
    for key in sorted(per, key=lambda k: -per[k])[:top]:
        print(f"[profile]   {per[key] / 1e3:8.3f} ms {100 * per[key] / total:5.1f}%  "
              f"x{kernels[key][0]:<3d} {key[:90]}", flush=True)


def write_artifact(cfg, smiles, seed: int, work: str, tag: str):
    """A serving artifact of ``cfg`` (random weights from ``seed``, a
    scaler fitted on random targets) and a CSV of ``smiles``: returns
    (artifact, input CSV, output CSV, flax-named weights, pipeline, target
    columns)."""
    from aimnet_x2d_tpu_torch.checkpoint import init_params, save_artifact
    from aimnet_x2d_tpu_torch.data.preprocessing import (
        PreprocessingConfig, PreprocessingPipeline, StandardScaler,
    )

    import pandas as pd

    rng = np.random.default_rng(seed)
    T = cfg.output_dim
    scaler = StandardScaler()
    scaler.fit(rng.normal(size=(512, T)) * rng.uniform(0.5, 3.0, T) + rng.uniform(-5, 5, T))
    prep = PreprocessingPipeline(PreprocessingConfig(task_type="multitask"))
    prep.standard_scaler, prep.is_fitted = scaler, True
    cols = [f"target_{i}" for i in range(T)]
    flat = init_params(cfg, seed)
    art = os.path.join(work, f"{tag}.npz")
    save_artifact(art, flat, cfg, prep, extra={"target_columns": cols, "max_hops": cfg.num_shells})
    csv_in, csv_out = os.path.join(work, f"{tag}-mols.csv"), os.path.join(work, f"{tag}-preds.csv")
    pd.DataFrame({"smiles": smiles}).to_csv(csv_in, index=False)
    return art, csv_in, csv_out, flat, prep, cols


def serve(pkg, cfg, smiles, seed: int, work: str, dev_batch, tag: str = "serve",
          counters=None, forbidden=(), n_cpu: int = 256) -> dict:
    """Phase 4 (and ``[c3-serve]``, ``[c1-serve]``, ``[flat-serve]``): the
    port's CLI on cuda, counters of the path's kernels (default: the
    flagship's), which must all launch, and of ``forbidden`` kernels, which
    must not; output checks, CPU comparison of the first ``n_cpu``
    molecules, model-only throughput."""
    from aimnet_x2d_tpu_torch import cli
    from aimnet_x2d_tpu_torch.checkpoint import params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import bin_mp, bin_wpool
    from aimnet_x2d_tpu_torch.training.predictor import predict

    import pandas as pd

    counters = counters or (bin_mp.mp_stack_fwd, bin_wpool.wpool_fwd)
    T = cfg.output_dim
    art, csv_in, csv_out, flat, prep, cols = write_artifact(cfg, smiles, seed, work, tag)
    scaler = prep.standard_scaler

    for c in (*counters, *forbidden):
        c.launches = 0
    summary = cli.main(["--inference_csv", csv_in, "--model_save_path", art,
                        "--inference_output", csv_out, "--device", "cuda"])
    launches = {c.__name__: c.launches for c in counters}
    ran = {c.__name__: c.launches for c in forbidden}
    print(f"[{tag}] launches on the main path: {launches}"
          + (f"; must not launch: {ran}" if ran else ""), flush=True)
    if min(launches.values()) <= 0 or any(ran.values()):
        raise AssertionError(f"a kernel of the main path never launched, or one of another "
                             f"route did: {launches} {ran}")

    out = pd.read_csv(csv_out)
    if summary["valid_molecules"] != len(smiles) or len(out) != len(smiles):
        raise AssertionError(f"{len(out)} rows for {len(smiles)} SMILES ({summary})")
    vals = out[cols].to_numpy(np.float64)
    if vals.shape != (len(smiles), T) or not np.isfinite(vals).all():
        raise AssertionError("predictions are not all finite or have the wrong shape")

    # one batch on the CPU, plain versions, raw (scaled) outputs
    model_cpu = pkg.models.gnn.GNN(cfg)
    model_cpu.load_state_dict(params_from_flax(flat))
    ds = MoleculeDataset.from_smiles(smiles[:n_cpu], np.zeros((n_cpu, 1), np.float32), cfg.num_shells,
                                     FEAT_THREADS)
    t0 = time.perf_counter()
    cpu = predict(model_cpu.eval(), BatchLoader(ds, n_cpu), "cpu")["predictions"]
    cpu_s = time.perf_counter() - t0
    card = (vals[:n_cpu] - scaler.means) / scaler.stds
    e2e_abs = float(np.abs(card - cpu).max())
    e2e_rel = e2e_abs / max(float(np.abs(cpu).max()), 1e-30)
    print(f"[{tag}] card vs cpu on {n_cpu} molecules: max_abs_err={e2e_abs:.3e} "
          f"rel={e2e_rel:.3e} (tol {E2E_TOL:g}; cpu {cpu_s:.1f} s)", flush=True)
    if not e2e_rel <= E2E_TOL:
        raise AssertionError(f"card predictions differ from the CPU run: {e2e_rel:.3e}")

    # model-only throughput on one pre-featurized 2048-molecule batch
    model = pkg.models.gnn.GNN(cfg)
    model.load_state_dict(params_from_flax(flat))
    model.to("cuda").eval()
    with torch.inference_mode():
        tb = dev_batch
        n_mol = int(tb.graph_mask.sum())
        step_ms = time_ms(lambda: model(tb), iters=10)
        profile_forward(model, tb)
    mps = n_mol / (step_ms / 1e3)
    SERVE_MPS[tag] = summary["molecules_per_second"]
    print(f"[{tag}] run_csv: {summary['valid_molecules']} molecules in {summary['seconds']:.3f} s "
          f"= {summary['molecules_per_second']:.1f} mol/s end to end, of which featurization "
          f"{summary['featurize_seconds']:.3f} s (host, {summary['featurizer']} featurizer)",
          flush=True)
    print(f"[{tag}] model forward, batch of {n_mol} molecules (already on the card): "
          f"{step_ms:.3f} ms = {mps:.1f} mol/s", flush=True)
    return launches


def _features_equal(a, b) -> bool:
    if (a is None) or (b is None):
        return (a is None) and (b is None)
    same = a.smiles == b.smiles and a.total_charge == b.total_charge
    for key in ("atom_type", "hydrogen_count", "degree", "hybridization", "atomic_numbers",
                "tet_nbrs", "cis_pairs", "trans_pairs"):
        x, y = getattr(a, key), getattr(b, key)
        same = same and x.shape == y.shape and np.array_equal(x, y)
    return same and all(x.shape == y.shape and np.array_equal(x, y)
                        for x, y in zip(a.edge_hops, b.edge_hops))


def _batches_equal(a, b) -> list:
    """Names of the MolBatch fields that differ (arrays by value and shape)."""
    import dataclasses

    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if not (isinstance(y, np.ndarray) and x.shape == y.shape and np.array_equal(x, y)):
                bad.append(f.name)
        elif (x is None) != (y is None) or (isinstance(x, bool) and x != y):
            bad.append(f.name)
    return bad


def native_phase(smiles, seed: int, build_s: float) -> None:
    """[native]: the native featurizer against the pure-Python one, array
    for array, on the script's first 512 SMILES, the first 512 with stereo
    content and 8 molecules larger than a bin, with both host times; then
    one 2048-molecule binned batch from the native builder against the
    Python collate + bin-pack, array for array, with both build times."""
    from aimnet_x2d_tpu_torch.chem import native
    from aimnet_x2d_tpu_torch.chem.featurize import compute_features
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset

    print(f"[native] library built by g++ in {build_s:.1f} s (host clock, beside the kernels' "
          f"nvcc)", flush=True)
    rng = np.random.default_rng(seed + 9)
    sets = (("flagship SMILES", smiles[:512]),
            ("stereo SMILES", make_smiles(512, seed + 1, stereo=True)),
            ("large molecules", [large_smiles(rng) for _ in range(8)]))
    for name, sm in sets:
        t0 = time.perf_counter()
        ref = [compute_features(s, 3) for s in sm]
        t1 = time.perf_counter()
        got = native.compute_features_batch(sm, 3, num_threads=1)
        t2 = time.perf_counter()
        got_t = native.compute_features_batch(sm, 3, num_threads=FEAT_THREADS)
        t3 = time.perf_counter()
        bad = [i for i, (a, b, r) in enumerate(zip(got, got_t, ref))
               if not (_features_equal(a, r) and _features_equal(b, r))]
        atoms = sum(r.num_atoms for r in ref if r is not None)
        print(f"[native] {len(sm)} {name} ({atoms} atoms with H): array-exact against the "
              f"pure-Python featurizer {not bad}; host pure-Python {t1 - t0:.3f} s, native "
              f"{t2 - t1:.3f} s on 1 thread, {t3 - t2:.3f} s on {FEAT_THREADS} threads "
              f"(host clock)", flush=True)
        if bad:
            raise AssertionError(f"native features differ from the pure-Python ones at {bad[:5]}")

    targets = np.zeros((2048, 1), np.float32)
    ds = MoleculeDataset.from_smiles(smiles[:2048], targets, 3, FEAT_THREADS)
    os.environ["AIMNET_NO_NATIVE"] = "1"
    try:
        py_ds = MoleculeDataset.from_smiles(smiles[:2048], targets, 3)
    finally:
        os.environ.pop("AIMNET_NO_NATIVE", None)
    times, batches = {}, {}
    for name, d, env in (("native", ds, None), ("python", py_ds, "1")):
        loader = BatchLoader(d, 2048)
        loader.warm_bin_pins()
        if env:
            os.environ["AIMNET_NO_NATIVE"] = env
        try:
            t0 = time.perf_counter()
            batches[name] = next(iter(loader))
            times[name] = time.perf_counter() - t0
        finally:
            os.environ.pop("AIMNET_NO_NATIVE", None)
    bad = _batches_equal(batches["native"], batches["python"])
    print(f"[native] one binned batch of 2048 molecules: array-exact against the Python collate "
          f"+ bin-pack {not bad}; host build native {times['native']:.4f} s, Python "
          f"{times['python']:.4f} s (host clock)", flush=True)
    if bad:
        raise AssertionError(f"the native binned batch differs in {bad}")


def mc_serve(pkg, cfg, smiles, seed: int, work: str, dev_batch, n_cpu: int = 256) -> dict:
    """[mc-serve]: the flagship with dropout (``cfg``) serves ``smiles``
    through the CLI with ``--mc_samples``: kernel 1's training form and
    kernel 3's forward launch MC_SAMPLES times a batch, no serving form and
    no backward; outputs finite with std > 0; one sample at a fixed
    drop_seed with ffn_dropout 0 on the card against the CPU plain versions
    (E2E_TOL); one sample's time against one deterministic forward."""
    import dataclasses

    from aimnet_x2d_tpu_torch import cli
    from aimnet_x2d_tpu_torch.checkpoint import params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp, bin_wpool

    import pandas as pd

    tag = "mc-serve"
    art, csv_in, csv_out, flat, prep, cols = write_artifact(cfg, smiles, seed, work, tag)
    want = (bin_mp.mp_stack_fwd_train, bin_attnpool.attnpool_fwd)
    never = (bin_mp.mp_stack_fwd, bin_wpool.wpool_fwd, bin_mp.mp_stack_fwd_train_vocab,
             bin_attnpool.attnpool_fwd_vocab, bin_mp.mp_stack_bwd, bin_mp.mp_stack_bwd_proj,
             bin_attnpool.attnpool_bwd, bin_wpool.wpool_bwd)
    for c in want + never:
        c.launches = 0
    summary = cli.main(["--inference_csv", csv_in, "--model_save_path", art,
                        "--inference_output", csv_out, "--device", "cuda",
                        "--mc_samples", str(MC_SAMPLES)])
    launches = {c.__name__: c.launches for c in want}
    ran = {c.__name__: c.launches for c in never}
    n_batches = -(-len(smiles) // 2048)
    print(f"[{tag}] launches on the main path ({MC_SAMPLES} samples, {n_batches} batches): "
          f"{launches}; must not launch: {ran}", flush=True)
    if any(v != MC_SAMPLES * n_batches for v in launches.values()) or any(ran.values()):
        raise AssertionError(f"MC serving launched {launches}, {ran}")
    out = pd.read_csv(csv_out)
    ucols = [c + "_uncertainty" for c in cols]
    vals, std = out[cols].to_numpy(np.float64), out[ucols].to_numpy(np.float64)
    if (summary["inference_mode"] != "mc_dropout" or len(out) != len(smiles)
            or not np.isfinite(vals).all() or not (np.isfinite(std).all() and (std > 0).all())):
        raise AssertionError("MC outputs missing, not finite, or with a std that is not > 0")
    print(f"[{tag}] run_csv: {summary['valid_molecules']} molecules in {summary['seconds']:.3f} s "
          f"= {summary['molecules_per_second']:.1f} mol/s end to end, featurization "
          f"{summary['featurize_seconds']:.3f} s ({summary['featurizer']}); std over the samples "
          f"in target units: median {np.median(std):.4e}, max {std.max():.4e}", flush=True)

    # one sample, card against the CPU plain versions: with ffn_dropout 0
    # the only mask is the stack's in-kernel hash of drop_seed
    one = dataclasses.replace(cfg, ffn_dropout=0.0)
    w = params_from_flax(flat)
    models = {}
    for where in ("cuda", "cpu"):
        models[where] = pkg.models.gnn.GNN(one)
        models[where].load_state_dict(w)
        models[where].to(where).eval()
    ds = MoleculeDataset.from_smiles(smiles[:n_cpu], np.zeros((n_cpu, 1), np.float32),
                                     cfg.num_shells, FEAT_THREADS)
    host = next(iter(BatchLoader(ds, n_cpu)))
    gm = torch.from_numpy(host.graph_mask)
    with torch.inference_mode():
        got = models["cuda"](host.to("cuda"), train=True, drop_seed=MC_SEED).predictions.cpu()[gm]
        ref = models["cpu"](host.to("cpu"), train=True, drop_seed=MC_SEED).predictions[gm]
        det = models["cpu"](host.to("cpu")).predictions[gm]
    abs_err, rel = rel_err(got, ref)
    print(f"[{tag}] one sample (drop_seed {MC_SEED}, ffn_dropout 0) card vs cpu on {n_cpu} "
          f"molecules: max_abs_err={abs_err:.3e} rel={rel:.3e} (tol {E2E_TOL:g}); the sample "
          f"differs from the deterministic forward by {float((ref - det).abs().max()):.3e}",
          flush=True)
    if not rel <= E2E_TOL or torch.equal(ref, det):
        raise AssertionError(f"one MC sample: card vs cpu {rel:.3e}, or no unit was dropped")

    # one sample against one deterministic forward on the 2048-molecule batch
    del models
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mc_model = pkg.models.gnn.GNN(cfg)
    mc_model.load_state_dict(w)
    mc_model.to("cuda").eval()
    with torch.inference_mode():
        det_ms = time_ms(lambda: mc_model(dev_batch), iters=10)
        mc_ms = time_ms(lambda: mc_model(dev_batch, train=True, generator=gen), iters=10)
    n_mol = int(dev_batch.graph_mask.sum())
    print(f"[{tag}] batch of {n_mol} molecules on the card (CUDA events): one MC sample "
          f"{mc_ms:.3f} ms, one deterministic forward {det_ms:.3f} ms (x{mc_ms / det_ms:.2f})",
          flush=True)
    return launches


def evid_serve(pkg, cfg, smiles, seed: int, work: str, n_cpu: int = 256) -> None:
    """[evid-serve]: an evidential flagship artifact served through the
    CLI with ``--inference_mode evidential`` (the serving kernels 1 and 2),
    the four columns per target against the CPU run of the first ``n_cpu``
    molecules (E2E_TOL), uncertainties finite and positive."""
    import dataclasses

    from aimnet_x2d_tpu_torch import cli
    from aimnet_x2d_tpu_torch.checkpoint import params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp, bin_wpool
    from aimnet_x2d_tpu_torch.training.predictor import predict_evidential

    import pandas as pd

    tag = "evid-serve"
    ecfg = dataclasses.replace(cfg, loss_function="evidential")
    art, csv_in, csv_out, flat, prep, cols = write_artifact(ecfg, smiles, seed, work, tag)
    want = (bin_mp.mp_stack_fwd, bin_wpool.wpool_fwd)
    never = (bin_mp.mp_stack_fwd_train, bin_attnpool.attnpool_fwd)
    for c in want + never:
        c.launches = 0
    summary = cli.main(["--inference_csv", csv_in, "--model_save_path", art,
                        "--inference_output", csv_out, "--device", "cuda",
                        "--inference_mode", "evidential"])
    launches = {c.__name__: c.launches for c in want}
    ran = {c.__name__: c.launches for c in never}
    print(f"[{tag}] launches on the main path: {launches}; must not launch: {ran}", flush=True)
    if min(launches.values()) <= 0 or any(ran.values()):
        raise AssertionError(f"evidential serving launched {launches}, {ran}")
    out = pd.read_csv(csv_out)
    keys = (("predictions", ""), ("aleatoric_uncertainty", "_aleatoric"),
            ("epistemic_uncertainty", "_epistemic"), ("total_uncertainty", "_total_uncertainty"))
    if len(out) != len(smiles):
        raise AssertionError(f"{len(out)} rows for {len(smiles)} SMILES")
    for _, suffix in keys[1:]:
        u = out[[c + suffix for c in cols]].to_numpy(np.float64)
        if not (np.isfinite(u).all() and (u > 0).all()):
            raise AssertionError(f"{suffix} uncertainties not finite and positive")
    model_cpu = pkg.models.gnn.GNN(ecfg)
    model_cpu.load_state_dict(params_from_flax(flat))
    ds = MoleculeDataset.from_smiles(smiles[:n_cpu], np.zeros((n_cpu, 1), np.float32),
                                     cfg.num_shells, FEAT_THREADS)
    ref = predict_evidential(model_cpu.eval(), BatchLoader(ds, n_cpu), "cpu", len(cols),
                             pipeline=prep)
    worst = 0.0
    for key, suffix in keys:
        card = out[[c + suffix for c in cols]].to_numpy(np.float64)[:n_cpu]
        r = np.asarray(ref[key], np.float64)
        worst = max(worst, float(np.abs(card - r).max()) / max(float(np.abs(r).max()), 1e-30))
    print(f"[{tag}] run_csv: {summary['valid_molecules']} molecules in {summary['seconds']:.3f} s "
          f"= {summary['molecules_per_second']:.1f} mol/s, featurization "
          f"{summary['featurize_seconds']:.3f} s ({summary['featurizer']}); card vs cpu on "
          f"{n_cpu} molecules, gamma and the three uncertainties: max rel={worst:.3e} "
          f"(tol {E2E_TOL:g})", flush=True)
    if not worst <= E2E_TOL:
        raise AssertionError(f"evidential outputs differ from the CPU run: {worst:.3e}")


def _max_rel(pairs) -> tuple:
    """(max abs err, max over pairs of max|got - ref| / max|ref|)."""
    worst_abs, worst_rel = 0.0, 0.0
    for got, ref, scale in pairs:
        a, _ = rel_err(got, ref)
        s_ = float(ref.float().abs().max()) if scale is None else scale
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, a / max(s_, 1e-30))
    return worst_abs, worst_rel


def recorder(tag: str, res: dict):
    """``record(name, pairs, ms, plain_ms, ops, nbytes)``: print a bf16
    kernel's errors (held to TRAIN_TOL), times and bound, and keep them in
    ``res[name]``."""
    dt = torch.bfloat16

    def record(name, pairs, ms, plain_ms, ops, nbytes):
        abs_err, rel = _max_rel(pairs)
        t_ops, t_bytes = ops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[{tag}] {name} bf16: max_abs_err={abs_err:.3e} rel={rel:.3e} "
              f"(tol {TRAIN_TOL:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}; {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
        if not rel <= TRAIN_TOL:
            raise AssertionError(f"{name}: rel err {rel:.3e} > {TRAIN_TOL:g}")
        res[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)

    return record


def check_train_kernels(pkg, cfg, model, batch, seed: int, marks_build) -> dict:
    """Phase 5: each training kernel against its plain version at the
    flagship training shapes (bf16), with times and bounds; the attention
    pool's backward split by phase (``attnpool_phases`` on ``marks_build``)."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp
    from aimnet_x2d_tpu_torch.ops.embed import embed_concat_onehot_t

    dev = torch.device("cuda")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    adj, pm = batch.bin_adj, batch.pool_mat
    nb, ab, _ = adj.shape
    mb = pm.shape[1]
    A, B = nb * ab, nb * mb
    D, Ds, H = cfg.x_other_dim, cfg.x_self_dim, cfg.attention_num_heads
    E = 4 * cfg.embedding_dim
    L, nblk = cfg.num_message_passing_layers, cfg.shell_conv_num_mlp_layers
    n = int(batch.atom_mask.sum())
    nnz = int((adj != 0).sum())
    print(f"[train-kernel] shapes nb={nb} ab={ab} mb={mb} A={A} real atoms={n} "
          f"adjacency nonzeros={nnz}", flush=True)
    names = ("atom_type", "hydrogen_count", "degree", "hybridization")
    with torch.no_grad():
        tables = [getattr(model, f"{k}_embedding").weight for k in names]
        emb = embed_concat_onehot_t(tables, [getattr(batch, k) for k in names], dtype=dt)
        sw = bin_mp.stack_weights([layer.stack_weights() for layer in model.message_passing_layers], dt)
        W, b = model.embedding_projection.weight, model.embedding_projection.bias
        pw = bin_mp.prep_proj(W[Ds:].T, b[Ds:], dt, sw.Dp)
        score_k, score_b = model.pooling._score_fold(model.concat_self_other.weight.T,
                                                      model.concat_self_other.bias)
        aw = bin_attnpool.prep_weights(W[:Ds].T, b[:Ds], score_k[:Ds], score_k[Ds:], score_b, dt)
    spec = bin_mp.StackSpec(cfg.activation_type, 0.05, 0x1234567)
    act = cfg.activation_type
    res = {}
    isz = 2  # bf16 bytes

    record = recorder("train-kernel", res)
    w_layer = 2 * D * 2 * D + nblk * 2 * D * D  # weight matrix elements of one layer
    w_mat = L * w_layer
    # --- kernel 1 (training form) + 1c: forward with dropout and the fold
    out, saved = bin_mp.mp_stack_fwd_train(emb, adj, sw, spec, pw)
    out2, saved2 = bin_mp.mp_stack_fwd_train(emb, adj, sw, spec, pw)
    ref, ref_saved = bin_mp.mp_stack_train_plain(emb, adj, sw, spec, pw)
    torch.cuda.synchronize()
    if not (torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(saved, saved2))):
        raise AssertionError("mp_stack_fwd_train: a rerun is not bit-equal")
    del out2, saved2
    ops = 2 * n * E * D + L * (2 * nnz * D + n * 2 * w_layer)
    nbytes = (E * A + D * A + L * D * A) * isz + nb * ab * ab + (w_mat + E * D) * isz
    plain_ms = time_ms(lambda: bin_mp.mp_stack_train_plain(emb, adj, sw, spec, pw), iters=5)
    ms, timing, names = bwd_record("train-kernel", "mp_stack_fwd_train", dt,
                                   lambda: bin_mp.mp_stack_fwd_train(emb, adj, sw, spec, pw),
                                   plain_ms)
    check_stack_route("train-kernel", "mp_stack_fwd_train", names, dt)
    record("mp_stack_fwd_train", [(out, ref, None)] + [(a, r, None) for a, r in zip(saved, ref_saved)],
           ms, plain_ms, ops, nbytes)
    res["mp_stack_fwd_train"]["timing"] = timing
    # without dropout and the fold, the training form is the serving form bit for bit
    same = torch.equal(bin_mp.mp_stack_fwd_train(out, adj, sw, bin_mp.StackSpec(act))[0],
                       bin_mp.mp_stack_fwd(out, adj, sw, act))
    print(f"[train-kernel] mp_stack_fwd_train without dropout equals mp_stack_fwd: {same}",
          flush=True)
    if not same:
        raise AssertionError("mp_stack_fwd_train without dropout differs from mp_stack_fwd")
    stack_phases(marks_build, "train-kernel", emb, adj, sw, spec, pw)

    # --- kernel 1b (+ 1c backward)
    g = (torch.randn(D, A, generator=gen, device=dev) * 0.05).to(dt)
    got = bin_mp.mp_stack_bwd(emb, adj, sw, spec, saved, g, pw)
    want = bin_mp.mp_stack_bwd_plain(emb, adj, sw, spec, ref_saved, g, pw)
    torch.cuda.synchronize()
    pairs = [(got[0], want[0], None)]
    pairs += [(a, r, None) for la, lr_ in zip(got[1], want[1]) for a, r in zip(la, lr_)]
    pairs += [(a, r, None) for a, r in zip(got[2], want[2])]
    # recompute (no skip product, no last W2) + walk (W2^T, W1^T, [Ws|Win]^T)
    # + aggregation and its transpose + weight gradients + the fold's three
    per_layer = (2 * 2 * nnz * D + n * 2 * (2 * D * D + (2 * nblk - 1) * D * D)
                 + n * 2 * (2 * nblk * D * D + 4 * D * D) + n * 2 * w_layer)
    ops = L * per_layer + 3 * 2 * n * E * D
    nbytes = (E * A + L * D * A + D * A + E * A) * isz + nb * ab * ab + 4 * (w_mat + E * D)
    again = bin_mp.mp_stack_bwd(emb, adj, sw, spec, saved, g, pw)
    flat = lambda r: [r[0], *(t for l_ in r[1] for t in l_), *r[2]]  # noqa: E731
    if not all(torch.equal(a, b) for a, b in zip(flat(got), flat(again))):
        raise AssertionError("mp_stack_bwd: a rerun is not bit-equal")
    plain_ms = time_ms(lambda: bin_mp.mp_stack_bwd_plain(emb, adj, sw, spec, ref_saved, g, pw),
                       iters=3)
    ms, timing, _ = bwd_record("train-kernel", "mp_stack_bwd", dt,
                            lambda: bin_mp.mp_stack_bwd(emb, adj, sw, spec, saved, g, pw), plain_ms)
    record("mp_stack_bwd", pairs, ms, plain_ms, ops, nbytes)
    res["mp_stack_bwd"]["timing"] = timing
    # the fp32 form at the same shapes, held to FP32_TOL
    with torch.no_grad():
        sw32 = bin_mp.stack_weights([layer.stack_weights() for layer in model.message_passing_layers],
                                    torch.float32)
        pw32 = bin_mp.prep_proj(W[Ds:].T, b[Ds:], torch.float32, sw32.Dp)
    emb32, g32_ = emb.float(), g.float()
    _, saved32 = bin_mp.mp_stack_fwd_train(emb32, adj, sw32, spec, pw32)
    _, ref_saved32 = bin_mp.mp_stack_train_plain(emb32, adj, sw32, spec, pw32)
    got = bin_mp.mp_stack_bwd(emb32, adj, sw32, spec, saved32, g32_, pw32)
    want = bin_mp.mp_stack_bwd_plain(emb32, adj, sw32, spec, ref_saved32, g32_, pw32)
    torch.cuda.synchronize()
    _, rel = _max_rel(list(zip(flat(got), flat(want), [None] * len(flat(got)))))
    print(f"[train-kernel] mp_stack_bwd fp32: rel={rel:.3e} (tol {FP32_TOL:g})", flush=True)
    if not rel <= FP32_TOL:
        raise AssertionError(f"mp_stack_bwd fp32: rel err {rel:.3e} > {FP32_TOL:g}")
    bwd_record("train-kernel", "mp_stack_bwd", torch.float32,
               lambda: bin_mp.mp_stack_bwd(emb32, adj, sw32, spec, saved32, g32_, pw32),
               time_ms(lambda: bin_mp.mp_stack_bwd_plain(emb32, adj, sw32, spec, ref_saved32, g32_,
                                                         pw32), iters=3))
    del saved32, ref_saved32, got, want

    # --- kernel 1c: the projection fold's backward alone, from the walk's
    # fp32 cotangent of x0 (the kernel of one block a bin writes dt0 over it)
    g_src = torch.randn(sw.Dp, A, generator=gen, device=dev) * 0.05
    g_src[D:] = 0
    g32 = g_src.clone()
    got = bin_mp.mp_stack_bwd_proj(emb, g32.copy_(g_src), pw, act, ab)
    again = bin_mp.mp_stack_bwd_proj(emb, g32.copy_(g_src), pw, act, ab)
    want = bin_mp._proj_bwd_plain(emb, g_src.clone(), pw, act)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
        raise AssertionError("mp_stack_bwd_proj: a rerun is not bit-equal")
    ops = 3 * 2 * n * E * D
    # the function's own: emb, g32 and the weights read; demb, d_kb and d_bb
    # written (dtc, the scratch handed to the d_kb contraction, not counted)
    nbytes = 2 * E * A * isz + 4 * sw.Dp * A + (E * D + D) * isz + 4 * (E * D + D)
    plain_ms = time_ms(lambda: bin_mp._proj_bwd_plain(emb, g_src.clone(), pw, act), iters=5)
    run = lambda: bin_mp.mp_stack_bwd_proj(emb, g32, pw, act, ab)  # noqa: E731
    ms, timing, _ = bwd_record("train-kernel", "mp_stack_bwd_proj", dt, run, plain_ms)
    check_route("train-kernel", "mp_stack_bwd_proj", run, dt, bin_mp.mp_stack_bwd_proj.routes,
                new="wgmma")
    record("mp_stack_bwd_proj", [(a, r, None) for a, r in zip(got, want)], ms, plain_ms, ops,
           nbytes)
    res["mp_stack_bwd_proj"]["timing"] = timing
    proj_bwd_phases(marks_build, "train-kernel", emb, g_src, pw, act, ab)
    del g32, got, again, want

    # --- kernel 3: attention pool, forward and backward
    xo = out
    bin_attnpool.check_one_owner(pm)  # the kernels' precondition, on the loader's matrix
    fwd = bin_attnpool.attnpool_fwd(emb, xo, pm, aw, act)
    fref = bin_attnpool.attnpool_fwd_plain(emb, xo, pm, aw, act)
    torch.cuda.synchronize()
    npm = int((pm != 0).sum())
    ops = 2 * n * E * Ds + 2 * n * H * (Ds + D) + 2 * npm * (Ds + D + 1)
    nbytes = (E + D) * A * isz + nb * mb * ab + 4 * ((Ds + D + 1) * B + H * A)
    again = bin_attnpool.attnpool_fwd(emb, xo, pm, aw, act)
    if not all(torch.equal(a, b_) for a, b_ in zip(fwd, again)):
        raise AssertionError("attnpool_fwd: a rerun is not bit-equal")
    plain_ms = time_ms(lambda: bin_attnpool.attnpool_fwd_plain(emb, xo, pm, aw, act), iters=5)
    run = lambda: bin_attnpool.attnpool_fwd(emb, xo, pm, aw, act)  # noqa: E731
    ms, timing, _ = bwd_record("train-kernel", "attnpool_fwd", dt, run, plain_ms)
    check_route("train-kernel", "attnpool_fwd", run, dt,
                bin_attnpool._launch_fwd.routes)
    record("attnpool_fwd", list(zip(fwd, fref, [None] * 4)), ms, plain_ms, ops, nbytes)
    res["attnpool_fwd"]["timing"] = timing
    attnpool_fwd_phases(marks_build, "train-kernel", emb, xo, pm, aw, act)
    # the fp32 form at the same shapes (the kernel of one block a bin), held to FP32_TOL
    with torch.no_grad():
        aw32 = bin_attnpool.prep_weights(W[:Ds].T, b[:Ds], score_k[:Ds], score_k[Ds:], score_b,
                                         torch.float32)
    emb32, xo32 = emb.float(), xo.float()
    _, rel = _max_rel(list(zip(bin_attnpool.attnpool_fwd(emb32, xo32, pm, aw32, act),
                               bin_attnpool.attnpool_fwd_plain(emb32, xo32, pm, aw32, act),
                               [None] * 4)))
    print(f"[train-kernel] attnpool_fwd fp32: rel={rel:.3e} (tol {FP32_TOL:g})", flush=True)
    if not rel <= FP32_TOL:
        raise AssertionError(f"attnpool_fwd fp32: rel err {rel:.3e} > {FP32_TOL:g}")
    run = lambda: bin_attnpool.attnpool_fwd(emb32, xo32, pm, aw32, act)  # noqa: E731
    bwd_record("train-kernel", "attnpool_fwd", torch.float32, run,
               time_ms(lambda: bin_attnpool.attnpool_fwd_plain(emb32, xo32, pm, aw32, act), iters=5))
    check_route("train-kernel", "attnpool_fwd", run, torch.float32,
                bin_attnpool._launch_fwd.routes)
    del emb32, xo32
    pool_step_host("train-kernel", emb, xo, pm, act,
                   (W[:Ds].T, b[:Ds], score_k[:Ds], score_k[Ds:], score_b))
    gps = torch.randn(Ds, B, generator=gen, device=dev) * 1e-3
    gpo = torch.randn(D, B, generator=gen, device=dev) * 1e-3
    gcov = torch.randn(B, generator=gen, device=dev) * 1e-3
    args = (emb, xo, pm, aw, act, fref[3], gps, gpo, gcov)
    bg = bin_attnpool.attnpool_bwd(*args)
    again = bin_attnpool.attnpool_bwd(*args)
    br = bin_attnpool.attnpool_bwd_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b_) for a, b_ in zip((bg[0], bg[1], *bg[2]),
                                                   (again[0], again[1], *again[2]))):
        raise AssertionError("attnpool_bwd: a rerun is not bit-equal")
    dks_scale = float(br[2][2].abs().max())  # d_sb's exact value is 0: held to d_ks's scale
    pairs = [(bg[0], br[0], None), (bg[1], br[1], None)]
    pairs += [(a, r, dks_scale if i == 4 else None) for i, (a, r) in enumerate(zip(bg[2], br[2]))]
    ops = 3 * 2 * n * E * Ds + 4 * 2 * n * H * (Ds + D) + 2 * npm * (Ds + D)
    nbytes = (2 * E + 2 * D) * A * isz + nb * mb * ab + 4 * (H * A + (Ds + D + 1) * B) + 4 * (E * Ds)
    plain_ms = time_ms(lambda: bin_attnpool.attnpool_bwd_plain(*args), iters=5)
    ms, timing, names = bwd_record("train-kernel", "attnpool_bwd", dt,
                                   lambda: bin_attnpool.attnpool_bwd(*args), plain_ms)
    check_pool_route("train-kernel", "attnpool_bwd", names)
    record("attnpool_bwd", pairs, ms, plain_ms, ops, nbytes)
    res["attnpool_bwd"]["timing"] = timing
    attnpool_phases(marks_build, "train-kernel", *args)
    return res


def check_route(tag: str, name: str, fn, dt, routes, new: str = "tiles", old: str = "bins",
                fp32_new: bool = False) -> None:
    """Print which kernel one call of ``fn`` launched, by a wrapper's route
    counts ``routes`` (set to 0 just before the call); fail unless a bf16
    call launched ``new`` once and ``old`` never, and an fp32 call ``old``
    once (``new`` once where ``fp32_new``: kernel 6's tiles take fp32 too)."""
    for k in routes:
        routes[k] = 0
    fn()
    torch.cuda.synchronize()
    got = (routes[new], routes[old])
    print(f"[{tag}] {name} {str(dt)[6:]}: {new if got[0] else old} ({got[0]} + {got[1]} "
          "launches a call)", flush=True)
    if got != ((1, 0) if dt == torch.bfloat16 or fp32_new else (0, 1)):
        raise AssertionError(f"{name} {dt}: routes {routes}")


def pool_step_host(tag, emb, xo, pm, act, weights, spec=None) -> None:
    """The attention pool through autograd, forward and backward, as a
    training step runs it: host µs a step (``host_us``) and the gathers of
    the tiled kernels' weight stream (``pool_stream``) a step."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool

    leaves = [t.detach().clone().requires_grad_(True) for t in weights]

    def step():
        outs = bin_attnpool.binned_attnpool_proj_t(emb, leaves[0], leaves[1], act, xo, pm,
                                                    *leaves[2:], embed_spec=spec)
        torch.autograd.backward(outs[:3], [torch.ones_like(o) for o in outs[:3]])

    real = bin_attnpool.pool_stream
    gathers = []
    bin_attnpool.pool_stream = lambda w: gathers.append(1) or real(w)
    try:
        step()
        torch.cuda.synchronize()
        n = len(gathers)
        hus = host_us(step, calls=20)
    finally:
        bin_attnpool.pool_stream = real
    print(f"[{tag}] attention pool through autograd (forward + backward): host {hus:.1f} us a "
          f"step; weight-stream gathers a step {n}", flush=True)


def check_pool_route(tag: str, name: str, names) -> None:
    """Print which backward kernel and contraction a pool call launched (the
    profiler's kernel names); fail unless a bf16 call launched the tiled
    backward once, with one grouped contraction and no split-K ``wgrad``."""
    tiled = launches_named(names, "attnpool_bwd_tile_kernel")
    group = launches_named(names, "wgrad_group")
    split = launches_named(names, "wgrad_kernel") + launches_named(names, "wgrad_vocab")
    print(f"[{tag}] {name}: rerun bit-equal=True; "
          f"{'the tiled kernel' if tiled else 'one block a bin'}; wgrad_group x{group:g}, "
          f"split-K wgrad x{split:g}", flush=True)
    if not (tiled == 1 and group == 1 and split == 0):
        raise AssertionError(f"{name}: kernels {names}")


def time_ms_reset(fn, reset, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms of ``fn`` on the card, with ``reset`` (untimed) before each
    call: CUDA events around each call alone."""
    for _ in range(warmup):
        reset()
        fn()
    total = 0.0
    for _ in range(iters):
        reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def fold_inputs(model, batch, dt):
    """The embedding fold's operands of a batch: the code rows (F, A) int32,
    the tables' block-diagonal table in the kernels' form, and the fp32
    table (as the model hands it to the ops)."""
    from aimnet_x2d_tpu_torch.ops import embed

    names = ("atom_type", "hydrogen_count", "degree", "hybridization")
    tables = [getattr(model, f"{k}_embedding").weight.detach() for k in names]
    codes = embed.code_rows([getattr(batch, k) for k in names])
    bd = embed.blockdiag_table_t(tables)
    return codes, embed.prep_vocab(bd, tuple(t.shape[0] for t in tables), dt), bd


def check_fold_kernels(pkg, cfg, model, batch, seed: int, marks_build) -> dict:
    """[fold-kernel]: kernel 1c-vocab at both sites (stack forward, the
    projection's backward, attention pool forward and backward) against
    their plain versions at the flagship training shapes, fp32 and bf16,
    timed, with bounds; each backward twice, bit-equal; the pool's backward
    (bf16) split by phase (``attnpool_phases`` on ``marks_build``)."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp
    from aimnet_x2d_tpu_torch.ops.embed import embed_from_codes

    dev = torch.device("cuda")
    adj, pm = batch.bin_adj, batch.pool_mat
    nb, ab, _ = adj.shape
    mb = pm.shape[1]
    A, B = nb * ab, nb * mb
    D, Ds, H = cfg.x_other_dim, cfg.x_self_dim, cfg.attention_num_heads
    E = 4 * cfg.embedding_dim
    L, nblk = cfg.num_message_passing_layers, cfg.shell_conv_num_mlp_layers
    n = int(batch.atom_mask.sum())
    nnz = int((adj != 0).sum())
    npm = int((pm != 0).sum())
    act = cfg.activation_type
    spec = bin_mp.StackSpec(act, 0.05, 0x1234567)
    w_layer = 2 * D * 2 * D + nblk * 2 * D * D
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        isz = 2 if dt == torch.bfloat16 else 4
        codes, vt, bd32 = fold_inputs(model, batch, dt)
        F, SV = codes.shape[0], vt.offsets[-1]
        if dt == torch.float32:
            print(f"[fold-kernel] shapes nb={nb} ab={ab} mb={mb} A={A} real atoms={n} E={E} "
                  f"sum of V={SV} (vocabularies {vt.sizes}) Ds={Ds} Do={D} H={H}", flush=True)
        with torch.no_grad():
            sw = bin_mp.stack_weights([layer.stack_weights() for layer in model.message_passing_layers],
                                      dt)
            W, b = model.embedding_projection.weight, model.embedding_projection.bias
            pw = bin_mp.prep_proj(W[Ds:].T, b[Ds:], dt, sw.Dp)
            score_k, score_b = model.pooling._score_fold(model.concat_self_other.weight.T,
                                                          model.concat_self_other.bias)
            aw = bin_attnpool.prep_weights(W[:Ds].T, b[:Ds], score_k[:Ds], score_k[Ds:], score_b,
                                           dt)
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        lookup = 4 * F * A + E * SV * isz  # the codes and the table, in place of emb's E*A

        def record(name, pairs, ms, plain_ms, ops, nbytes, tol, same=None):
            abs_err, rel = _max_rel(pairs)
            t_ops, t_bytes = ops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_S
            bound_ms = 1e3 * max(t_ops, t_bytes)
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            print(f"[fold-kernel] {name} {str(dt)[6:]}: max_abs_err={abs_err:.3e} rel={rel:.3e} "
                  f"(tol {tol:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by}; {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)"
                  + ("" if same is None else f"; twice bit-equal {same}"), flush=True)
            if not rel <= tol or same is False:
                raise AssertionError(f"{name} {dt}: rel err {rel:.3e} > {tol:g}, or two runs "
                                     f"differ ({same})")
            res[(name, dt)] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

        f32 = dt == torch.float32
        # --- the stack's training forward, the fold's input looked up
        out, saved = bin_mp.mp_stack_fwd_train_vocab(codes, adj, sw, spec, pw, vt)
        ref, ref_saved = bin_mp.mp_stack_train_plain(codes, adj, sw, spec, pw, vt)
        # the lookup is exact: the emb form computes the same bits
        out_e, saved_e = bin_mp.mp_stack_fwd_train(embed_from_codes(codes, vt), adj, sw, spec, pw)
        torch.cuda.synchronize()
        same = torch.equal(out, out_e) and all(torch.equal(a, b) for a, b in zip(saved, saved_e))
        print(f"[fold-kernel] mp_stack_fwd_train_vocab {str(dt)[6:]}: equal to the emb form "
              f"{same}", flush=True)
        if not same:
            raise AssertionError(f"mp_stack_fwd_train_vocab {dt}: differs from the emb form")
        del out_e, saved_e
        ops = 2 * n * E * D + L * (2 * nnz * D + n * 2 * w_layer)
        nbytes = lookup + (D * A + L * D * A) * isz + nb * ab * ab + (L * w_layer + E * D) * isz
        plain_ms = time_ms(lambda: bin_mp.mp_stack_train_plain(codes, adj, sw, spec, pw, vt),
                           iters=5)
        ms, timing, names = bwd_record(
            "fold-kernel", "mp_stack_fwd_train_vocab", dt,
            lambda: bin_mp.mp_stack_fwd_train_vocab(codes, adj, sw, spec, pw, vt), plain_ms)
        check_stack_route("fold-kernel", "mp_stack_fwd_train_vocab", names, dt)
        record("mp_stack_fwd_train_vocab",
               [(out, ref, None)] + [(a, r, None) for a, r in zip(saved, ref_saved)],
               ms, plain_ms, ops, nbytes, 1e-4 if f32 else TRAIN_TOL)
        res[("mp_stack_fwd_train_vocab", dt)]["timing"] = timing
        # --- the projection's backward under the fold, from the walk's
        # fp32 cotangent of x0 (which the kernel overwrites: reset per call)
        g_src = torch.randn(sw.Dp, A, generator=gen, device=dev) * 0.05
        g_src[D:] = 0
        g32 = torch.empty_like(g_src)
        run = lambda: bin_mp.mp_stack_bwd_vocab(codes, g32, pw, vt, act, ab)  # noqa: E731
        got = (g32.copy_(g_src), run())[1]
        again = (g32.copy_(g_src), run())[1]
        want = bin_mp.mp_stack_bwd_vocab_plain(codes, g_src.clone(), pw, vt, act)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        ops = 3 * 2 * n * E * D
        nbytes = lookup + 4 * D * A + E * D * isz + 4 * (E * SV + E * D + D)
        # timed on the cotangent as the last call left it (the kernel of one
        # block a bin writes dt0 over it: the same work, other values)
        plain_ms = time_ms_reset(lambda: bin_mp.mp_stack_bwd_vocab_plain(codes, g32, pw, vt, act),
                                 lambda: g32.copy_(g_src), iters=3)
        ms, timing, _ = bwd_record("fold-kernel", "mp_stack_bwd_vocab", dt, run, plain_ms)
        check_route("fold-kernel", "mp_stack_bwd_vocab", run, dt,
                    bin_mp.mp_stack_bwd_vocab.routes, new="wgmma")
        record("mp_stack_bwd_vocab", [(a, r, None) for a, r in zip(got, want)], ms, plain_ms,
               ops, nbytes, 1e-4 if f32 else TRAIN_TOL, same)
        res[("mp_stack_bwd_vocab", dt)]["timing"] = timing
        if not f32:
            proj_bwd_phases(marks_build, "fold-kernel", codes, g_src, pw, act, ab, vt=vt)
        # --- the attention pool, forward and backward
        xo = out
        fwd = bin_attnpool.attnpool_fwd_vocab(codes, xo, pm, aw, act, vt)
        fref = bin_attnpool.attnpool_fwd_vocab_plain(codes, xo, pm, aw, act, vt)
        torch.cuda.synchronize()
        ops = 2 * n * E * Ds + 2 * n * H * (Ds + D) + 2 * npm * (Ds + D + 1)
        nbytes = lookup + D * A * isz + nb * mb * ab + 4 * ((Ds + D + 1) * B + H * A)
        again = bin_attnpool.attnpool_fwd_vocab(codes, xo, pm, aw, act, vt)
        emb_form = bin_attnpool.attnpool_fwd(embed_from_codes(codes, vt), xo, pm, aw, act)
        torch.cuda.synchronize()
        same = (all(torch.equal(a, b_) for a, b_ in zip(fwd, again))
                and all(torch.equal(a, b_) for a, b_ in zip(fwd, emb_form)))
        print(f"[fold-kernel] attnpool_fwd_vocab {str(dt)[6:]}: a rerun and the emb form "
              f"bit-equal {same}", flush=True)
        del emb_form
        plain_ms = time_ms(lambda: bin_attnpool.attnpool_fwd_vocab_plain(codes, xo, pm, aw, act,
                                                                          vt), iters=5)
        run = lambda: bin_attnpool.attnpool_fwd_vocab(codes, xo, pm, aw, act, vt)  # noqa: E731
        ms, timing, _ = bwd_record("fold-kernel", "attnpool_fwd_vocab", dt, run, plain_ms)
        check_route("fold-kernel", "attnpool_fwd_vocab", run, dt,
                    bin_attnpool._launch_fwd.routes)
        record("attnpool_fwd_vocab", list(zip(fwd, fref, [None] * 4)), ms, plain_ms, ops, nbytes,
               1e-5 if f32 else TRAIN_TOL, same)
        res[("attnpool_fwd_vocab", dt)]["timing"] = timing
        if not f32:
            attnpool_fwd_phases(marks_build, "fold-kernel", codes, xo, pm, aw, act, vt=vt)
            pool_step_host("fold-kernel", None, xo, pm, act,
                           (W[:Ds].T, b[:Ds], score_k[:Ds], score_k[Ds:], score_b),
                           (codes, bd32, vt.sizes))
        gps = torch.randn(Ds, B, generator=gen, device=dev) * 1e-3
        gpo = torch.randn(D, B, generator=gen, device=dev) * 1e-3
        gcov = torch.randn(B, generator=gen, device=dev) * 1e-3
        args = (codes, xo, pm, aw, act, fref[3], gps, gpo, gcov, vt)
        bg = bin_attnpool.attnpool_bwd_vocab(*args)
        again = bin_attnpool.attnpool_bwd_vocab(*args)
        br = bin_attnpool.attnpool_bwd_vocab_plain(*args)
        torch.cuda.synchronize()
        if not f32:
            attnpool_phases(marks_build, "fold-kernel", *args[:9], vt=vt)
        same = all(torch.equal(a, b_) for a, b_ in zip((bg[0], bg[1], *bg[2]),
                                                      (again[0], again[1], *again[2])))
        dks_scale = float(br[2][2].abs().max())  # d_sb's exact value is 0: held to d_ks's scale
        pairs = [(bg[0], br[0], None), (bg[1], br[1], None)]
        pairs += [(a, r, dks_scale if i == 4 else None)
                  for i, (a, r) in enumerate(zip(bg[2], br[2]))]
        ops = 3 * 2 * n * E * Ds + 4 * 2 * n * H * (Ds + D) + 2 * npm * (Ds + D)
        nbytes = (lookup + 2 * D * A * isz + nb * mb * ab + 4 * (H * A + (Ds + D + 1) * B)
                  + 4 * (E * Ds + E * SV))
        plain_ms = time_ms(lambda: bin_attnpool.attnpool_bwd_vocab_plain(*args), iters=5)
        ms, timing, names = bwd_record("fold-kernel", "attnpool_bwd_vocab", dt,
                                       lambda: bin_attnpool.attnpool_bwd_vocab(*args), plain_ms)
        if not f32:
            check_pool_route("fold-kernel", "attnpool_bwd_vocab", names)
        record("attnpool_bwd_vocab", pairs, ms, plain_ms, ops, nbytes,
               1e-4 if f32 else TRAIN_TOL, same)
        res[("attnpool_bwd_vocab", dt)]["timing"] = timing
    return res


def fold_compare(pkg, cfg, batch, seed: int) -> None:
    """[fold-train], after the CLI: on one card-resident batch, the
    training forward with the switch on against off (bit-equal), then the
    train step in blocks off, on, on, off: host-clock medians, launches of
    the folded and unfolded kernels per step, device time of one step
    each (torch.profiler)."""
    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp
    from aimnet_x2d_tpu_torch.training import trainer

    model = pkg.models.gnn.GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed)))
    model.to("cuda").train()
    task = "multitask" if cfg.output_dim > 1 else "regression"
    loss_fn = trainer.make_loss_fn(trainer.TrainConfig(task_type=task))
    opt = trainer.Optimizer(model.parameters(), 1.0)

    def switch(on):
        if on:
            os.environ["AIMNET_EMBED_FOLD"] = "1"
        else:
            os.environ.pop("AIMNET_EMBED_FOLD", None)

    preds = []
    for on in (True, False):
        switch(on)
        with torch.no_grad():
            gen = torch.Generator(device="cuda").manual_seed(seed)
            preds.append(model(batch, train=True, drop_seed=5, generator=gen).predictions)
    equal = torch.equal(*preds)
    print(f"[fold-train] training forward, fold on vs off on one batch: bit-equal {equal}",
          flush=True)
    if not equal:
        raise AssertionError("the folded training forward differs from the unfolded one")

    folded = (bin_mp.mp_stack_fwd_train_vocab, bin_mp.mp_stack_bwd_vocab,
              bin_attnpool.attnpool_fwd_vocab, bin_attnpool.attnpool_bwd_vocab)
    unfolded = (bin_mp.mp_stack_fwd_train, bin_attnpool.attnpool_fwd, bin_attnpool.attnpool_bwd)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    step = lambda: trainer.train_step(model, opt, batch, 5e-4, loss_fn, 5, gen)  # noqa: E731
    ms = {True: [], False: []}
    per_step = {}
    for on in (False, True, True, False):
        switch(on)
        for c in folded + unfolded:
            c.launches = 0
        block = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            block.append(1e3 * (time.perf_counter() - t0))
        ms[on] += block[1:]  # the first step of a block warms its kernels
        per_step[on] = {c.__name__: c.launches / 6 for c in folded + unfolded}
    want_on = {c.__name__: 1.0 for c in folded} | {c.__name__: 0.0 for c in unfolded}
    want_off = {c.__name__: 0.0 for c in folded} | {c.__name__: 1.0 for c in unfolded}
    print(f"[fold-train] launches per step: fold on {per_step[True]}; off {per_step[False]}",
          flush=True)
    if per_step[True] != want_on or per_step[False] != want_off:
        raise AssertionError("a folded step launched an unfolded kernel, or the reverse")
    device = {}
    for on in (True, False):
        switch(on)
        device[on] = profile_step(step, f"fold-train {'on' if on else 'off'}", top=8)
    switch(False)
    n_mol = int(batch.graph_mask.sum())
    for on in (True, False):
        med = float(np.median(ms[on]))
        dev_ms = "not measured" if device[on] is None else f"{device[on]:.3f} ms"
        print(f"[fold-train] fold {'on ' if on else 'off'}: step median {med:.3f} ms (host clock, "
              f"{len(ms[on])} steps, batch {n_mol} molecules), device {dev_ms}; steps "
              f"{[round(x, 3) for x in ms[on]]}", flush=True)


def fold_routes(pkg, cfgs, datasets, seed: int) -> None:
    """[fold-routes]: one train step of config 3 and of config 1 under the
    switch, card against CPU: the pool folds only for config 3 (attention
    pooling on the inject route), the stack only for config 1 (the stack
    route with mean pooling)."""
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp
    from aimnet_x2d_tpu_torch.training import trainer

    counters = (bin_mp.mp_stack_fwd_train_vocab, bin_mp.mp_stack_bwd_vocab,
                bin_attnpool.attnpool_fwd_vocab, bin_attnpool.attnpool_bwd_vocab,
                bin_mp.mp_stack_fwd_train, bin_attnpool.attnpool_fwd, bin_attnpool.attnpool_bwd)
    want = {
        "config3": {"attnpool_fwd_vocab": 1, "attnpool_bwd_vocab": 1},
        "config1": {"mp_stack_fwd_train_vocab": 1, "mp_stack_bwd_vocab": 1},
    }
    os.environ["AIMNET_EMBED_FOLD"] = "1"
    try:
        for name, cfg in cfgs.items():
            ds = datasets[name]
            T = cfg.output_dim
            sub = type(ds)(ds.smiles[:96], synthetic_targets(ds, T, seed)[:96],
                           ds.features[:96], ds.max_hops)
            sb = next(iter(BatchLoader(sub, 96)))
            task = "multitask" if T > 1 else "regression"
            loss_fn = trainer.make_loss_fn(trainer.TrainConfig(task_type=task))
            got = grads_card_vs_cpu(pkg, cfg, sb, loss_fn, seed, f"fold-routes {name}", counters)
            expect = {c.__name__: want[name].get(c.__name__, 0) for c in counters}
            print(f"[fold-routes] {name} ({pkg.models.gnn.mp_route(cfg)} route, "
                  f"{cfg.pooling_type} pooling): launches {got}", flush=True)
            if got != expect:
                raise AssertionError(f"{name}: launches {got}, want {expect}")
    finally:
        os.environ.pop("AIMNET_EMBED_FOLD", None)


def config3(cfg):
    """BASELINE.json config 3 at the flagship width (bench.py with
    BENCH_CHARGES_STEREO=1): the same model with partial-charge
    equilibration and stereochemistry on."""
    import dataclasses

    return dataclasses.replace(cfg, use_partial_charges=True, use_stereochemistry=True)


INJECT_PHASES = {
    "inject_bwd_kernel (one block a bin)": (
        "the bin's tables", "kb dpre into the fp32 scratch", "transpose (scratch read-modify-write)",
        "centres", "dx pass (reads the scratch)", "equilibration"),
    "inject_bwd_tile_kernel (a cluster of 64-atom tiles a bin)": (
        "the bin's tables, the dpre tile", "kb dpre (three ring products)",
        "transpose (distributed shared memory)", "centres, cluster barrier", "dx pass",
        "equilibration"),
    "inject_fwd_kernel (one block a bin)": (
        "the bin's tables and sums", "x' pass (to xct)", "cis/trans product (reads xct)",
        "centres (to the fp32 scratch)", "tet pass (reads the scratch)",
        "projection (reads xct)"),
    "inject_fwd_tile_kernel (one block a 64-atom tile)": (
        "the bin's tables and sums, the ring", "x' tile and the first source chunk",
        "cis/trans product (the bin's x' by chunks)", "centres' norms", "tet pass",
        "xct stores, projection, pre"),
}
ATTNPOOL_PHASES = {
    "attnpool_bwd_kernel (one block a bin)": (
        "setup", "recompute of t and v (to slabs)", "dw", "softmax backward",
        "x_self rows (dt to a slab)", "x_other rows", "demb or d_bd (reads the dt slab)"),
    "attnpool_bwd_tile_kernel (a cluster of 64-atom tiles a bin)": (
        "setup, the emb tile", "recompute of t (ring products)", "dw",
        "softmax backward (t_mol over the cluster)", "x_self rows (dt over t)", "x_other rows",
        "dt slab, demb or d_bd (ring products)", "partials over the cluster"),
    "attnpool_fwd_kernel (one block a bin)": (
        "setup (bb, the molecules)", "projection (v to the slab)", "scores", "softmax",
        "wbar and coverage", "x_self pools", "x_other pools"),
    "attnpool_fwd_tile_kernel (a cluster of 64-atom tiles a bin)": (
        "setup (the emb tile, the molecules, the one-hot)", "products (v on chip)", "scores",
        "softmax (two cluster exchanges), attn", "wbar and coverage",
        "x_self pools (membership product)", "x_other pools (membership product)",
        "partials over the cluster"),
}


STACK_PHASES = ("prologue (copy or fold)", "saved inputs and biases", "cluster barrier",
                "aggregation", "W_in, the MLP blocks and W_s", "residual", "output store")


def start_marks_build():
    """Start nvcc on ``csrc/inject.cu`` with ``-DINJECT_MARKS``, on
    ``csrc/attnpool.cu`` with ``-DATTNPOOL_MARKS``, on ``csrc/mp_stack.cu``
    with ``-DMP_STACK_MARKS``, on ``csrc/mp_ext.cu`` with ``-DMP_EXT_MARKS``,
    on ``csrc/bin_pool.cu`` with ``-DBIN_POOL_MARKS``, on
    ``csrc/mp_stack_bwd.cu`` with ``-DMP_STACK_BWD_MARKS`` and on
    ``csrc/fused_edge.cu`` with ``-DFUSED_EDGE_MARKS`` beside the
    kernels' own build: kernel 4's kernels, the attention pool's kernels,
    kernel 5's forward, kernel 6's kernels and kernels 7 and 8 then record a
    ``%globaltimer`` mark per block, after a block barrier, at every phase
    boundary (7 and 8 with their warps' clocks by phase), and the stack
    forward's kernels and the projection fold's backward each phase's time
    summed over the layers or tiles, as cumulative marks.  Returns
    {source: (the nvcc process, the library's path)}."""
    from aimnet_x2d_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name, flag in (("inject", "-DINJECT_MARKS"), ("attnpool", "-DATTNPOOL_MARKS"),
                       ("mp_stack", "-DMP_STACK_MARKS"), ("mp_ext", "-DMP_EXT_MARKS"),
                       ("bin_pool", "-DBIN_POOL_MARKS"), ("mp_stack_bwd", "-DMP_STACK_BWD_MARKS"),
                       ("fused_edge", "-DFUSED_EDGE_MARKS")):
        out = cuda_build.BUILD_DIR / f"{name}_marks.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, flag, "-o", str(out),
               str(cuda_build.CSRC / f"{name}.cu")]
        builds[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE), out)
    return builds


_MARKS_LIBS: dict = {}


def marks_lib(marks_build, name: str):
    """The loaded marked build of ``csrc/<name>.cu`` (waiting for its nvcc
    once)."""
    import ctypes

    if name not in _MARKS_LIBS:
        proc, path = marks_build[name]
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}.cu with marks: nvcc exit {proc.returncode}\n"
                               f"{err.decode()}")
        _MARKS_LIBS[name] = ctypes.CDLL(str(path))
    return _MARKS_LIBS[name]


def print_phases(tag: str, what: str, phases: dict, launches: dict, n_marks: int, set_marks,
                 error_string) -> dict:
    """Launch each kernel of ``launches`` ({name: (blocks, launch)}) of a
    marked build twice with its marks at a (blocks, n_marks) buffer; print,
    per kernel, the mean time a block spends in each phase, its share of a
    block's time, and the span from the first mark to the last (the marks'
    barriers included).  Returns each kernel's marks, (blocks, n_marks)."""
    dev = torch.device("cuda")
    out = {}
    for name, (blocks, launch) in launches.items():
        n = len(phases[name]) + 1
        marks = torch.zeros(blocks, n_marks, dtype=torch.int64, device=dev)
        if set_marks(marks.data_ptr()) != 0:
            raise RuntimeError(f"{what}: setting the marks failed")
        for _ in range(2):  # a warm-up launch, then the one read
            marks.zero_()
            status = launch()
            if status != 0:
                raise RuntimeError(f"{name}: {error_string(status).decode()}")
            torch.cuda.synchronize()
        m = marks.cpu().numpy()[:, :n].astype(np.float64)
        if not (m > 0).all():
            raise AssertionError(f"{name}: a block recorded no mark")
        per = np.diff(m, axis=1).mean(0) / 1e3
        parts = "; ".join(f"{p} {v:.2f} us ({100 * v / per.sum():.1f}%)"
                          for p, v in zip(phases[name], per))
        print(f"[{tag}] {what} phases, {name}: {blocks} blocks, span "
              f"{(m[:, -1].max() - m[:, 0].min()) / 1e6:.4f} ms (marked build), a block "
              f"{per.sum():.2f} us: {parts}", flush=True)
        out[name] = marks.cpu().numpy()
    return out


def inject_phases(marks_build, x, tables, iw, xct, dpre) -> None:
    """Kernel 4 split by phase (``[c3-kernel]``): the backward and forward
    kernels of the marked build -- the tiled ones in bf16 -- launched twice
    on these inputs (``print_phases``)."""
    import ctypes

    from aimnet_x2d_tpu_torch.ops import bin_inject, bin_mp

    lib = bin_inject.type_lib(marks_lib(marks_build, "inject"))
    lib.inject_bwd_marks.argtypes = [ctypes.c_void_p]
    lib.inject_bwd_marks.restype = ctypes.c_int
    dev, dt = x.device, x.dtype
    D, A = x.shape
    nb, ab, _ = tables[4].shape
    mb, tc, Dp = tables[1].shape[1], tables[2].shape[2], iw.sw.Dp
    ptrs = [t.data_ptr() for t in (x, *tables)]
    dx = torch.empty(D, A, dtype=dt, device=dev)
    ch = torch.empty(nb * 4 * tc * Dp, dtype=torch.float32, device=dev)
    w32 = torch.empty(3 * Dp, A, dtype=torch.float32, device=dev)
    dcct = torch.empty(Dp, A, dtype=dt, device=dev)
    pre = torch.empty(D, A, dtype=dt, device=dev)
    xct2 = torch.empty_like(xct)
    stream, bf16 = bin_mp._stream(dev), int(dt == torch.bfloat16)
    bwd = {"inject_bwd_kernel (one block a bin)": (nb, lambda: lib.inject_bwd(
        *ptrs, iw.flat_t.data_ptr(), xct.data_ptr(), dpre.data_ptr(), w32.data_ptr(),
        dcct.data_ptr(), ch.data_ptr(), dx.data_ptr(), bf16, D, Dp, A, nb, mb, ab, tc, stream))}
    if bf16:
        kbs = bin_inject.kb_stream(iw)
        bwd["inject_bwd_tile_kernel (a cluster of 64-atom tiles a bin)"] = (
            nb * ab // 64, lambda: lib.inject_bwd_tiles(
                *ptrs, kbs.data_ptr(), xct.data_ptr(), dpre.data_ptr(), ch.data_ptr(),
                dx.data_ptr(), D, Dp, A, nb, mb, ab, tc, stream))
    print_phases("c3-kernel", "inject_bwd", INJECT_PHASES, bwd, 8, lib.inject_bwd_marks,
                 lib.inject_error_string)
    kbT = bin_inject.kbT_stream(iw)
    fwd = {"inject_fwd_kernel (one block a bin)": (nb, lambda: lib.inject_fwd(
        *ptrs, iw.flat.data_ptr(), pre.data_ptr(), xct2.data_ptr(), ch.data_ptr(), bf16, D, Dp,
        A, nb, mb, ab, tc, stream))}
    if bf16:
        fwd["inject_fwd_tile_kernel (one block a 64-atom tile)"] = (
            nb * ab // 64, lambda: lib.inject_fwd_tiles(
                *ptrs, kbT.data_ptr(), iw.b.data_ptr(), pre.data_ptr(), xct2.data_ptr(), D, Dp,
                A, nb, mb, ab, tc, stream))
    print_phases("c3-kernel", "inject_fwd", INJECT_PHASES, fwd, 8, lib.inject_bwd_marks,
                 lib.inject_error_string)


def attnpool_phases(marks_build, tag, emb, xo, pm, w, act, attn, gps, gpo, gcov, vt=None) -> None:
    """The attention pool's backward split by phase (``[train-kernel]``,
    ``[fold-kernel]`` with ``vt``): both backward kernels of the marked
    build -- the tiled one in bf16 -- launched twice on these
    inputs (``print_phases``); ``emb`` is the code rows under the fold."""
    import ctypes

    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp
    from aimnet_x2d_tpu_torch.utils.activation import ACTIVATION_CODES

    name = "attnpool_bwd" if vt is None else "attnpool_bwd_vocab"
    lib = marks_lib(marks_build, "attnpool")
    marks = lib.attnpool_marks
    vp, i = ctypes.c_void_p, ctypes.c_int
    marks.argtypes = [vp]
    marks.restype = i
    lib.attnpool_bwd.argtypes = [vp] * 14 + [i] * 10 + [vp]
    lib.attnpool_bwd_vocab.argtypes = [vp, vp, vp] + [i] + [vp] * 12 + [i] * 10 + [vp]
    lib.attnpool_bwd_tiles.argtypes = [vp, vp, vp, vp, i] + [vp] * 13 + [i] * 9 + [vp]
    lib.attnpool_error_string.argtypes = [i]
    lib.attnpool_error_string.restype = ctypes.c_char_p
    dev, dt = xo.device, w.dtype
    nb, mb, ab = pm.shape
    (Dsp, E), H, Ds, (Do, A) = w.kbT.shape, attn.shape[0], w.Ds, xo.shape
    n_acc = vt.Df * vt.offsets[-1] if vt is not None else 0
    part = torch.empty(nb, Dsp + (Ds + Do) * H + H + n_acc, dtype=torch.float32, device=dev)
    work = torch.empty(3, Dsp, A, dtype=dt, device=dev)
    demb = torch.empty(E, A, dtype=dt, device=dev)
    dxo = torch.empty(Do, A, dtype=dt, device=dev)
    mid = (w.score.data_ptr(), attn.data_ptr(), gps.data_ptr(), gpo.data_ptr(), gcov.data_ptr())
    dims = (Ds, Dsp, Do, E, H, nb, mb, ab, ACTIVATION_CODES[act.lower()], bin_mp._stream(dev))
    bf16 = int(dt == torch.bfloat16)
    operands = (xo.data_ptr(), pm.data_ptr(), w.flat.data_ptr(), w.flat_t.data_ptr(), *mid,
                work.data_ptr(), part.data_ptr())
    if vt is None:
        old = lambda: lib.attnpool_bwd(emb.data_ptr(), *operands, demb.data_ptr(),  # noqa: E731
                                       dxo.data_ptr(), bf16, *dims)
        table = (None, None, None, 0)
    else:
        sizes = bin_mp._sizes_arg(vt)
        old = lambda: lib.attnpool_bwd_vocab(emb.data_ptr(), vt.bd.data_ptr(), sizes,  # noqa: E731
                                             len(vt.sizes), *operands, dxo.data_ptr(), bf16,
                                             *dims)
        table = (emb.data_ptr(), vt.bd.data_ptr(), sizes, len(vt.sizes))
    launches = {"attnpool_bwd_kernel (one block a bin)": (nb, old)}
    if bf16:
        ws = bin_attnpool.pool_stream(w)
        launches["attnpool_bwd_tile_kernel (a cluster of 64-atom tiles a bin)"] = (
            nb * ab // 64, lambda: lib.attnpool_bwd_tiles(
                emb.data_ptr() if vt is None else None, *table, xo.data_ptr(), pm.data_ptr(),
                w.flat.data_ptr(), ws.data_ptr(), *mid, work.data_ptr(), part.data_ptr(),
                demb.data_ptr() if vt is None else None, dxo.data_ptr(), *dims))
    print_phases(tag, name, ATTNPOOL_PHASES, launches, 10, marks, lib.attnpool_error_string)


def attnpool_fwd_phases(marks_build, tag, emb, xo, pm, w, act, vt=None) -> None:
    """The attention pool's forward split by phase (``[train-kernel]``,
    ``[fold-kernel]`` with ``vt``): the kernel of one block a bin and, where
    the source has it, the tiled one, of the marked build, launched twice on
    these inputs in bf16 (``print_phases``); ``emb`` is the code rows under
    the fold."""
    import ctypes

    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp
    from aimnet_x2d_tpu_torch.utils.activation import ACTIVATION_CODES

    name = "attnpool_fwd" if vt is None else "attnpool_fwd_vocab"
    lib = marks_lib(marks_build, "attnpool")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.attnpool_marks.argtypes = [vp]
    lib.attnpool_marks.restype = i
    lib.attnpool_fwd.argtypes = [vp] * 10 + [i] * 10 + [vp]
    lib.attnpool_fwd_vocab.argtypes = [vp, vp, vp] + [i] + [vp] * 9 + [i] * 10 + [vp]
    lib.attnpool_fwd_tiles.argtypes = [vp, vp, vp, vp, i] + [vp] * 9 + [i] * 9 + [vp]
    lib.attnpool_error_string.argtypes = [i]
    lib.attnpool_error_string.restype = ctypes.c_char_p
    dev, dt = xo.device, w.dtype
    nb, mb, ab = pm.shape
    (Dsp, E), H, Ds, (Do, A) = w.kbT.shape, w.sb.shape[0], w.Ds, xo.shape
    vbuf = torch.empty(Dsp, A, dtype=dt, device=dev)
    outs = (torch.empty(Ds, nb * mb, device=dev), torch.empty(Do, nb * mb, device=dev),
            torch.empty(nb * mb, device=dev), torch.empty(H, A, device=dev))
    outp = [o.data_ptr() for o in outs]
    dims = (Ds, Dsp, Do, E, H, nb, mb, ab, ACTIVATION_CODES[act.lower()], bin_mp._stream(dev))
    tail = (xo.data_ptr(), pm.data_ptr(), w.flat.data_ptr(), w.score.data_ptr(), vbuf.data_ptr(),
            *outp, int(dt == torch.bfloat16), *dims)
    if vt is None:
        old = lambda: lib.attnpool_fwd(emb.data_ptr(), *tail)  # noqa: E731
        table = (None, None, None, 0)
    else:
        sizes = bin_mp._sizes_arg(vt)
        old = lambda: lib.attnpool_fwd_vocab(emb.data_ptr(), vt.bd.data_ptr(), sizes,  # noqa: E731
                                             len(vt.sizes), *tail)
        table = (emb.data_ptr(), vt.bd.data_ptr(), sizes, len(vt.sizes))
    launches = {"attnpool_fwd_kernel (one block a bin)": (nb, old)}
    if dt == torch.bfloat16:
        ws = bin_attnpool.pool_stream(w)
        launches["attnpool_fwd_tile_kernel (a cluster of 64-atom tiles a bin)"] = (
            nb * ab // 64, lambda: lib.attnpool_fwd_tiles(
                emb.data_ptr() if vt is None else None, *table, xo.data_ptr(), pm.data_ptr(),
                w.flat.data_ptr(), ws.data_ptr(), w.score.data_ptr(), *outp, *dims))
    print_phases(tag, name, ATTNPOOL_PHASES, launches, 10, lib.attnpool_marks,
                 lib.attnpool_error_string)


def stack_phases(marks_build, tag, x, adj, sw, spec, pw=None) -> None:
    """The stack forward's training form split by phase (``[train-kernel]``):
    the kernel of one block a bin and, in bf16, the tile kernel, of the
    marked build of ``csrc/mp_stack.cu``, launched twice on
    these inputs (``print_phases``; each phase summed over the layers)."""
    import ctypes

    from aimnet_x2d_tpu_torch.ops import bin_mp
    from aimnet_x2d_tpu_torch.utils.activation import ACTIVATION_CODES

    lib = marks_lib(marks_build, "mp_stack")
    bin_mp.type_lib(lib)
    lib.mp_stack_marks.argtypes = [ctypes.c_void_p]
    lib.mp_stack_marks.restype = ctypes.c_int
    dev, dt = x.device, sw.dtype
    nb, ab, _ = adj.shape
    A, D, Dp, L = nb * ab, sw.D, sw.Dp, len(sw.layers)
    E = pw.E if pw is not None else 0
    first = 0 if pw is not None else 1
    out = torch.empty(D, A, dtype=dt, device=dev)
    xs = torch.empty(L - first, D, A, dtype=dt, device=dev)
    drop = spec.kernel_drop(dt)
    act, stream = ACTIVATION_CODES[spec.act.lower()], bin_mp._stream(dev)
    bf16 = int(dt == torch.bfloat16)
    launches = {"mp_stack_kernel (one block a bin)": (nb, lambda: lib.mp_stack_fwd_train(
        x.data_ptr(), out.data_ptr(), out.data_ptr(), adj.data_ptr(), sw.flat.data_ptr(),
        pw.flat.data_ptr() if pw is not None else None, xs.data_ptr(), bf16, D, Dp, E, A, nb, ab,
        L, sw.n_blocks, act, 0, first, *drop, stream))}
    if bf16:
        ws = bin_mp.fwd_weights(sw, pw)
        launches["stack_fwd_tile_kernel (a cluster of 64-atom tiles a bin)"] = (
            nb * ab // 64, lambda: lib.mp_stack_tiles(
                x.data_ptr(), None, None, None, 0, out.data_ptr(), xs.data_ptr(), adj.data_ptr(),
                ws.data_ptr(), D, Dp, E, A, nb, ab, L, sw.n_blocks, act, first, *drop, stream))
    marks = print_phases(tag, "mp_stack_fwd_train", {k: STACK_PHASES for k in launches},
                         launches, 11, lib.mp_stack_marks, lib.mp_stack_error_string)
    for name, m in marks.items():
        if "tile" in name:  # marks 8-10: the ring's waits, in the SM's clocks
            full, refills, clocks = m[:, 8:11].astype(np.float64).mean(0)
            print(f"[{tag}] mp_stack_fwd_train ring, {name}: a warp waits on landed weight "
                  f"stages {100 * full / 10 / clocks:.1f}% of its block's clocks; {refills:.0f} "
                  f"refills, {clocks:.0f} clocks a block", flush=True)


def ext_fwd_phases(marks_build, tag, xa, sw, spec) -> None:
    """Kernel 5's bf16 forward split by phase (``[halo-kernel]``): the old
    kernel (``ext_fwd_kernel``) of the marked build launched twice on these
    inputs (``print_phases``), then each product's warp clocks split into
    the products and their epilogues."""
    import ctypes

    from aimnet_x2d_tpu_torch.ops import bin_mp
    from aimnet_x2d_tpu_torch.utils.activation import ACTIVATION_CODES

    lib = marks_lib(marks_build, "mp_ext")
    vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.mp_ext_marks.argtypes = [vp]
    lib.mp_ext_marks.restype = i
    lib.mp_ext_fwd.argtypes = [vp] * 3 + [i] * 7 + [u, u, f, vp]
    lib.mp_ext_error_string.argtypes = [i]
    lib.mp_ext_error_string.restype = ctypes.c_char_p
    D, Dp, nblk, A = sw.D, sw.Dp, sw.n_blocks, xa.shape[1]
    out = torch.empty(D, A, dtype=sw.dtype, device=xa.device)
    args = (xa.data_ptr(), out.data_ptr(), sw.flat.data_ptr(), 1, D, Dp, A, nblk,
            ACTIVATION_CODES[spec.act.lower()], *spec.kernel_drop(sw.dtype),
            bin_mp._stream(xa.device))
    products = ["W_in"] + [f"{w}_{b}" for b in range(nblk) for w in ("W1", "W2")] + ["W_s"]
    phases = ["xa tile load", "biases"] + products[:-1] + ["W_s and the output store"]
    name = "ext_fwd_kernel (one block a 64-atom tile)"
    marks = print_phases(tag, "mp_ext_fwd", {name: phases}, {name: (A // 64,
                         lambda: lib.mp_ext_fwd(*args))}, 40, lib.mp_ext_marks,
                         lib.mp_ext_error_string)[name]
    clk = marks[:, 16:16 + 2 * len(products)].astype(np.float64).sum(0).reshape(-1, 2)
    print(f"[{tag}] mp_ext_fwd phases, {name}: warp clocks in each product (mma.sync) and its "
          "epilogue: " + "; ".join(
              f"{p} {100 * c[0] / c.sum():.1f}% products, {100 * c[1] / c.sum():.1f}% epilogue"
              for p, c in zip(products, clk)), flush=True)
    # the wgmma kernel: each warpgroup's SM clocks by part, summed over its tiles
    lib.mp_ext_fwd_wg.argtypes = [vp] * 3 + [i] * 6 + [u, u, f, vp]
    lib.mp_ext_fwd_wg.restype = i
    ws = bin_mp.ext_wg_weights(sw)
    grid = min(A // 128 + (A % 128 > 0), torch.cuda.get_device_properties(0).multi_processor_count)
    marks = torch.zeros(grid, 40, dtype=torch.int64, device=xa.device)
    if lib.mp_ext_marks(marks.data_ptr()) != 0:
        raise RuntimeError("mp_ext_fwd_wg: setting the marks failed")
    for _ in range(2):
        marks.zero_()
        status = lib.mp_ext_fwd_wg(xa.data_ptr(), out.data_ptr(), ws.data_ptr(), D, Dp, A, nblk,
                                   *args[8:])
        if status != 0:
            raise RuntimeError(f"mp_ext_fwd_wg: {lib.mp_ext_error_string(status).decode()}")
        torch.cuda.synchronize()
    m = marks.cpu().numpy().astype(np.float64)
    clock_khz = torch.cuda.get_device_properties(0).clock_rate if hasattr(
        torch.cuda.get_device_properties(0), "clock_rate") else None
    parts = ("xa waits", "weight waits", "products", "epilogues", "output store")
    for w in range(2):
        cw = m[:, 8 * w: 8 * w + 7].sum(0)
        tiles = cw[5]
        print(f"[{tag}] mp_ext_fwd phases, ext_fwd_wg_kernel (warp-specialised wgmma), consumer "
              f"warpgroup {w}: {int(tiles)} tiles, {cw[6] / max(tiles, 1) / 1e3:.2f} kclocks a tile "
              "(its span over its tiles): " + "; ".join(
                  f"{p} {100 * v / cw[6]:.1f}%" for p, v in zip(parts, cw[:5])), flush=True)
    cw, cx = m[:, 16:23].sum(0), m[:, 24:31].sum(0)
    print(f"[{tag}] mp_ext_fwd phases, ext_fwd_wg_kernel producers: the weights' warp waits "
          f"for a free slot {100 * cw[0] / max(cw[6], 1):.1f}% of its span, the xa warp for a "
          f"free buffer {100 * cx[1] / max(cx[6], 1):.1f}%; {grid} blocks"
          + (f", rated SM clock {clock_khz / 1e3:.0f} MHz" if clock_khz else ""), flush=True)


POOL6_PHASES = ("membership (serial)", "scores", "softmax max and denominator", "attn write",
                "head mean and coverage", "x_self pools", "x_other pools")
POOL6_TILE_PHASES = ("the tile's rows (bulk copies) and molecules", "scores",
                     "softmax over the cluster", "attn and wbar", "pool and coverage partials",
                     "sums over the cluster")


def pool6_fwd_phases(marks_build, tag, xs, xo, pm, ks, ko, b) -> None:
    """Kernel 6's forward split by phase (``[pool6-kernel]``): the kernel of
    one block a bin and the tile kernel of the marked build launched twice
    on these inputs (``print_phases``), each one's outputs then held against
    ``pool_fwd_plain`` at ``POOL6_TOL``."""
    import ctypes

    from aimnet_x2d_tpu_torch.ops import bin_mp, bin_pool

    lib = marks_lib(marks_build, "bin_pool")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bin_pool_marks.argtypes = [vp]
    lib.bin_pool_marks.restype = i
    lib.bin_pool_fwd.argtypes = [vp] * 8 + [i] * 7 + [vp]
    lib.bin_pool_error_string.argtypes = [i]
    lib.bin_pool_error_string.restype = ctypes.c_char_p
    nb, mb, ab = pm.shape
    (A, Ds), Do, H = xs.shape, xo.shape[1], ks.shape[1]
    dev = xs.device
    score = bin_pool._score(ks, ko, b)

    def outs_args():
        outs = (torch.empty(nb * mb, Ds, device=dev), torch.empty(nb * mb, Do, device=dev),
                torch.empty(nb * mb, device=dev), torch.empty(H, A, device=dev))
        return outs, (xs.data_ptr(), xo.data_ptr(), pm.data_ptr(), score.data_ptr(),
                      *[o.data_ptr() for o in outs], int(xs.dtype == torch.bfloat16), Ds, Do, H,
                      nb, mb, ab, bin_mp._stream(dev))

    name = "bin_pool_fwd_kernel (one block a bin)"
    outs, args = outs_args()
    phases, launches = {name: POOL6_PHASES}, {name: (nb, lambda: lib.bin_pool_fwd(*args))}
    got = {name: outs}
    lib.bin_pool_fwd_tiles.argtypes = [vp] * 8 + [i] * 7 + [vp]
    tiles = "bin_pool_fwd_tile_kernel (a cluster of 64-atom tiles a bin)"
    t_outs, t_args = outs_args()
    phases[tiles] = POOL6_TILE_PHASES
    launches[tiles] = (nb * ab // 64, lambda: lib.bin_pool_fwd_tiles(*t_args))
    got[tiles] = t_outs
    print_phases(tag, "bin_pool_fwd", phases, launches, 10, lib.bin_pool_marks,
                 lib.bin_pool_error_string)
    ref = bin_pool.pool_fwd_plain(xs, xo, pm, ks, ko, b)
    tol = POOL6_TOL[xs.dtype]
    for k, outs in got.items():
        abs_err, rel = _max_rel([(o, r, None) for o, r in zip(outs, ref)])
        print(f"[{tag}] bin_pool_fwd phases, {k}: marked build's outputs against the plain "
              f"version max_abs_err={abs_err:.3e} rel={rel:.3e} (tol {tol:g})", flush=True)
        if not rel <= tol:
            raise AssertionError(f"{k} (marked build) {xs.dtype}: rel err {rel:.3e} > {tol:g}")


POOL6_BWD_PHASES = ("membership (serial)", "attn and the head mean", "dw", "t_mol", "ds and d_b",
                    "dx and the x_self partials", "dx and the x_other partials")
POOL6_BWD_TILE_PHASES = ("the tile's rows, molecules, attn and wbar", "dw",
                         "t_mol over the cluster", "ds and d_b", "the weight partials and dx",
                         "sums over the cluster, dx's store")


def pool6_bwd_phases(marks_build, tag, xs, xo, pm, ks, ko, attn, gps, gpo, gcov) -> None:
    """Kernel 6's backward split by phase (``[pool6-kernel]``): the kernel of
    one block a bin and the tile kernel of the marked build, launched twice
    on these inputs (``print_phases``), each one's outputs then held against
    ``pool_bwd_plain`` at ``POOL6_TOL``."""
    import ctypes

    from aimnet_x2d_tpu_torch.ops import bin_mp, bin_pool

    lib = marks_lib(marks_build, "bin_pool")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bin_pool_marks.argtypes = [vp]
    lib.bin_pool_marks.restype = i
    lib.bin_pool_bwd.argtypes = [vp] * 11 + [i] * 7 + [vp]
    lib.bin_pool_error_string.argtypes = [i]
    lib.bin_pool_error_string.restype = ctypes.c_char_p
    nb, mb, ab = pm.shape
    (A, Ds), Do, H = xs.shape, xo.shape[1], ks.shape[1]
    dev = xs.device
    score = bin_pool._score(ks, ko)
    psize = (Ds + Do) * H + H
    gps, gpo, gcov = (g.float().contiguous() for g in (gps, gpo, gcov))

    def outs_args(n_part):
        outs = (torch.empty_like(xs), torch.empty_like(xo),
                torch.empty(n_part, psize, device=dev))
        return outs, (xs.data_ptr(), xo.data_ptr(), pm.data_ptr(), score.data_ptr(),
                      attn.data_ptr(), gps.data_ptr(), gpo.data_ptr(), gcov.data_ptr(),
                      *[o.data_ptr() for o in outs], int(xs.dtype == torch.bfloat16), Ds, Do, H,
                      nb, mb, ab, bin_mp._stream(dev))

    name = "bin_pool_bwd_kernel (one block a bin)"
    outs, args = outs_args(nb)
    phases, launches = {name: POOL6_BWD_PHASES}, {name: (nb, lambda: lib.bin_pool_bwd(*args))}
    got = {name: outs}
    lib.bin_pool_bwd_tiles.argtypes = [vp] * 11 + [i] * 7 + [vp]
    tiles = "bin_pool_bwd_tile_kernel (a cluster of 64-atom tiles a bin)"
    t_outs, t_args = outs_args(nb)
    phases[tiles] = POOL6_BWD_TILE_PHASES
    launches[tiles] = (nb * ab // 64, lambda: lib.bin_pool_bwd_tiles(*t_args))
    got[tiles] = t_outs
    print_phases(tag, "bin_pool_bwd", phases, launches, 10, lib.bin_pool_marks,
                 lib.bin_pool_error_string)
    ref = bin_pool.pool_bwd_plain(xs, xo, pm, ks, ko, attn, gps, gpo, gcov)
    tol = POOL6_TOL[xs.dtype]
    for k, (dxs, dxo, part) in got.items():
        red = part.sum(0)
        grads = (red[: Ds * H].view(Ds, H), red[Ds * H: (Ds + Do) * H].view(Do, H),
                 red[(Ds + Do) * H:])
        dks_scale = float(ref[2][0].abs().max())  # d_b cancels to 0: held to d_ks's scale
        abs_err, rel = _max_rel([(dxs, ref[0], None), (dxo, ref[1], None)]
                                + [(a, r, dks_scale if j == 2 else None)
                                   for j, (a, r) in enumerate(zip(grads, ref[2]))])
        print(f"[{tag}] bin_pool_bwd phases, {k}: marked build's outputs against the plain "
              f"version max_abs_err={abs_err:.3e} rel={rel:.3e} (tol {tol:g})", flush=True)
        if not rel <= tol:
            raise AssertionError(f"{k} (marked build) {xs.dtype}: rel err {rel:.3e} > {tol:g}")


PROJ_PHASES = ("start (biases)", "the lookup", "kb^T emb and its epilogue",
               "kb dtc and its epilogue", "the table accumulation", "the partials' store")


def proj_bwd_phases(marks_build, tag, x, g_src, pw, act, ab, vt=None) -> None:
    """The projection fold's backward split by phase, the emb form
    (``[train-kernel]``) or, with ``vt``, the embedding fold's
    (``[fold-kernel]``): the kernel of one block a bin of the marked build of
    ``csrc/mp_stack_bwd.cu`` and, where the shape takes it, the wgmma kernel,
    launched twice on these inputs (``print_phases``: each phase summed
    over a block's tiles); for the old kernel, each product's warp clocks
    split into the products and their epilogues."""
    from aimnet_x2d_tpu_torch.ops import bin_mp
    from aimnet_x2d_tpu_torch.utils.activation import ACTIVATION_CODES

    lib = marks_lib(marks_build, "mp_stack_bwd")
    bin_mp.type_lib_bwd(lib)
    dev, dt = g_src.device, pw.kbT.dtype
    Dp, A = g_src.shape
    E, nb = pw.E, A // ab
    g32 = g_src.clone()
    dtc = torch.empty(Dp, A, dtype=dt, device=dev)
    bf16, code = int(dt == torch.bfloat16), ACTIVATION_CODES[act.lower()]
    stream = bin_mp._stream(dev)
    if vt is None:
        demb = torch.empty(E, A, dtype=dt, device=dev)
        name = "bwd_proj_kernel (one block a bin)"
        launches = {name: (nb, lambda: lib.mp_stack_bwd_proj(
            x.data_ptr(), g32.copy_(g_src).data_ptr(), pw.flat.data_ptr(), pw.flat_t.data_ptr(),
            dtc.data_ptr(), demb.data_ptr(), bf16, Dp, E, A, nb, ab, code, stream))}
    else:
        part = torch.empty(nb, vt.Df * vt.offsets[-1], device=dev)
        name = "bwd_proj_vocab_kernel (one block a bin)"
        launches = {name: (nb, lambda: lib.mp_stack_bwd_proj_vocab(
            x.data_ptr(), vt.bd.data_ptr(), bin_mp._sizes_arg(vt), g32.copy_(g_src).data_ptr(),
            len(vt.sizes), pw.flat.data_ptr(), pw.flat_t.data_ptr(), dtc.data_ptr(),
            part.data_ptr(), bf16, Dp, E, A, nb, ab, code, stream))}
    marks = print_phases(tag, "mp_stack_bwd_proj", {name: PROJ_PHASES}, launches, 16,
                         lib.mp_stack_bwd_marks, lib.mp_stack_bwd_error_string)
    clk = marks[name][:, 8:12].astype(np.float64).mean(0)
    print(f"[{tag}] mp_stack_bwd_proj clocks, {name}: kb^T emb products "
          f"{100 * clk[0] / max(clk[0] + clk[1], 1):.1f}% / epilogue "
          f"{100 * clk[1] / max(clk[0] + clk[1], 1):.1f}%; kb dtc products "
          f"{100 * clk[2] / max(clk[2] + clk[3], 1):.1f}% / epilogue "
          f"{100 * clk[3] / max(clk[2] + clk[3], 1):.1f}% (warp clocks, a block's tiles)",
          flush=True)
    n_acc = vt.Df * vt.offsets[-1] if vt is not None else -1
    if not (bf16 and bin_mp._proj_takes_wg(lib, bf16, Dp, E, n_acc)):
        return
    # the wgmma kernel: its warpgroups' SM clocks by part, summed over the tiles
    blocks = min(A // 64, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty(blocks, Dp + max(n_acc, 0), device=dev)
    marks = torch.zeros(blocks, 16, dtype=torch.int64, device=dev)
    if lib.mp_stack_bwd_marks(marks.data_ptr()) != 0:
        raise RuntimeError("proj_bwd_wg_kernel: setting the marks failed")
    ws = bin_mp.proj_wg_weights(pw)
    table = ((None, x.data_ptr(), vt.bd.data_ptr(), bin_mp._sizes_arg(vt), len(vt.sizes))
             if vt is not None else (x.data_ptr(), None, None, None, 0))
    demb = torch.empty(E, A, dtype=dt, device=dev) if vt is None else None
    for _ in range(2):
        marks.zero_()
        status = lib.mp_stack_bwd_proj_wg(
            *table, g_src.data_ptr(), ws.data_ptr(), dtc.data_ptr(),
            demb.data_ptr() if demb is not None else None, part.data_ptr(), Dp, E, A, blocks,
            code, stream)
        if status != 0:
            raise RuntimeError(f"proj_bwd_wg_kernel: {lib.mp_stack_bwd_error_string(status).decode()}")
        torch.cuda.synchronize()
    m = marks.cpu().numpy().astype(np.float64)
    c, tiles = m[:, :7].sum(0), m[:, 7].sum()
    parts = ("waits for emb's and g32's tiles", "kb^T emb", "its epilogue", "kb dtc (both halves)",
             "their epilogues", "the table accumulation" if vt is not None else "the demb store")
    print(f"[{tag}] mp_stack_bwd_proj phases, proj_bwd_wg_kernel (warp-specialised wgmma"
          f"{', the fold' if vt is not None else ''}): {blocks} blocks, {int(tiles)} tiles, "
          f"{c[6] / max(tiles, 1) / 1e3:.2f} kclocks a tile (the consumer's span over its tiles): "
          + "; ".join(f"{p} {100 * v / c[6]:.1f}%" for p, v in zip(parts, c[:6])), flush=True)
    print(f"[{tag}] mp_stack_bwd_proj phases, proj_bwd_wg_kernel producers: the g32 warp waits "
          f"for a free buffer {100 * m[:, 8].sum() / max(m[:, 9].sum(), 1):.1f}% of its span, the "
          f"emb warps {100 * m[:, 10].sum() / max(m[:, 11].sum(), 1):.1f}%", flush=True)


def check_pool6_bins(xs, xo, pm, ks, ko, b, cot) -> None:
    """Kernel 6's kernels of one block a bin (``bin_pool_fwd_kernel``,
    ``bin_pool_bwd_kernel``), the route of the shapes past the tiles
    (ab > 512, H > 8), against their plain versions: three bins of the
    batch as one bin of 3 ab atoms, through the wrappers (the backward from
    the forward's attn and the cotangents ``cot`` of the three bins' slots);
    fails unless the route counts read one launch of that kernel and none
    on tiles (a wrapper without the route counts has only that kernel), and
    the errors are within ``POOL6_TOL``."""
    from aimnet_x2d_tpu_torch.ops import bin_pool

    nb, mb, ab = pm.shape
    n3 = nb // 3
    pm3 = torch.zeros(n3, 3 * mb, 3 * ab, dtype=pm.dtype, device=pm.device)
    for k in range(3):  # bin 3j + k at rows k mb and columns k ab of bin j
        pm3[:, k * mb:(k + 1) * mb, k * ab:(k + 1) * ab] = pm[k:3 * n3:3]
    args = (xs[:3 * n3 * ab], xo[:3 * n3 * ab], pm3, ks, ko, b)
    tol = POOL6_TOL[xs.dtype]
    fwd_ref = bin_pool.pool_fwd_plain(*args)
    # slot k mb + m of bin j is slot m of bin 3j + k: the same rows in order
    bargs = (*args[:5], fwd_ref[3], *(c[:3 * n3 * mb] for c in cot))
    dks_scale = None
    for name, fn, plain, a in (("bin_pool_fwd", bin_pool.bin_pool_fwd, bin_pool.pool_fwd_plain,
                                args),
                               ("bin_pool_bwd", bin_pool.bin_pool_bwd, bin_pool.pool_bwd_plain,
                                bargs)):
        routes = fn.routes
        for k in routes:
            routes[k] = 0
        got, want = fn(*a), plain(*a)
        torch.cuda.synchronize()
        seen = dict(routes)
        if name == "bin_pool_bwd":  # d_b cancels to 0: held to d_ks's scale
            dks_scale = float(want[2][0].abs().max())
            got, want = (got[0], got[1], *got[2]), (want[0], want[1], *want[2])
        abs_err, rel = _max_rel([(o, r, dks_scale if i == 4 else None)
                                 for i, (o, r) in enumerate(zip(got, want))])
        print(f"[pool6-kernel] {name} {str(xs.dtype)[6:]} at nb={n3} mb={3 * mb} ab={3 * ab}: "
              f"routes {seen}, max_abs_err={abs_err:.3e} rel={rel:.3e} (tol {tol:g})", flush=True)
        if seen != {"tiles": 0, "bins": 1}:
            raise AssertionError(f"{name} at ab={3 * ab}: routes {seen}")
        if not rel <= tol:
            raise AssertionError(f"{name} (one block a bin) {xs.dtype}: rel err {rel:.3e} > "
                                 f"{tol:g}")


def check_c3_kernels(pkg, cfg, model, batch, seed: int, marks_build) -> dict:
    """``[c3-kernel]``: kernel 4 (the inject kernels, forward and backward)
    and kernel 1d (one layer: serving form, training form, backward)
    against their plain versions at the config-3 training shape (a
    size-sorted batch of 2048, bf16), with times and bounds, and kernel
    4's backward split by phase (``inject_phases`` on ``marks_build``)."""
    from aimnet_x2d_tpu_torch.models.gnn import atom_total_charge, stereo_context
    from aimnet_x2d_tpu_torch.ops import bin_inject, bin_mp
    from aimnet_x2d_tpu_torch.ops.embed import embed_concat_onehot_t
    from aimnet_x2d_tpu_torch.utils.activation import get_activation_function

    dev = torch.device("cuda")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    adj, pm = batch.bin_adj, batch.pool_mat
    nb, ab, _ = adj.shape
    A = nb * ab
    D, Ds = cfg.x_other_dim, cfg.x_self_dim
    nblk = cfg.shell_conv_num_mlp_layers
    n = int(batch.atom_mask.sum())
    ctx = stereo_context(batch)
    tables = (atom_total_charge(batch), pm, batch.tet_bin, ctx.any_tet.float().reshape(1),
              ctx.stereo_adj)
    nnz, snz = int((adj != 0).sum()), int((ctx.stereo_adj != 0).sum())
    n_tet = int(batch.tet_mask.sum())
    n_ct = int(batch.cis_mask.sum() + batch.trans_mask.sum())
    print(f"[c3-kernel] shapes nb={nb} ab={ab} mb={pm.shape[1]} Tc={batch.tet_bin.shape[2]} A={A} "
          f"real atoms={n} adjacency nonzeros={nnz}; tetrahedral centres={n_tet}, cis/trans "
          f"pairs={n_ct}, stereo adjacency nonzeros={snz}", flush=True)
    if n_tet == 0 or n_ct == 0:
        raise AssertionError("the config-3 batch has no tetrahedral centre or no cis/trans pair")
    names = ("atom_type", "hydrogen_count", "degree", "hybridization")
    with torch.no_grad():
        # the layer input the model feeds kernel 4: act(W_other emb + b)
        emb = embed_concat_onehot_t([getattr(model, f"{k}_embedding").weight for k in names],
                                    [getattr(batch, k) for k in names], dtype=dt)
        W, b = model.embedding_projection.weight, model.embedding_projection.bias
        act_fn = get_activation_function(cfg.activation_type)
        x = act_fn((W[Ds:].to(dt).float() @ emb.float()).to(dt) + b[Ds:].to(dt)[:, None])
        kb, kbias = model.stereochemical_embedding_2.weight.T, model.stereochemical_embedding_2.bias
        iw = bin_inject.prep_inject(kb, kbias, model.message_passing_layers[0].stack_weights(), dt)
    n_clip = int((x[1] < 1e-6).sum())
    print(f"[c3-kernel] layer input: the 1e-6 clip of f binds on {n_clip} of {A} atom slots",
          flush=True)
    act = cfg.activation_type
    spec = bin_mp.StackSpec(act, 0.05, bin_mp.layer_drop_seed(0x1234567, 0) & 0xFFFFFFFF, 1)
    sw = iw.sw
    res = {}
    isz = 2  # bf16 bytes

    record = recorder("c3-kernel", res)
    # per centre: 4 norms, the polynomial and the scatter, ~40 operations per
    # feature (forward), ~120 (backward); small beside the products
    tet_ops = 4 * n_tet * D
    w_proj = 3 * D * D
    table_bytes = 4 * A + nb * pm.shape[1] * ab + batch.tet_bin.numel() * 4 + nb * ab * ab
    # --- kernel 4, inject forward: x', cct, tet and pre; xct kept for training
    pre, xct = bin_inject.inject_fwd(x, *tables, iw)
    pre2, xct2 = bin_inject.inject_fwd(x, *tables, iw)
    rpre, rxct = bin_inject.inject_fwd_plain(x, *tables, iw)
    torch.cuda.synchronize()
    if not (torch.equal(pre, pre2) and torch.equal(xct, xct2)):
        raise AssertionError("inject_fwd: a rerun is not bit-equal")
    Dp = iw.sw.Dp
    same_xp = torch.equal(xct[:Dp], rxct[:Dp])
    ops = 2 * snz * D + n * 2 * w_proj + 10 * tet_ops
    nbytes = (D * A + D * A + 3 * D * A) * isz + table_bytes + w_proj * isz
    plain_ms = time_ms(lambda: bin_inject.inject_fwd_plain(x, *tables, iw), iters=5)
    ms, timing, names = bwd_record("c3-kernel", "inject_fwd", dt,
                                   lambda: bin_inject.inject_fwd(x, *tables, iw), plain_ms)
    tiled = bool(launches_named(names, "inject_fwd_tile_kernel"))
    print(f"[c3-kernel] inject_fwd: rerun bit-equal=True; x' rows equal to the plain "
          f"version's={same_xp}; {'the tiled kernel' if tiled else 'one block a bin'}", flush=True)
    if not (tiled and same_xp):
        raise AssertionError(f"inject_fwd: kernels {names}, x' equal {same_xp}")
    record("inject_fwd", [(pre, rpre, None), (xct, rxct, None)], ms, plain_ms, ops, nbytes)
    res["inject_fwd"]["timing"] = timing

    # --- kernel 1d, serving form and training form: layer(pre) + pre
    w_layer = 2 * D * 2 * D + nblk * 2 * D * D
    ops = 2 * nnz * D + n * 2 * w_layer
    nbytes = 2 * D * A * isz + nb * ab * ab + w_layer * isz
    for name, fn, plain in (
            ("mp_layer_fwd", lambda: bin_mp.mp_layer_fwd(rpre, adj, sw, act),
             lambda: bin_mp.mp_stack_plain(rpre, adj, sw, act)),
            ("mp_layer_fwd_train", lambda: bin_mp.mp_layer_fwd_train(rpre, adj, sw, spec),
             lambda: bin_mp.mp_stack_train_plain(rpre, adj, sw, spec)[0])):
        got, again, ref = fn(), fn(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: a rerun is not bit-equal")
        plain_ms = time_ms(plain, iters=5)
        ms, timing, names = bwd_record("c3-kernel", name, dt, fn, plain_ms)
        check_stack_route("c3-kernel", name, names, dt)
        record(name, [(got, ref, None)], ms, plain_ms, ops, nbytes)
        res[name]["timing"] = timing

    # --- kernel 1d backward (1b for one layer): dpre (residual included) and
    # the layer's weight gradients
    g = (torch.randn(D, A, generator=gen, device=dev) * 0.05).to(dt)
    g32, lg = bin_mp.mp_layer_bwd(rpre, adj, sw, spec, g)
    rg32, rlg = bin_mp.mp_layer_bwd_plain(rpre, adj, sw, spec, g)
    torch.cuda.synchronize()
    ops = (2 * 2 * nnz * D + n * 2 * (2 * D * D + (2 * nblk - 1) * D * D)
           + n * 2 * (2 * nblk * D * D + 4 * D * D) + n * 2 * w_layer)
    nbytes = 3 * D * A * isz + nb * ab * ab + 4 * w_layer
    g32b, lgb = bin_mp.mp_layer_bwd(rpre, adj, sw, spec, g)
    if not (torch.equal(g32, g32b) and all(torch.equal(a, b_) for a, b_ in zip(lg, lgb))):
        raise AssertionError("mp_layer_bwd: a rerun is not bit-equal")
    plain_ms = time_ms(lambda: bin_mp.mp_layer_bwd_plain(rpre, adj, sw, spec, g), iters=3)
    ms, timing, _ = bwd_record("c3-kernel", "mp_layer_bwd", dt,
                            lambda: bin_mp.mp_layer_bwd(rpre, adj, sw, spec, g), plain_ms)
    record("mp_layer_bwd", [(g32, rg32, None)] + [(a, r, None) for a, r in zip(lg, rlg)],
           ms, plain_ms, ops, nbytes)
    res["mp_layer_bwd"]["timing"] = timing
    # the fp32 form at the same shapes, held to FP32_TOL
    with torch.no_grad():
        sw32 = bin_mp.stack_weights([model.message_passing_layers[0].stack_weights()],
                                    torch.float32)
    x32, gf = rpre.float(), g.float()
    got32 = bin_mp.mp_layer_bwd(x32, adj, sw32, spec, gf)
    want32 = bin_mp.mp_layer_bwd_plain(x32, adj, sw32, spec, gf)
    torch.cuda.synchronize()
    _, rel = _max_rel([(got32[0], want32[0], None)]
                      + [(a, r, None) for a, r in zip(got32[1], want32[1])])
    print(f"[c3-kernel] mp_layer_bwd fp32: rel={rel:.3e} (tol {FP32_TOL:g})", flush=True)
    if not rel <= FP32_TOL:
        raise AssertionError(f"mp_layer_bwd fp32: rel err {rel:.3e} > {FP32_TOL:g}")
    bwd_record("c3-kernel", "mp_layer_bwd", torch.float32,
               lambda: bin_mp.mp_layer_bwd(x32, adj, sw32, spec, gf),
               time_ms(lambda: bin_mp.mp_layer_bwd_plain(x32, adj, sw32, spec, gf), iters=3))

    # --- kernel 4, inject backward: dx through the projection, the
    # polynomial and the equilibration, and d_kb, d_b: the cast of kernel
    # 1d's cotangent, the kernel and its product in the grouped contraction
    # (which the round launches with kernel 1d's products)
    def bwd():
        dp = rg32.to(dt)
        dx = bin_inject.inject_bwd(x, *tables, iw, rxct, dp)
        ((dkbT, db),) = bin_mp.wgrad_group([(dp, rxct, rg32)])
        return dx, dkbT, db

    def bwd_plain():
        dp = rg32.to(dt)
        return (bin_inject.inject_bwd_plain(x, *tables, iw, rxct, dp),
                dp.float() @ rxct.float().T, rg32.sum(1))

    got, again, want = bwd(), bwd(), bwd_plain()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
        raise AssertionError("inject_bwd: a rerun is not bit-equal")
    ops = 2 * n * 2 * w_proj + 2 * snz * D + 30 * tet_ops
    nbytes = (D * A + 3 * D * A + D * A + D * A) * isz + 4 * D * A + table_bytes + 4 * (w_proj + D)
    plain_ms = time_ms(bwd_plain, iters=3)
    ms, timing, names = bwd_record("c3-kernel", "inject_bwd", dt, bwd, plain_ms)
    print(f"[c3-kernel] inject_bwd: rerun bit-equal=True; "
          f"{'the tiled kernel' if launches_named(names, 'inject_bwd_tile') else 'one block a bin'}"
          f", contraction wgrad_group", flush=True)
    if not (launches_named(names, "inject_bwd_tile_kernel") == 1
            and launches_named(names, "wgrad_kernel") == 0):
        raise AssertionError(f"inject_bwd: kernels {names}")
    record("inject_bwd", list(zip(got, want, [None] * 3)), ms, plain_ms, ops, nbytes)
    res["inject_bwd"]["timing"] = timing
    inject_phases(marks_build, x, tables, iw, rxct, rg32.to(dt))
    return res


def c3_routes(pkg, cfg, smiles, seed: int) -> None:
    """``[c3-routes]``: one batch of config 3, charges only, stereo only and
    a 1-layer model on the card and on the CPU (plain versions), same
    weights: predictions and partial charges compared; each model's route
    launches its kernels and no other MP kernel."""
    import dataclasses

    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import bin_inject, bin_mp

    ds = MoleculeDataset.from_smiles(smiles[:128], np.zeros((128, 1), np.float32), cfg.num_shells)
    hb = next(iter(BatchLoader(ds, 128)))
    counters = (bin_inject.inject_fwd, bin_mp.mp_layer_fwd, bin_mp.mp_stack_fwd)
    routes = {
        "config3": (dict(use_partial_charges=True, use_stereochemistry=True), (1, 1, 0)),
        "charges": (dict(use_partial_charges=True), (0, 1, 0)),
        "stereo": (dict(use_stereochemistry=True), (0, 1, 0)),
        "one_layer": (dict(num_message_passing_layers=1), (0, 1, 0)),
    }
    base = dataclasses.replace(cfg, use_partial_charges=False, use_stereochemistry=False)
    for name, (kw, want) in routes.items():
        c = dataclasses.replace(base, **kw)
        outs = {}
        for c_ in counters:
            c_.launches = 0
        for where in ("cuda", "cpu"):
            m = pkg.models.gnn.GNN(c)
            m.load_state_dict(params_from_flax(init_params(c, seed)))
            with torch.inference_mode():
                outs[where] = m.to(where).eval()(hb.to(where))
        ran = tuple(int(c_.launches > 0) for c_ in counters)
        pairs = [(outs["cuda"].predictions.cpu(), outs["cpu"].predictions, None)]
        if c.use_partial_charges:
            am = torch.from_numpy(hb.atom_mask)
            pairs.append((outs["cuda"].partial_charges.cpu()[am], outs["cpu"].partial_charges[am],
                          None))
        abs_err, rel = _max_rel(pairs)
        print(f"[c3-routes] {name} ({m.route} route): card vs cpu max_abs_err={abs_err:.3e} "
              f"rel={rel:.3e} (tol {E2E_TOL:g}); launches "
              f"{ {c_.__name__: c_.launches for c_ in counters} }", flush=True)
        if not rel <= E2E_TOL or ran != want:
            raise AssertionError(f"{name}: rel err {rel:.3e}, kernels run {ran}, want {want}")


def synthetic_targets(ds, T: int, seed: int) -> np.ndarray:
    """T targets per molecule that depend on its composition (learnable),
    with noise, from ``seed``."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((len(ds), 10), np.float64)
    for i, f in enumerate(ds.features):
        z = np.clip(np.asarray(f.atomic_numbers), 0, 9)
        counts[i] = np.bincount(z, minlength=10)[:10]
    mix = rng.normal(size=(10, T))
    return (counts @ mix + rng.normal(size=(len(ds), T)) * 0.1).astype(np.float32)


def profile_step(step, tag: str = "train", top: int = 12, tries: int = PROFILE_TRIES):
    """Device time of one train step, by kernel (torch.profiler, two steps
    profiled, ``kernel_profile``); returns the total in ms, or None when
    the profiler records no device time."""
    step()
    torch.cuda.synchronize()
    kernels = kernel_profile(step, 2, tries)
    if not kernels:
        print(f"[{tag}] device time not measured (no device time in the profiler trace)",
              flush=True)
        return None
    per = {key: n * us for key, (n, us) in kernels.items()}  # µs a step
    total = sum(per.values())
    STEP_DEVICE_MS[tag] = total / 1e3
    print(f"[{tag}] one step, device time {total / 1e3:.3f} ms summed over kernels:", flush=True)
    for key in sorted(per, key=lambda k: -per[k])[:top]:
        print(f"[{tag}]   {per[key] / 1e3:8.3f} ms {100 * per[key] / total:5.1f}%  "
              f"x{kernels[key][0]:<3d} {key[:90]}", flush=True)
    return total / 1e3


def train_phase(pkg, cfg, smiles, ds, seed: int, work: str, tag: str = "train",
                counters=None, steps: int = TRAIN_STEPS, forbidden=(),
                want_per_step=None) -> dict:
    """Phase 6 (and ``[c3-train]``, ``[c1-train]``, ``[flat-train]``): the
    CLI's training path on the card with the counters of the path's kernels
    (default: the flagship's), which must all launch, and of ``forbidden``
    kernels, which must not; a timed train-step loop of ``steps`` steps
    (with ``want_per_step``, each named kernel must launch exactly that
    many times a step), and one step card against CPU.  With partial charges the
    CLI also writes the test split's charges, which are checked."""
    import pandas as pd

    from aimnet_x2d_tpu_torch import cli
    from aimnet_x2d_tpu_torch.checkpoint import init_params, load_artifact, params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp
    from aimnet_x2d_tpu_torch.training import trainer

    T = cfg.output_dim
    task = "multitask" if T > 1 else "regression"
    counters = counters or (bin_mp.mp_stack_fwd_train, bin_mp.mp_stack_bwd,  # the flagship's
                            bin_attnpool.attnpool_fwd, bin_attnpool.attnpool_bwd,
                            bin_mp.mp_stack_bwd_proj)
    targets = synthetic_targets(ds, T, seed)
    cols = [f"target_{i}" for i in range(T)]
    csv = os.path.join(work, f"{tag}.csv")
    df = pd.DataFrame(targets, columns=cols)
    df.insert(0, "smiles", ds.smiles)
    df.to_csv(csv, index=False)
    art = os.path.join(work, f"{tag}-trained.npz")
    charges = os.path.join(work, f"{tag}-charges.npz")
    extra = ["--use_partial_charges", "--output_partial_charges", charges] \
        if cfg.use_partial_charges else []
    extra += ["--use_stereochemistry"] if cfg.use_stereochemistry else []
    extra += [] if cfg.parity_mode else ["--true_multi_hop"]
    extra += ["--multi_target_columns", ",".join(cols)] if T > 1 else ["--target_column", cols[0]]

    # --- the user's entry point: the CLI, bf16, dropout 0.05 (the defaults)
    for c in (*counters, *forbidden):
        c.launches = 0
    summary = cli.main(["--data_path", csv, "--task_type", task, "--mixed_precision",
                        "--epochs", "3", "--batch_size", "2048", "--learning_rate", "1e-3",
                        "--num_shells", str(cfg.num_shells), "--pooling_type", cfg.pooling_type,
                        "--num_message_passing_layers", str(cfg.num_message_passing_layers),
                        "--model_save_path", art, "--seed", str(seed), *extra])
    launches = {c.__name__: c.launches for c in counters}
    ran = {c.__name__: c.launches for c in forbidden}
    print(f"[{tag}] launches on the main path (CLI, 3 epochs): {launches}"
          + (f"; must not launch: {ran}" if ran else ""), flush=True)
    if min(launches.values()) <= 0 or any(ran.values()):
        raise AssertionError(f"a training kernel never launched, or one of another route did: "
                             f"{launches} {ran}")
    hist = summary["history"]
    print(f"[{tag}] CLI epochs: train loss {[round(h['train_loss'], 5) for h in hist]}, "
          f"val loss {[round(h['val_loss'], 5) for h in hist]}, test "
          f"{ {k: v for k, v in summary['test_metrics'].items() if k != 'per_task'} }",
          flush=True)
    losses = [h["train_loss"] for h in hist] + [h["val_loss"] for h in hist]
    if not np.isfinite(losses).all() or not np.isfinite(summary["test_metrics"]["mae"]):
        raise AssertionError("the CLI's training produced non-finite losses")
    loaded = load_artifact(art)
    mc = loaded.model_config
    want = (cfg.hidden_dim, T, "bfloat16", cfg.use_partial_charges, cfg.use_stereochemistry,
            cfg.parity_mode)
    if (mc.hidden_dim, mc.output_dim, mc.compute_dtype, mc.use_partial_charges,
            mc.use_stereochemistry, mc.parity_mode) != want:
        raise AssertionError(f"the saved artifact's config is not the one trained: {mc}")
    if cfg.use_partial_charges:
        with np.load(charges) as f:
            q, idx = f["charges"], f["molecule_index"]
            names = sorted(f.files)
        n_mol = int(idx.max()) + 1
        print(f"[{tag}] --output_partial_charges: {q.shape[0]} atoms of {n_mol} test "
              f"molecules, charges in [{q.min():.4f}, {q.max():.4f}]", flush=True)
        # the JAX layout: one charge per real atom, in loader order, with the
        # dense index (0, 1, ...) of its molecule
        if (names != ["charges", "molecule_index"] or q.shape != idx.shape
                or not np.isfinite(q).all() or (np.diff(idx) < 0).any()
                or not np.array_equal(np.unique(idx), np.arange(n_mol))):
            raise AssertionError("the charges file is not the JAX layout over the test split")

    # --- the train step, timed on card-resident batches
    pipe = loaded.pipeline
    tds = ds.with_targets(pipe.transform(ds.atomic_numbers(), targets))
    if tag == "train":
        prefetch_phase(pkg, cfg, tds, hist, seed, task)
    loader = BatchLoader(tds, 2048, shuffle=True, seed=seed)
    batches = []
    for epoch in range(steps // len(loader) + 1):
        loader.set_epoch(epoch)
        batches += [b.to("cuda") for b in loader]
    batches = batches[:steps]
    model = pkg.models.gnn.GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, seed)))
    model.to("cuda").train()
    opt = trainer.Optimizer(model.parameters(), 1.0)
    loss_fn = trainer.make_loss_fn(trainer.TrainConfig(task_type=task))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    ms, losses = [], []
    for c in counters:
        c.launches = 0
    for b in batches:
        drop_seed = int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=host))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.train_step(model, opt, b, 5e-4, loss_fn, drop_seed, gen)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    per_step = {c.__name__: c.launches / len(batches) for c in counters}
    n_mol = int(batches[0].graph_mask.sum())
    med = float(np.median(ms[2:]))
    print(f"[{tag}] {len(batches)} steps, batch {n_mol} molecules: median {med:.3f} ms/step "
          f"(host clock around a synchronized step) = {n_mol / med * 1e3:.1f} mol/s; "
          f"loss first {losses[0]:.5f} last {losses[-1]:.5f}; launches per step {per_step}",
          flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the training loss did not fall: {losses}")
    if want_per_step and any(per_step[k] != v for k, v in want_per_step.items()):
        raise AssertionError(f"launches per step {per_step}, want {want_per_step}")
    print(f"[{tag}] step ms: {[round(x, 3) for x in ms]}", flush=True)
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    b0 = batches[0]
    profile_step(lambda: trainer.train_step(model, opt, b0, 5e-4, loss_fn, 5, gen), tag)

    # --- one step card vs CPU, flagship widths, a small batch
    small = MoleculeDataset.from_smiles(smiles[:96], targets[:96], cfg.num_shells)
    sb = next(iter(BatchLoader(small.with_targets(pipe.transform(small.atomic_numbers(),
                                                                 small.targets)), 96)))
    grads_card_vs_cpu(pkg, cfg, sb, loss_fn, seed, tag)
    return launches


# The flagship's [train] host ms a step that PERF.md section 5 records
# from before the prefetch (NVIDIA H100 80GB HBM3, 700.00 W, card-resident
# batches), printed beside this run's readings by [prefetch]
PARENT_TRAIN_HOST_MS = 25.790


def _host_arrays(batch) -> dict:
    """A device MolBatch's tensors copied back to the host, by field."""
    return {k: v.cpu() for k, v in vars(batch).items() if isinstance(v, torch.Tensor)}


def prefetch_phase(pkg, cfg, tds, hist, seed: int, task: str) -> None:
    """``[prefetch]``, inside ``[train]``: the train loop's input pipeline
    (``trainer.prefetch_batches``: a collate thread and a transfer thread,
    pinned copies on a stream of their own, the native builder's scratch
    rotated in pinned sets).  Prints the CLI's epochs as the prefetch
    measured them (the main thread's wait on the device queue, the copy
    stream's time, the host ms a step) beside the parent's figure; holds
    the first epoch's batches through the prefetch, rotation on, against
    the serial loader's, array for array once copied back, at the CLI's
    batch of 2048 and at 256 (more batches than scratch sets, so the
    rotation comes round); and ``train``'s first two epochs' losses against
    a serial loop's with the same seeds, bit for bit."""
    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader
    from aimnet_x2d_tpu_torch.data.native_batch import SCRATCH_SETS
    from aimnet_x2d_tpu_torch.training import trainer

    for h in hist:
        print(f"[prefetch] CLI epoch {h['epoch']}: {h['steps']} steps, main thread waited "
              f"{1e3 * h['input_wait_seconds']:.1f} ms on the device queue, copy stream "
              f"{h['copy_ms']:.2f} ms (CUDA events), {1e3 * h['train_seconds'] / h['steps']:.1f} "
              f"ms a step (host clock, the epoch's train loop / steps)", flush=True)
    print(f"[prefetch] flagship [train] host ms a step: the CLI's epochs above (fed by the "
          f"prefetch, input included) and the timed steps below (card-resident batches); the "
          f"timed steps recorded before the prefetch {PARENT_TRAIN_HOST_MS} ms (PERF.md "
          f"section 5)", flush=True)
    for bs in (2048, 256):
        serial, fed = (BatchLoader(tds, bs, shuffle=True, seed=seed) for _ in range(2))
        want = list(serial)
        fed.rotate_scratch()
        stats: dict = {}
        got = [(_host_arrays(b), e) for b, e in trainer.prefetch_batches(fed, "cuda",
                                                                          stats=stats)]
        bad = [(i, k) for i, ((arrays, e), w) in enumerate(zip(got, want))
               for k, v in arrays.items()
               if not torch.equal(v, torch.from_numpy(np.asarray(getattr(w, k))))]
        bad += [(i, "edges") for i, ((_, e), w) in enumerate(zip(got, want))
                if e != trainer.batch_edges(w)]
        pinned = all(torch.from_numpy(sc["bufs"][-1]).is_pinned() for sc in fed._scratches
                     if "bufs" in sc)
        print(f"[prefetch] epoch 0 at batch {bs}: {len(got)} batches through the prefetch "
              f"({SCRATCH_SETS} pinned scratch sets: {pinned}) against the serial loader's: "
              f"{'equal array for array' if not bad and len(got) == len(want) else bad[:4]}; "
              f"main thread waited {1e3 * stats['wait_s']:.1f} ms, copy stream "
              f"{stats['copy_ms']:.2f} ms", flush=True)
        if bad or len(got) != len(want) or not pinned:
            raise AssertionError("[prefetch] the prefetched batches differ from the serial ones")

    # train's first two epochs (prefetch) against a serial loop, same seeds
    tc = trainer.TrainConfig(epochs=2, learning_rate=1e-3, task_type=task)
    val = BatchLoader(tds, 2048)
    models = []
    for _ in range(2):
        m = pkg.models.gnn.GNN(cfg)
        m.load_state_dict(params_from_flax(init_params(cfg, seed)))
        models.append(m.to("cuda"))
    t0 = time.perf_counter()
    res = trainer.train(models[0], BatchLoader(tds, 2048, shuffle=True, seed=seed), val, tc,
                        device="cuda", seed=seed)
    fed_s = time.perf_counter() - t0
    opt = trainer.make_optimizer(models[1], tc)
    loss_fn = trainer.make_loss_fn(tc)
    host = torch.Generator().manual_seed(seed)
    dev = torch.Generator(device="cuda").manual_seed(seed)
    loader = BatchLoader(tds, 2048, shuffle=True, seed=seed)
    serial = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        losses, counts = [], []
        for b in loader:
            drop_seed = int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=host))
            loss, n = trainer.train_step(models[1], opt, b.to("cuda"), 1e-3, loss_fn, drop_seed,
                                         dev)
            losses.append(loss)
            counts.append(n)
        sl = torch.stack(losses).float().cpu().numpy()
        sc = torch.stack(counts).float().cpu().numpy()
        serial.append(float((sl * sc).sum() / max(sc.sum(), 1)))
    fed_losses = [h["train_loss"] for h in res.history]
    same = fed_losses == serial
    print(f"[prefetch] train, 2 epochs through the prefetch: losses {fed_losses} ({fed_s:.2f} s "
          f"with validation; waits {[round(1e3 * h['input_wait_seconds'], 1) for h in res.history]}"
          f" ms, copy {[round(h['copy_ms'], 2) for h in res.history]} ms); a serial loop: "
          f"{serial}; bit-equal: {same}", flush=True)
    if not same:
        raise AssertionError("[prefetch] train's losses through the prefetch differ from the "
                             "serial loop's")


def grad_scale(k: str, params: dict, ref: dict, cfg) -> float:
    """The scale gradient ``k`` is held to against its reference ``ref[k]``
    (``params``: the parameters it was taken at): max|ref[k]|, except for
    the two whose exact value is 0 or a cancelling sum."""
    # the heads' score biases shift every score of a head alike, which
    # leaves each molecule's softmax unchanged: their exact gradient is
    # 0, so both sides hold rounding residue, held to the heads' kernels
    if k.startswith("pooling.attention_weights.") and k.endswith(".bias"):
        k = k[: -len("bias")] + "weight"
    if k == "pooling.temperature":
        # dL/dT = -(1/T) sum over heads h of (w_h . dL/dw_h + b_h dL/db_h):
        # the heads' terms cancel (with config 3's charges, to about a
        # fifth of the sum of their sizes), so the scores' bf16 noise
        # moves the sum by that factor more than each term; held to the
        # sum of the heads' term sizes
        def head(h):
            n = f"pooling.attention_weights.{h}."
            return sum(float((params[n + w] * ref[n + w]).sum()) for w in ("weight", "bias"))

        return sum(abs(head(h)) for h in range(cfg.attention_num_heads)) / abs(float(params[k]))
    return max(float(ref[k].abs().max()), 1e-30)


def grads_card_vs_cpu(pkg, cfg, sb, loss_fn, seed: int, tag: str, counters=()) -> dict:
    """One training forward and backward of the model on the host batch
    ``sb`` on the card and on the CPU (plain versions) from the same
    weights; every gradient held to TRAIN_TOL.  The stack's dropout mask is
    the same hash on both sides, the FFN's generator (and on the row-major
    route the layers') is not, so those dropouts are off.  Returns the
    card run's launches of ``counters``."""
    import dataclasses

    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax

    cfg1 = dataclasses.replace(cfg, ffn_dropout=0.0)
    if sb.pool_mat is None or not cfg.parity_mode:
        cfg1 = dataclasses.replace(cfg1, shell_conv_dropout=0.0)
    # Both sides backpropagate the CPU's cotangent of the L1 loss: a
    # prediction within the card's bf16 noise of its target (96 x 12 values
    # hold some |pred - target| near 1e-4) would flip the loss's sign for
    # that value on the card alone, which moves every gradient by that
    # molecule's share and says nothing of the kernels.
    grads, cot, launches = {}, None, {}
    for where in ("cpu", "cuda"):
        m = pkg.models.gnn.GNN(cfg1)
        m.load_state_dict(params_from_flax(init_params(cfg, seed)))
        m.to(where)
        bb = sb.to(where)
        for c in counters:
            c.launches = 0
        pred = m(bb, train=True, drop_seed=77).predictions
        if cot is None:
            cot = torch.autograd.grad(loss_fn(pred, bb.targets, bb.graph_mask), pred,
                                      retain_graph=True)[0]
        pred.backward(cot.to(where))
        grads[where] = {k: p.grad.detach().float().cpu() for k, p in m.named_parameters()
                        if p.grad is not None}
        if where == "cpu":
            params = {k: p.detach().float() for k, p in m.named_parameters()}
    launches = {c.__name__: c.launches for c in counters}

    errs = {k: float((grads["cuda"][k] - g).abs().max()) / grad_scale(k, params, grads["cpu"], cfg)
            for k, g in grads["cpu"].items()}
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    worst = top[0][1]
    tables = max(v for k, v in errs.items() if k.endswith("_embedding.weight"))
    print(f"[{tag}] one step card vs cpu ({int(sb.graph_mask.sum())} molecules, "
          f"{len(grads['cpu'])} gradients): worst max|d|/max|cpu| {worst:.3e} "
          f"(tol {TRAIN_TOL:g}), embedding tables {tables:.3e}; largest "
          f"{[(k, f'{v:.2e}') for k, v in top]}", flush=True)
    if not worst <= TRAIN_TOL:
        raise AssertionError(f"card gradients differ from the CPU run: {worst:.3e}")
    return launches


def config1(cfg):
    """BASELINE.json config 1 at the CLI defaults: the flagship widths
    (hidden 512, 4x64 embeddings, 3 MP layers with 2 MLP blocks, 3-layer
    FFN) over 1 shell, mean pooling, 1 target (regression), bf16."""
    import dataclasses

    return dataclasses.replace(cfg, num_shells=1, pooling_type="mean", output_dim=1,
                               task_type="regression")


def check_c1_kernel(cfg, batch, seed: int) -> dict:
    """``[c1-kernel]``: kernel 2b (``wpool_bwd``: dx, and dw when asked)
    against its plain version on x_self's and x_other's rows, fp32 and bf16,
    at the config-1 training batch's pool matrix, two with mb not a multiple
    of 16 and one that is not one-hot, with w = 1 (mean pooling) and a
    random w on the real atoms, dx and dw bit-equal on a rerun; then timed
    at the training batch (both launches of a step, w = 1), without dw as
    mean and sum pooling run it and with dw: device time from the profiler,
    in turns with the library yardstick of the dx-only form, beside the
    event time of back-to-back calls and the wrapper's host time per call."""
    from aimnet_x2d_tpu_torch.ops import bin_wpool

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    pm = batch.pool_mat
    nb, mb, ab = pm.shape
    A = nb * ab
    Ds = (cfg.x_self_dim, cfg.x_other_dim)
    print(f"[c1-kernel] shapes nb={nb} ab={ab} mb={mb} A={A} real atoms="
          f"{int(batch.atom_mask.sum())} molecules={int(batch.graph_mask.sum())}", flush=True)
    real = batch.atom_mask.float()
    weights = {"w=1": torch.ones(A, device=dev),
               "w random": torch.rand(A, generator=gen, device=dev) * real}
    pms = [pm, rand_pm(nb, 20, ab, gen), rand_pm(nb, 44, ab, gen), rand_pm(nb, mb, ab, gen, True)]
    npm = int((pm != 0).sum())
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[("wpool_bwd", dt)]
        worst = 0.0
        for k, pm_ in enumerate(pms):
            mb_ = pm_.shape[1]
            kind = "not one-hot" if k == 3 else "one-hot"
            for d in Ds:
                x = torch.randn(d, A, generator=gen, device=dev).to(dt)
                g = torch.randn(d, nb * mb_, generator=gen, device=dev)
                for wname, w in weights.items():
                    dx, dw = bin_wpool.wpool_bwd(x, w, pm_, g)
                    dx2, dw2 = bin_wpool.wpool_bwd(x, w, pm_, g)
                    dx3, none = bin_wpool.wpool_bwd(x, w, pm_, g, need_dw=False)
                    rdx, rdw = bin_wpool.wpool_bwd_plain(x, w, pm_, g)
                    torch.cuda.synchronize()
                    (ax, rx), (aw, rw) = rel_err(dx, rdx), rel_err(dw, rdw)
                    worst = max(worst, ax, aw)
                    print(f"[c1-kernel] wpool_bwd {str(dt)[6:]} D={d} mb={mb_} ({kind}) {wname}: "
                          f"dx max_abs_err={ax:.3e} rel={rx:.3e}, dw max_abs_err={aw:.3e} "
                          f"rel={rw:.3e} (tol {tol:g})", flush=True)
                    if not max(rx, rw) <= tol:
                        raise AssertionError(f"wpool_bwd {dt} D={d} mb={mb_} ({kind}) {wname}: "
                                             f"rel err {max(rx, rw):.3e} > {tol:g}")
                    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2) and torch.equal(dx, dx3)
                            and none is None):
                        raise AssertionError(f"wpool_bwd {dt} D={d} mb={mb_} ({kind}) {wname}: "
                                             f"a rerun, or the form without dw, differs")
        # main-path shapes: both launches of a step (x_self's and x_other's
        # rows, w = 1); bytes without dw: dx written, g, pm, w read; with
        # dw also x read and dw written
        graph_timed = device_ms.graph_timed
        tot = dict(max_abs_err=worst, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   bound_by="bytes", dw_ms=0.0, dw_plain_ms=0.0, dw_bound_ms=0.0, event_ms=0.0,
                   dw_event_ms=0.0, host_us=0.0)
        w = weights["w=1"]
        for d in Ds:
            x = torch.randn(d, A, generator=gen, device=dev).to(dt)
            g = torch.randn(d, nb * mb, generator=gen, device=dev)
            g3, pm_dt, w2 = g.reshape(d, nb, mb).to(dt), pm.to(dt), w.reshape(nb, ab).to(dt)
            t = in_turns({"library": lambda: wpool_bwd_dx_library(g3, pm_dt, w2),
                          "kernel": lambda: bin_wpool.wpool_bwd(x, w, pm, g, need_dw=False),
                          "kernel dw": lambda: bin_wpool.wpool_bwd(x, w, pm, g)})
            plain = device_ms(lambda: bin_wpool.wpool_bwd_plain(x, w, pm, g, need_dw=False), iters=5)
            plain_dw = device_ms(lambda: bin_wpool.wpool_bwd_plain(x, w, pm, g), iters=5)
            ev = time_ms(lambda: bin_wpool.wpool_bwd(x, w, pm, g, need_dw=False))
            ev_dw = time_ms(lambda: bin_wpool.wpool_bwd(x, w, pm, g))
            hu = host_us(lambda: bin_wpool.wpool_bwd(x, w, pm, g, need_dw=False))
            isz = x.element_size()
            nbytes = d * A * isz + 4 * d * nb * mb + nb * mb * ab + 4 * A
            ops = 2 * d * npm + d * A
            bound = 1e3 * max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[torch.float32])
            dw_bytes, dw_ops = nbytes + d * A * isz + 4 * A, ops + 2 * d * A
            dw_bound = 1e3 * max(dw_bytes / HBM_BYTES_S, dw_ops / PEAK_FLOPS[torch.float32])
            print(f"[c1-kernel] wpool_bwd {str(dt)[6:]} D={d}: device ms without dw: kernel "
                  f"{t['kernel'][0]:.4f} / {t['kernel'][1]:.4f}, library {t['library'][0]:.4f} / "
                  f"{t['library'][1]:.4f}, plain {plain:.4f}, bound {bound:.4f} (bytes, "
                  f"{nbytes / 1e6:.2f} MB); with dw: kernel {t['kernel dw'][0]:.4f} / "
                  f"{t['kernel dw'][1]:.4f}, plain {plain_dw:.4f}, bound {dw_bound:.4f} (bytes, "
                  f"{dw_bytes / 1e6:.2f} MB);"
                  f" events over back-to-back calls {ev:.4f} / {ev_dw:.4f} ms (without / with dw);"
                  f" host {hu:.1f} us a call", flush=True)
            tot["ms"] += sum(t["kernel"]) / 2
            tot["dw_ms"] += sum(t["kernel dw"]) / 2
            tot["library_ms"] += sum(t["library"]) / 2
            tot["plain_ms"] += plain
            tot["dw_plain_ms"] += plain_dw
            tot["bound_ms"] += bound
            tot["dw_bound_ms"] += dw_bound
            tot["event_ms"] += ev
            tot["dw_event_ms"] += ev_dw
            tot["host_us"] += hu / len(Ds)
        print(f"[c1-kernel] wpool_bwd {str(dt)[6:]} per step (D={Ds[0]} + D={Ds[1]}, nb={nb}, "
              f"mb={mb}, ab={ab}), device ms: without dw (as mean and sum pooling run it) kernel "
              f"{tot['ms']:.4f} library {tot['library_ms']:.4f} plain {tot['plain_ms']:.4f} bound "
              f"{tot['bound_ms']:.4f} (bytes): "
              f"{tot['ms'] / tot['bound_ms']:.2f}x the bound, {tot['ms'] / tot['library_ms']:.2f}x "
              f"the library call; with dw kernel {tot['dw_ms']:.4f} plain {tot['dw_plain_ms']:.4f} "
              f"bound {tot['dw_bound_ms']:.4f} (bytes): "
              f"{tot['dw_ms'] / tot['dw_bound_ms']:.2f}x the bound, no single library call; "
              f"events {tot['event_ms']:.4f} / {tot['dw_event_ms']:.4f} ms; host "
              f"{tot['host_us']:.1f} us a call", flush=True)
        tot["timing"] = timing_of(graph_timed)
        res[("wpool_bwd", dt)] = tot
    return res


def finetune_phase(ds, seed: int, work: str, pretrained: str) -> None:
    """``[c1-finetune]``: the CLI fine-tunes ``pretrained`` (config 1) to a
    12-target head, everything but the head frozen, layer-wise LR decay,
    a checkpoint every epoch; 2 epochs, then the same command with 3 epochs
    resumes after epoch 1."""
    import contextlib
    import io
    import shutil

    import pandas as pd

    from aimnet_x2d_tpu_torch import cli
    from aimnet_x2d_tpu_torch.checkpoint import init_params, load_artifact
    from aimnet_x2d_tpu_torch.ops import bin_wpool

    T = 12
    cols = [f"task_{i}" for i in range(T)]
    df = pd.DataFrame(synthetic_targets(ds, T, seed + 3), columns=cols)
    df.insert(0, "smiles", ds.smiles)
    csv = os.path.join(work, "c1-finetune.csv")
    df.to_csv(csv, index=False)
    ckpt = os.path.join(work, "c1-finetune-ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    art = os.path.join(work, "c1-finetune.npz")
    argv = ["--data_path", csv, "--multi_target_columns", ",".join(cols), "--task_type",
            "multitask", "--mixed_precision", "--batch_size", "2048", "--learning_rate", "1e-3",
            "--num_shells", "1", "--pooling_type", "mean", "--seed", str(seed),
            "--transfer_learning", pretrained, "--freeze_pretrained", "--layer_wise_lr_decay",
            "--checkpoint_dir", ckpt, "--checkpoint_every", "1", "--model_save_path", art,
            "--experiment_config", os.path.join(work, "c1-finetune.yaml")]
    bin_wpool.wpool_bwd.launches = 0
    first = cli.main([*argv, "--epochs", "2"])
    a, b = load_artifact(pretrained), load_artifact(art)
    frozen = [k for k in b.params if not k.startswith("params/output_layer/")]
    changed = [k for k in frozen if not np.array_equal(b.params[k], a.params[k])]
    fresh = init_params(b.model_config, seed)
    moved = float(np.abs(b.params["params/output_layer/kernel"]
                         - fresh["params/output_layer/kernel"]).max())
    print(f"[c1-finetune] 2 epochs: train loss {[round(h['train_loss'], 5) for h in first['history']]}"
          f"; {len(frozen) - len(changed)} of {len(frozen)} frozen tensors bit-equal to the "
          f"transferred ones; output_layer moved by up to {moved:.3e} from its fresh "
          f"initialization; wpool_bwd launches {bin_wpool.wpool_bwd.launches}", flush=True)
    if changed or len(frozen) != len(a.params) - 2 or not moved > 0:
        raise AssertionError(f"fine-tune: frozen tensors changed {changed[:5]}, or the head "
                             f"did not move ({moved})")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        second = cli.main([*argv, "--epochs", "3"])
    print(buf.getvalue(), end="", flush=True)
    epochs = [h["epoch"] for h in second["history"]]
    resumed = "[resume] restored checkpoint at epoch 1" in buf.getvalue()
    print(f"[c1-finetune] rerun with --epochs 3: resumed {resumed}, epochs run {epochs}, test "
          f"mae {second['test_metrics']['mae']:.5f}", flush=True)
    if not resumed or epochs != [2] or not np.isfinite(second["test_metrics"]["mae"]):
        raise AssertionError("the fine-tune run did not resume after epoch 1 and finish")


def pool_routes(pkg, cfg, ds, seed: int) -> None:
    """``[pool-routes]``: one batch of 128 molecules through sum- and
    max-pool models (config 1 otherwise, full width), served and one train
    step, on the card and on the CPU (plain versions) from the same weights:
    predictions and every gradient compared; each route launches its own
    kernels (no weighted pool for max, no attention pool for either)."""
    import dataclasses

    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp, bin_wpool
    from aimnet_x2d_tpu_torch.training import trainer

    small = MoleculeDataset(ds.smiles[:128], synthetic_targets(ds, 1, seed)[:128],
                            ds.features[:128], ds.max_hops)
    hb = next(iter(BatchLoader(small, 128)))
    loss_fn = trainer.make_loss_fn(trainer.TrainConfig())
    counters = (bin_mp.mp_stack_fwd, bin_mp.mp_stack_fwd_train, bin_mp.mp_stack_bwd,
                bin_wpool.wpool_fwd, bin_wpool.wpool_bwd, bin_attnpool.attnpool_fwd,
                bin_attnpool.attnpool_bwd)
    for pooling, want in (("sum", (1, 1, 1, 1, 1, 0, 0)), ("max", (1, 1, 1, 0, 0, 0, 0))):
        c = dataclasses.replace(cfg, pooling_type=pooling, ffn_dropout=0.0)
        for k in counters:
            k.launches = 0
        preds, grads = {}, {}
        for where in ("cuda", "cpu"):
            m = pkg.models.gnn.GNN(c)
            m.load_state_dict(params_from_flax(init_params(c, seed)))
            m.to(where)
            bb = hb.to(where)
            with torch.inference_mode():
                preds[where] = m.eval()(bb).predictions.float().cpu()
            m.train()
            opt = trainer.make_optimizer(m, trainer.TrainConfig())
            trainer.train_step(m, opt, bb, 1e-4, loss_fn, drop_seed=77)
            # gradients as clipped by the step, on each side by its own norm
            grads[where] = {k: p.grad.detach().float().cpu() for k, p in m.named_parameters()
                            if p.grad is not None}
        ran = tuple(int(k.launches > 0) for k in counters)
        p_abs, p_rel = _max_rel([(preds["cuda"], preds["cpu"], None)])
        g_rel = max(float((grads["cuda"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                    for k, g in grads["cpu"].items())
        print(f"[pool-routes] {pooling}: predictions card vs cpu max_abs_err={p_abs:.3e} "
              f"rel={p_rel:.3e} (tol {E2E_TOL:g}); one step, {len(grads['cpu'])} gradients, worst "
              f"max|d|/max|cpu| {g_rel:.3e} (tol {TRAIN_TOL:g}); launches "
              f"{ {k.__name__: k.launches for k in counters} }", flush=True)
        if not (p_rel <= E2E_TOL and g_rel <= TRAIN_TOL) or ran != want:
            raise AssertionError(f"{pooling}: rel errs {p_rel:.3e} / {g_rel:.3e}, kernels run "
                                 f"{ran}, want {want}")


def check_flat_kernels(cfg, host_batch, batch, seed: int, marks_build) -> tuple:
    """``[flat-kernel]``: kernel 7 (``fused_edge_fwd`` on the batch's
    destination-keyed layout, ``fused_edge_bwd`` on the source-keyed one
    with an fp32 cotangent) and kernel 8 (``wseg_sum`` on the batch's
    windowed layout) against their plain versions, D 153 and 359, fp32 and
    bf16 (kernel 8: exact, and data rounded to bf16); each form twice
    (bit-equal), with kernel 7's route, and timed as profiler
    device time beside a CUDA-graph replay (``bwd_record``); the main
    path's forms (D = x_other's 153; kernel 7 in bf16, kernel 8 exact) with
    bounds and library yardsticks.  Both kernels split by phase in the
    marked build (``flat_phases``).  Then kernel 8's op driven once, counts
    reset just before, as its caller would.  Returns (numbers per kernel,
    kernel 8's launches in that drive)."""
    from aimnet_x2d_tpu_torch.ops import fused_edge, pallas_segment

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    fwd, bwd = batch.fused_fwd, batch.fused_bwd
    A, E = batch.num_atom_slots, fwd.num_edges
    deg = torch.diff(fwd.row_ptr)
    print(f"[flat-kernel] shapes A={A} real atoms={int(batch.atom_mask.sum())} edges={E} "
          f"longest row={int(deg.max())} rows without edges={int((deg == 0).sum())}", flush=True)
    t0 = time.perf_counter()
    fused_edge.build_layouts(host_batch.edge_src, host_batch.edge_dst, host_batch.edge_mask, A)
    print(f"[flat-kernel] build_layouts on the host: {1e3 * (time.perf_counter() - t0):.1f} ms "
          "(both directions; host clock)", flush=True)
    for name, lay in (("forward", fwd), ("backward", bwd)):
        img = lay.image_rows
        plans = {f"{'bf16' if b == 2 else 'fp32'} D={D}": fused_edge.stage_plan(lay, D, b)
                 for D in (cfg.x_other_dim, cfg.x_self_dim) for b in (2, 4)}
        print(f"[flat-kernel] kernel 7 {name} tiles: {img.size} of {fused_edge.TILE_ROWS} rows, "
              f"{lay.iv.shape[0]} intervals, image rows mean {img.mean():.1f} max {img.max()}; "
              "the route's shared-memory bytes a block (-1: the direct route): "
              + "; ".join(f"{k} {v}" for k, v in plans.items()), flush=True)

    def adjacency(layout):
        # the multiplicity adjacency as one coalesced CSR matrix (library operand)
        rows = torch.repeat_interleave(torch.arange(A, device=dev), torch.diff(layout.row_ptr))
        idx = torch.stack([rows, layout.col.long()])
        coo = torch.sparse_coo_tensor(idx, torch.ones(E, device=dev), (A, A)).coalesce()
        return coo.to_sparse_csr()

    def record(name, key, got_ref, ms, timing, plain_ms, library_ms, nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[torch.float32]
        res[key] = dict(max_abs_err=got_ref, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=1e3 * max(t_bytes, t_ops), timing=timing,
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
        r = res[key]
        print(f"[flat-kernel] {name} at the main path's shape: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}; "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)", flush=True)

    def compare(name, got, ref, again, what):
        torch.cuda.synchronize()
        abs_err, rel32 = rel_err(got, ref)
        _, rel16 = rel_err(got.to(torch.bfloat16), ref.to(torch.bfloat16))
        same = torch.equal(got, again)
        ok = rel32 <= FLAT_TOL[torch.float32] and rel16 <= FLAT_TOL[torch.bfloat16] and same
        print(f"[flat-kernel] {name} {what}: max_abs_err={abs_err:.3e} rel={rel32:.3e} (tol "
              f"{FLAT_TOL[torch.float32]:g}), after the cast to bf16 rel={rel16:.3e} (tol "
              f"{FLAT_TOL[torch.bfloat16]:g}); twice bit-equal {same}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {what}: rel err {rel32:.3e} / {rel16:.3e}, rerun "
                                 f"bit-equal {same}")
        return abs_err

    def routes_of(fn, run):
        for k in fn.routes:
            fn.routes[k] = 0
        run()
        torch.cuda.synchronize()
        return dict(fn.routes)

    res = {}
    adj = {"fused_edge_fwd": adjacency(fwd), "fused_edge_bwd": adjacency(bwd)}
    for D in (cfg.x_other_dim, cfg.x_self_dim):
        for dt in (torch.float32, torch.bfloat16):
            exact = dt == torch.float32
            x = torch.randn(A, D, generator=gen, device=dev).to(dt)
            g = torch.randn(A, D, generator=gen, device=dev)
            for name, fn, lay, inp in (("fused_edge_fwd", fused_edge.fused_edge_fwd, fwd, x),
                                       ("fused_edge_bwd", fused_edge.fused_edge_bwd, bwd, g)):
                what = f"{str(dt)[6:]} D={D}"
                run = lambda: fn(inp, lay, exact)  # noqa: E731
                err = compare(name, run(), fused_edge.fused_edge_plain(inp, lay, exact), run(),
                              what)
                print(f"[flat-kernel] {name} {what}: launches by route {routes_of(fn, run)}",
                      flush=True)
                plain_ms = time_ms(lambda: fused_edge.fused_edge_plain(inp, lay, exact), iters=5)
                ms, timing, _ = bwd_record("flat-kernel", f"{name} D={D}", dt, run, plain_ms)
                if D != cfg.x_other_dim or exact:
                    continue
                x32 = inp.float()
                nbytes = inp.numel() * inp.element_size() + 4 * A * D + 4 * (A + 1) + 4 * E
                record(name, (name, torch.bfloat16), err, ms, timing, plain_ms,
                       time_ms(lambda: torch.sparse.mm(adj[name], x32)), nbytes, E * D)
                if name == "fused_edge_fwd":
                    x_main = inp
                else:
                    g_main = inp

    # --- kernel 8 on the batch's windowed layout (window 256)
    src_perm, seg_local, W, cap = pallas_segment.windowed_layout(
        host_batch.edge_src, host_batch.edge_dst, host_batch.edge_mask, A)
    sp, sl = torch.from_numpy(src_perm).to(dev), torch.from_numpy(seg_local).to(dev)
    window = 256
    print(f"[flat-kernel] windowed layout: {W} windows, cap {cap} slots ({E} real of {W * cap})",
          flush=True)
    for D in (cfg.x_other_dim, cfg.x_self_dim):
        x = torch.randn(A, D, generator=gen, device=dev)
        data = torch.where((sl < window)[:, None], x[sp.long()], 0.0).contiguous()
        for exact in (True, False):
            run = lambda: pallas_segment.wseg_sum(data, sl, W, cap, window, exact)  # noqa: E731
            what = f"{'exact' if exact else 'data rounded to bf16'} D={D}"
            ref = pallas_segment.windowed_segment_sum_plain(data, sl, W, cap, window, exact)
            err = compare("wseg_sum", run(), ref, run(), what)
            plain_ms = time_ms(lambda: pallas_segment.windowed_segment_sum_plain(
                data, sl, W, cap, window, exact), iters=5)
            ms, timing, _ = bwd_record("flat-kernel", f"wseg_sum D={D}",
                                       torch.float32 if exact else torch.bfloat16, run, plain_ms)
            if D != cfg.x_other_dim or not exact:
                continue
            ids = torch.where(sl < window, torch.arange(W, device=dev).repeat_interleave(cap)
                              * window + sl, W * window).long()
            out = torch.zeros(W * window + 1, D, device=dev)
            # the real slots' rows read, the seg ids read, the output written
            nbytes = 4 * E * D + 4 * W * cap + 4 * W * window * D
            record("wseg_sum", ("wseg_sum", torch.float32), err, ms, timing, plain_ms,
                   time_ms(lambda: out.index_add_(0, ids, data)), nbytes, E * D)
            data_main = data
        if D != cfg.x_other_dim:
            del data
    flat_phases(marks_build, fwd, bwd, x_main, g_main, data_main, sl, W, cap)
    del data_main
    # the op as its caller runs it: gather, then the kernel
    pallas_segment.wseg_sum.launches = 0
    x = torch.randn(A, cfg.x_other_dim, generator=gen, device=dev)
    pallas_segment.pallas_windowed_segment_sum(x, sp, sl, A, W, cap)
    torch.cuda.synchronize()
    launches = pallas_segment.wseg_sum.launches
    print(f"[flat-kernel] pallas_windowed_segment_sum driven once on the batch's edges: "
          f"wseg_sum launches {launches}", flush=True)
    if launches != 1:
        raise AssertionError(f"kernel 8's op launched its kernel {launches} times, want 1")
    return res, launches


def flat_phases(marks_build, fwd, bwd, x, g, data, seg, W: int, cap: int) -> None:
    """Kernels 7 and 8 split by phase (``[flat-kernel]``): the marked build
    of ``csrc/fused_edge.cu`` (``-DFUSED_EDGE_MARKS``) launched twice on the
    main path's inputs (kernel 7: bf16 x on the forward layout, the fp32
    cotangent rounded on the backward one; kernel 8: exact, D 153), the
    second launch read.  Kernel 7: a tile block's staging and sums
    (%globaltimer marks after block barriers) and its warps' clocks in the
    gathers and adds against the stores; kernel 8: a block's list of slots
    (the counting sort) and its sums; both with the blocks resident on an
    SM on average."""
    import ctypes

    from aimnet_x2d_tpu_torch.ops import fused_edge

    so = fused_edge.type_lib(marks_lib(marks_build, "fused_edge"))
    so.fused_edge_marks.argtypes = [ctypes.c_void_p]
    so.fused_edge_marks.restype = ctypes.c_int
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, inp, lay in (("fused_edge_fwd bf16", x, fwd),
                           ("fused_edge_bwd fp32 cotangent rounded to bf16", g, bwd)):
        marks = torch.zeros(lay.image_rows.shape[0], 8, dtype=torch.int64, device=dev)
        if so.fused_edge_marks(marks.data_ptr()) != 0:
            raise RuntimeError("fused_edge: setting the marks failed")
        for _ in range(2):  # a warm-up launch, then the one read
            marks.zero_()
            fused_edge._launch("marks", inp, lay, False, {"span": 0, "direct": 0}, so=so)
            torch.cuda.synchronize()
        m = marks.cpu().numpy().astype(np.float64)
        m = m[m[:, 0] > 0]  # the tile kernel's blocks (the direct route's rows have no marks)
        span_ns = m[:, 2].max() - m[:, 0].min()
        block = (m[:, 2] - m[:, 0]) / 1e3
        clk = m[:, 3:5].sum(0)
        print(f"[flat-kernel] edge_agg phases, {name}: span {span_ns / 1e6:.4f} ms (marked build); "
              f"{len(m)} tile blocks, resident on an SM {block.sum() * 1e3 / span_ns / sms:.2f} on "
              f"average, a block p50 {np.percentile(block, 50):.2f} p90 "
              f"{np.percentile(block, 90):.2f} max {block.max():.2f} us, {int(m[:, 5].mean())} "
              f"edges: staging {(m[:, 1] - m[:, 0]).mean() / 1e3:.2f} us, sums "
              f"{(m[:, 2] - m[:, 1]).mean() / 1e3:.2f} us; warp clocks gathers and adds "
              f"{100 * clk[0] / clk.sum():.1f}%, stores {100 * clk[1] / clk.sum():.1f}%", flush=True)
    D = data.shape[1]
    marks = torch.zeros(W * 128, 8, dtype=torch.int64, device=dev)  # the blocks, at most
    out = torch.empty(W * 256, D, device=dev)
    if so.fused_edge_marks(marks.data_ptr()) != 0:
        raise RuntimeError("fused_edge: setting the marks failed")
    for _ in range(2):
        marks.zero_()
        status = so.wseg_sum(data.data_ptr(), seg.data_ptr(), out.data_ptr(), W, D, 256, cap, 0,
                             torch.cuda.current_stream(dev).cuda_stream)
        if status != 0:
            raise RuntimeError(f"wseg_sum: {so.fused_edge_error_string(status).decode()}")
        torch.cuda.synchronize()
    m = marks.cpu().numpy().astype(np.float64)
    m = m[m[:, 0] > 0]
    block = (m[:, 2] - m[:, 0]) / 1e3
    span_ns = m[:, 2].max() - m[:, 0].min()
    print(f"[flat-kernel] wseg_sum phases, exact D={D}: span {span_ns / 1e6:.4f} ms (marked "
          f"build); {len(m)} blocks (a window's part of its segments each), resident on an SM "
          f"{block.sum() * 1e3 / span_ns / sms:.2f} on average, a block p50 "
          f"{np.percentile(block, 50):.2f} p90 {np.percentile(block, 90):.2f} max "
          f"{block.max():.2f} us, {m[:, 3].mean():.0f} real slots: the list of slots "
          f"{(m[:, 1] - m[:, 0]).mean() / 1e3:.2f} us, the sums {(m[:, 2] - m[:, 1]).mean() / 1e3:.2f}"
          " us", flush=True)


SYNTHETIC_GRAPHS = 2048  # [synthetic]'s molecules (one serving batch)


def synthetic_phase(pkg, cfg, seed: int) -> None:
    """``[synthetic]``: ``data/synthetic.make_synthetic_batch`` (2048 ring
    molecules with stereo rows, from ``seed``) with kernel 7's layouts,
    served at the flagship's widths on the card (kernel 7 once a layer) and
    held against the same forward on the CPU (plain versions), E2E_TOL."""
    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax
    from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts
    from aimnet_x2d_tpu_torch.data.synthetic import make_synthetic_batch
    from aimnet_x2d_tpu_torch.ops import fused_edge

    t0 = time.perf_counter()
    host = attach_flat_layouts(make_synthetic_batch(num_graphs=SYNTHETIC_GRAPHS, seed=seed,
                                                    num_tasks=cfg.output_dim, with_stereo=True))
    t_make = time.perf_counter() - t0
    weights = params_from_flax(init_params(cfg, seed))
    preds = {}
    for dev in ("cuda", "cpu"):
        model = pkg.models.gnn.GNN(cfg)
        model.load_state_dict(weights)
        model.to(dev).eval()
        fused_edge.fused_edge_fwd.launches = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            preds[dev] = model(host.to(dev)).predictions.float().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = fused_edge.fused_edge_fwd.launches
        preds[dev + "_s"] = time.perf_counter() - t0
        del model
    got, ref = preds["cuda"], preds["cpu"]
    rel = float((got - ref).abs().max() / ref.abs().max())
    print(f"[synthetic] {SYNTHETIC_GRAPHS} synthetic molecules ({int(host.atom_mask.sum())} atoms, "
          f"{int(host.edge_mask.sum())} edges, {int(host.tet_mask.sum())} tetrahedral and "
          f"{int(host.cis_mask.sum() + host.trans_mask.sum())} cis/trans rows; made in "
          f"{t_make:.3f} s) served at the flagship's widths: card vs CPU max|d|/max|cpu| "
          f"{rel:.3e} (tol {E2E_TOL:g}); kernel 7 launches {launches}; forward "
          f"{preds['cuda_s']:.3f} s on the card (first call), {preds['cpu_s']:.3f} s on the CPU "
          f"(host clock)", flush=True)
    if not (torch.isfinite(got).all() and got.shape == (SYNTHETIC_GRAPHS, cfg.output_dim)
            and rel <= E2E_TOL and launches == cfg.num_message_passing_layers):
        raise AssertionError("[synthetic] the card's forward disagrees with the CPU or skipped "
                             "kernel 7")


def check_pool6_kernel(cfg, model, batch, seed: int, marks_build) -> dict:
    """``[pool6-kernel]``: kernel 6 (``bin_pool_fwd``; ``bin_pool_bwd`` from
    the forward's attention weights, with its fixed-order sum of the per-bin
    weight-gradient partials) against its plain version at the flagship
    training shape, on the loader's pool matrix and the model's score
    kernel folded through concat_self_other, fp32 and bf16, with times and
    the bound."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_pool

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    pm = batch.pool_mat
    nb, mb, ab = pm.shape
    A, B = nb * ab, nb * mb
    Ds, Do, H = cfg.x_self_dim, cfg.x_other_dim, cfg.attention_num_heads
    n, npm = int(batch.atom_mask.sum()), int((pm != 0).sum())
    print(f"[pool6-kernel] shapes nb={nb} ab={ab} mb={mb} A={A} real atoms={n} Ds={Ds} Do={Do} "
          f"H={H}", flush=True)
    bin_attnpool.check_one_owner(pm)  # the kernels' precondition, on the loader's matrix
    with torch.no_grad():
        score_k, score_b = model.pooling._score_fold(model.concat_self_other.weight.T,
                                                      model.concat_self_other.bias)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        isz = torch.tensor([], dtype=dt).element_size()
        xs = torch.randn(A, Ds, generator=gen, device=dev).to(dt)
        xo = torch.randn(A, Do, generator=gen, device=dev).to(dt)
        ks, ko, b = score_k[:Ds].to(dt), score_k[Ds:].to(dt), score_b.float()
        fwd = (xs, xo, pm, ks, ko, b)
        got, ref = bin_pool.bin_pool_fwd(*fwd), bin_pool.pool_fwd_plain(*fwd)
        torch.cuda.synchronize()
        cot = [torch.randn(*s, generator=gen, device=dev) * 1e-3 for s in ((B, Ds), (B, Do), (B,))]
        bwd = (xs, xo, pm, ks, ko, ref[3], *cot)
        bg, br = bin_pool.bin_pool_bwd(*bwd), bin_pool.pool_bwd_plain(*bwd)
        torch.cuda.synchronize()
        # d_b is a sum of terms that cancel to 0 (a bias shifts a head's
        # scores alike): held to d_ks's scale
        dks_scale = float(br[2][0].abs().max())
        cases = {
            "bin_pool_fwd": (list(zip(got, ref, [None] * 4)), fwd, bin_pool.bin_pool_fwd,
                             bin_pool.pool_fwd_plain,
                             # inputs once, outputs once; scores on the real
                             # atoms, the pools on their members
                             (Ds + Do) * A * isz + nb * mb * ab + 4 * ((Ds + Do) * H + H)
                             + 4 * ((Ds + Do + 1) * B + H * A),
                             2 * n * H * (Ds + Do) + 2 * npm * (Ds + Do + 1)),
            "bin_pool_bwd": ([(bg[0], br[0], None), (bg[1], br[1], None)]
                             + [(a, r, dks_scale if i == 2 else None)
                                for i, (a, r) in enumerate(zip(bg[2], br[2]))],
                             bwd, bin_pool.bin_pool_bwd, bin_pool.pool_bwd_plain,
                             2 * (Ds + Do) * A * isz + nb * mb * ab + 4 * (Ds + Do) * H
                             + 4 * (H * A + (Ds + Do + 1) * B) + 4 * ((Ds + Do) * H + H),
                             2 * n * (Ds + Do) * (2 * H + 2)),
        }
        for name, (pairs, args, fn, plain, nbytes, ops) in cases.items():
            abs_err, rel = _max_rel(pairs)
            tol = POOL6_TOL[dt]
            plain_ms = time_ms(lambda: plain(*args), iters=5)
            run = lambda: fn(*args)  # noqa: E731
            ms, timing, _ = bwd_record("pool6-kernel", name, dt, run, plain_ms)
            check_route("pool6-kernel", name, run, dt, fn.routes, fp32_new=True)
            t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[dt]
            bound_ms = 1e3 * max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"[pool6-kernel] {name} {str(dt)[6:]}: max_abs_err={abs_err:.3e} rel={rel:.3e} "
                  f"(tol {tol:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by}; {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)", flush=True)
            if not rel <= tol:
                raise AssertionError(f"{name} {dt}: rel err {rel:.3e} > {tol:g}")
            res[(name, dt)] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                                   timing=timing)
        again = bin_pool.bin_pool_fwd(*fwd)
        if not all(torch.equal(a, r) for a, r in zip(got, again)):
            raise AssertionError(f"bin_pool_fwd {dt}: a rerun is not bit-equal")
        again = bin_pool.bin_pool_bwd(*bwd)
        same = all(torch.equal(a, r) for a, r in zip((bg[0], bg[1], *bg[2]),
                                                       (again[0], again[1], *again[2])))
        print(f"[pool6-kernel] bin_pool_bwd {str(dt)[6:]} twice: bit-equal {same}", flush=True)
        if not same:
            raise AssertionError(f"two runs of bin_pool_bwd {dt} differ")
        check_pool6_bins(*fwd, cot)
        pool6_bwd_phases(marks_build, "pool6-kernel", *bwd)
    pool6_fwd_phases(marks_build, "pool6-kernel", *fwd)
    return res


# --------------------------------------------------------------------- #
# Halo graph-partitioned training: kernel 5 and the rank grid on one card
# --------------------------------------------------------------------- #

HALO_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# [halo-step]: the four ranks' summed gradients against the single-rank step
# on the same molecules.  bf16: the bf16 bar (TRAIN_TOL).  fp32: the same
# fp32 products summed in another order, and through another route (the
# single rank runs these batches on the flat layout, kernel 7; the ranks on
# binned halo shards, kernel 5): 1e-3 of each gradient's largest value.
HALO_STEP_TOL = {torch.float32: 1e-3, torch.bfloat16: TRAIN_TOL}
HALO_TIMED_STEPS = 8
# [c3-halo-train]'s CLI learning rate: at the flagship's 1e-3 config 3's
# CLI loss rises over its 3 epochs of 2 steps on one rank too ([c3-train])
C3_HALO_LR = "2e-4"


def halo_shard(ds, n: int, G: int):
    """The first ``n`` molecules of ``ds`` collated as one data shard and
    halo-partitioned into G binned graph shards: (stacked (G, ...) host
    batch, HaloStats, the collated batch)."""
    from aimnet_x2d_tpu_torch.data.batching import collate
    from aimnet_x2d_tpu_torch.parallel.halo import partition_halo

    b = collate(ds.features[:n], ds.targets[:n], num_hops=ds.max_hops)
    parts, stats = partition_halo(b, G, return_stats=True, binned=True)
    return parts, stats, b


def check_halo_kernel(cfg, model, ds, seed: int, marks_build) -> dict:
    """``[halo-kernel]``: kernel 5 (``mp_ext_fwd`` serving and training
    forms, ``mp_ext_bwd``) against its plain version at the flagship layer
    (D 153, 2 blocks) on one graph rank's share of a 2048-molecule training
    batch (G 2, ab 256): xa = [x ; the local per-bin plus halo aggregation],
    fp32 and bf16, the backward twice (bit-equal), timed with bounds."""
    from aimnet_x2d_tpu_torch.data.batching import index_batch
    from aimnet_x2d_tpu_torch.ops import bin_mp, halo

    dev = torch.device("cuda")
    parts, stats, _ = halo_shard(ds, 2048, 2)
    shard = index_batch(parts, 0).to(dev)
    D, nblk = cfg.x_other_dim, cfg.shell_conv_num_mlp_layers
    A = shard.atom_type.shape[0]
    H = shard.halo_send_idx.numel()
    n_real = int(shard.atom_mask.sum())
    print(f"[halo-kernel] rank 0 of 2: A_loc={A} ({n_real} real atoms, "
          f"{shard.bin_adj.shape[0]} bins), halo rows {stats.halo_rows}, cut edges "
          f"{stats.cut_edges}, split molecules {stats.split_molecules}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    w_mat = 2 * (2 * D * D) + nblk * 2 * D * D  # weight matrix elements of the layer
    # operations: 2 per multiply-add, over the real atoms (padded columns
    # are zero: no work).  Forward: the products, w_mat.  Backward: the
    # recompute (no W_s, no last W2: (1 + 2 nblk) D^2), the walk back
    # ((4 + 2 nblk) D^2: W_s^T and W_in^T onto dxa, W2^T and W1^T per
    # block) and the weight gradients (w_mat): 21/8 of the forward at 2 blocks
    fwd_ops = 2 * n_real * w_mat
    bwd_ops = 2 * n_real * ((1 + 2 * nblk) * D * D + (4 + 2 * nblk) * D * D + w_mat)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        isz = torch.finfo(dt).bits // 8
        with torch.no_grad():
            sw = bin_mp.stack_weights([model.message_passing_layers[0].stack_weights()], dt)
            x = (torch.randn(D, A, generator=gen, device=dev) * shard.atom_mask).to(dt)
            haloT = torch.randn(D, H, generator=gen, device=dev).to(dt)
            agg = halo.binned_local_agg_t(x, shard.bin_adj, dt)
            agg = agg + halo.halo_agg_contrib_t(haloT, shard.halo_adj, dt)
            xa = torch.cat([x, agg.to(dt)]).contiguous()
            gy = (torch.randn(D, A, generator=gen, device=dev) * 0.05).to(dt)
        tol = HALO_TOL[dt]
        for name, rate in (("mp_ext_fwd", 0.0), ("mp_ext_fwd_train", 0.05)):
            spec = bin_mp.StackSpec(cfg.activation_type, rate, 0x5EED5)
            out = bin_mp.mp_ext_fwd(xa, sw, spec)
            ref = bin_mp.mp_ext_plain(xa, sw, spec)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(out, ref)
            plain_ms = time_ms(lambda: bin_mp.mp_ext_plain(xa, sw, spec), iters=5)
            run = lambda: bin_mp.mp_ext_fwd(xa, sw, spec)  # noqa: E731
            ms, timing, _ = bwd_record("halo-kernel", name, dt, run, plain_ms)
            check_route("halo-kernel", name, run, dt, bin_mp.mp_ext_fwd.routes,
                        "wgmma", "tiles")
            if not torch.equal(out, bin_mp.mp_ext_fwd(xa, sw, spec)):
                raise AssertionError(f"{name} {dt}: a rerun is not bit-equal")
            nbytes = 3 * D * A * isz + w_mat * isz
            t_ops, t_bytes = fwd_ops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_S
            bound_ms, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
            print(f"[halo-kernel] {name} {str(dt)[6:]}: max_abs_err={abs_err:.3e} rel={rel:.3e} "
                  f"(tol {tol:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({by}; {fwd_ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
            if not rel <= tol:
                raise AssertionError(f"{name}: rel err {rel:.3e} > {tol:g}")
            if name == "mp_ext_fwd_train":
                res[("mp_ext_fwd", dt)] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                               bound_ms=bound_ms, bound_by=by, library_ms=None,
                                               timing=timing)
                if dt == torch.bfloat16:
                    ext_fwd_phases(marks_build, "halo-kernel", xa, sw, spec)
        spec = bin_mp.StackSpec(cfg.activation_type, 0.05, 0x5EED5)
        got = bin_mp.mp_ext_bwd(xa, sw, spec, gy)
        again = bin_mp.mp_ext_bwd(xa, sw, spec, gy)
        want = bin_mp.mp_ext_bwd_plain(xa, sw, spec, gy)
        torch.cuda.synchronize()
        same = torch.equal(got[0], again[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], again[1]))
        abs_err, rel = _max_rel([(got[0], want[0], None)]
                                + [(a, r, None) for a, r in zip(got[1], want[1])])
        plain_ms = time_ms(lambda: bin_mp.mp_ext_bwd_plain(xa, sw, spec, gy), iters=3)
        ms, timing, names = bwd_record("halo-kernel", "mp_ext_bwd", dt,
                                       lambda: bin_mp.mp_ext_bwd(xa, sw, spec, gy), plain_ms)
        # this tree's routes: bf16 on the stack's walk, fp32 on the slab
        # kernel, each with one grouped contraction and one partial sum
        if names is not None:
            walk = dt == torch.bfloat16
            seen = {k: launches_named(names, k) for k in (
                "bwd_walk_kernel", "ext_bwd_kernel", "wgrad_group", "wgrad_kernel", "sum_partials")}
            want_seen = {"bwd_walk_kernel": int(walk), "ext_bwd_kernel": int(not walk),
                         "wgrad_group": 1, "wgrad_kernel": 0, "sum_partials": 1}
            print(f"[halo-kernel] mp_ext_bwd {str(dt)[6:]} launches a call: {seen}", flush=True)
            if seen != want_seen:
                raise AssertionError(f"mp_ext_bwd {dt}: launches {seen}, want {want_seen}")
        nbytes = (2 * D + D + 2 * D) * A * isz + w_mat * isz + 4 * w_mat
        t_ops, t_bytes = bwd_ops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_S
        bound_ms, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        print(f"[halo-kernel] mp_ext_bwd {str(dt)[6:]}: max_abs_err={abs_err:.3e} rel={rel:.3e} "
              f"(tol {tol:g}) rerun bit-equal={same} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({by}; {bwd_ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)",
              flush=True)
        if not rel <= tol or not same:
            raise AssertionError(f"mp_ext_bwd: rel err {rel:.3e} (tol {tol:g}), bit-equal {same}")
        res[("mp_ext_bwd", dt)] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=by, library_ms=None,
                                       timing=timing)
    return res


def _digest(named) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, t in named:
        h.update(k.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _counters() -> dict:
    """The kernel counters the halo ranks read, by name."""
    from aimnet_x2d_tpu_torch.ops import bin_inject, bin_mp, fused_edge

    return {"mp_ext_fwd": bin_mp.mp_ext_fwd, "mp_ext_bwd": bin_mp.mp_ext_bwd,
            "inject_fwd": bin_inject.inject_fwd, "inject_bwd": bin_inject.inject_bwd,
            "fused_edge_fwd": fused_edge.fused_edge_fwd,
            "fused_edge_bwd": fused_edge.fused_edge_bwd}


def trace_kernels(path: str) -> dict:
    """The kernel events of a ``utils/profiling.trace`` file by name:
    {name: (launches, device ms summed)}."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("cat") == "kernel"]
    out = {}
    for e in events:
        n, ms = out.get(e.get("name", ""), (0, 0.0))
        out[e.get("name", "")] = (n + 1, ms + e.get("dur", 0) / 1e3)
    return out


def _halo_step_rank(rank: int, job_path: str, port: int, out_dir: str) -> None:
    """One of the four ranks (data 2 x graph 2, gloo, all on cuda:0) of
    ``[halo-step]``, ``[c3-halo-step]`` and ``[edge-step]``: for each case
    of the job one train step of the grid per dtype, Adam without the clip
    so the gradients stay the all-reduced ones; writes rank 0's loss and
    gradients, and every rank's kernel launches and digests of its gradients
    and parameters.  A case with ``timed`` N then takes N more bf16 steps
    timed by ``utils/profiling.StepTimer`` (host clock, the card
    synchronized) and one step inside ``utils/profiling.trace``, whose file
    gives the step's device ms (its kernel events summed)."""
    import pickle
    import shutil

    sys.path.insert(0, ROOT)
    from aimnet_x2d_tpu_torch.checkpoint import params_from_flax
    from aimnet_x2d_tpu_torch.data.batching import index_batch
    from aimnet_x2d_tpu_torch.models.gnn import GNN
    from aimnet_x2d_tpu_torch.parallel import mesh, multihost
    from aimnet_x2d_tpu_torch.training import trainer
    from aimnet_x2d_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dev = mesh.local_rank_device(rank, "cuda")
    backend = mesh.choose_backend(dev, 4)
    multihost.initialize(f"localhost:{port}", 4, rank, backend, dev)
    counters = _counters()
    try:
        grid = mesh.make_grid(2, 2, dev, backend)
        out = {}
        for case, c in job.items():
            batch = index_batch(c["stacked"], grid.data.index, grid.graph.index).to(dev)
            for tag, cfg in c["cfgs"].items():
                model = GNN(cfg)
                model.load_state_dict(params_from_flax(c["params"]))
                model.to(dev).train()
                opt = trainer.Optimizer(model.parameters(), None)
                loss_fn = trainer.make_loss_fn(trainer.TrainConfig(task_type=cfg.task_type))
                for k in counters.values():
                    k.launches = 0
                loss, n = trainer.train_step(model, opt, batch, 1e-3, loss_fn, grid=grid)
                torch.cuda.synchronize()
                grads = [(k, p.grad) for k, p in model.named_parameters() if p.grad is not None]
                r = dict(loss=float(loss), n=float(n), grads_digest=_digest(grads),
                         where=f"{dev} {backend}", params_digest=_digest(model.named_parameters()),
                         launches={k: v.launches for k, v in counters.items()})
                if rank == 0:
                    r["grads"] = {k: g.float().cpu() for k, g in grads}
                if c.get("timed") and tag == "bfloat16":
                    edges = int(batch.edge_mask.sum())
                    timer = profiling.StepTimer()
                    for _ in range(c["timed"]):
                        timer.start()
                        loss, _ = trainer.train_step(model, opt, batch, 1e-3, loss_fn, grid=grid)
                        timer.stop(loss, num_real_edges=edges)
                    trace_dir = os.path.join(out_dir, f"{case}-trace-rank{rank}")
                    shutil.rmtree(trace_dir, ignore_errors=True)  # this run's file alone
                    with profiling.trace(trace_dir):
                        loss, _ = trainer.train_step(model, opt, batch, 1e-3, loss_fn, grid=grid)
                        torch.cuda.synchronize()
                    files = os.listdir(trace_dir)
                    path = os.path.join(trace_dir, files[0]) if files else None
                    kernels = trace_kernels(path) if path else {}
                    r.update(timer=timer.summary(), trace=path,
                             trace_bytes=os.path.getsize(path) if path else 0,
                             device_ms=sum(ms for _, ms in kernels.values()),
                             trace_kernels=sum(n for n, _ in kernels.values()),
                             trace_edge_agg=sum(n for k, (n, _) in kernels.items()
                                                if "edge_agg" in k),
                             trace_top=sorted(kernels.items(), key=lambda kv: -kv[1][1])[:4])
                out[(case, tag)] = r
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        multihost.sync()
    finally:
        multihost.shutdown()


def halo_step_data(tag: str, cfg, full, seed: int):
    """The data of a grid step on the SMILES of ``full``, each data shard
    halo-partitioned into 2 binned graph shards.  With molecules larger than
    a bin (the flat SMILES): data shard 0 the first 1024 molecules as they
    come, data shard 1 a molecule larger than a bin and the 4 after it, more
    than half of the shard's atoms, so the graph cut must split it (cut
    edges cross the ranks); the large molecules are chunked into bin-sized
    pieces whose cross-bin edges run through ``halo_adj``.  Without them
    (config 3's stereo SMILES and ``C3_SPLIT_SMILES``): data shard 1 the
    largest molecule after the first 1024 and the 4 after it, the cut
    splitting the large one inside a bin.  Returns (the job's case: stacked
    shards, configs by dtype with the dropouts off, the weights; the
    collated data shards)."""
    import dataclasses

    from aimnet_x2d_tpu_torch.checkpoint import init_params
    from aimnet_x2d_tpu_torch.data.batching import collate, stack_batches
    from aimnet_x2d_tpu_torch.parallel.halo import partition_halo, partition_halo_stack

    targets = synthetic_targets(full, cfg.output_dim, seed)
    sizes = np.array([f.num_atoms for f in full.features])
    if sizes.max() > 256:
        first = int(np.flatnonzero(sizes[1024:] > 256)[0]) + 1024
    else:
        first = int(np.argmax(sizes[1024:])) + 1024
    picks = [np.arange(1024), np.arange(first, first + 5)]
    shards = [collate([full.features[i] for i in idx], targets[idx], num_hops=full.max_hops)
              for idx in picks]
    # one graph and stereo slot count for both shards, as a loader pins them
    caps = dict(graph_slots=1024, tet_slots=max(b.tet_nbrs.shape[0] for b in shards),
                pair_slots=max(max(b.cis_pairs.shape[0], b.trans_pairs.shape[0]) for b in shards))
    shards = [collate([full.features[i] for i in idx], targets[idx], num_hops=full.max_hops,
                      **caps) for idx in picks]
    t0 = time.perf_counter()
    parts, slots = partition_halo_stack(shards, 2, binned=True)
    t_part = time.perf_counter() - t0
    stats = [partition_halo(s, 2, return_stats=True, binned=True, **slots)[1] for s in shards]
    big = [int((sizes[idx] > 256).sum()) for idx in picks]
    stereo = [int(p.tet_mask.sum()) for p in parts], [int(p.cis_mask.sum() + p.trans_mask.sum())
                                                      for p in parts]
    print(f"[{tag}] 2 data shards ({[len(i) for i in picks]} molecules, {big} larger than a "
          f"bin) x 2 graph shards: halo_rows {[s.halo_rows for s in stats]}, cut_edges "
          f"{[s.cut_edges for s in stats]}, split_molecules {[s.split_molecules for s in stats]}, "
          f"A_loc {stats[0].atom_slots_per_device}, Hp {stats[0].halo_pair_slots}; tetrahedral "
          f"rows per data shard {stereo[0]}, cis/trans rows {stereo[1]}; partition "
          f"{t_part:.3f} s (host clock)", flush=True)
    # every shard has halo rows where large molecules are chunked; the
    # split molecule's shard has cut edges
    chunked = stats if sizes.max() > 256 else stats[1:]
    if (min(s.halo_rows for s in chunked) <= 0 or stats[1].cut_edges <= 0
            or stats[1].split_molecules <= 0):
        raise AssertionError(f"[{tag}] the partition has no halo rows, cut edges or split "
                             f"molecule")
    if cfg.use_stereochemistry and not (sum(stereo[0]) and sum(stereo[1])):
        raise AssertionError(f"[{tag}] the shards hold no stereo rows")
    cfgs = {str(dt)[6:]: dataclasses.replace(cfg, shell_conv_dropout=0.0, ffn_dropout=0.0,
                                             compute_dtype=str(dt)[6:])
            for dt in (torch.bfloat16, torch.float32)}
    case = {"stacked": stack_batches(parts), "cfgs": cfgs, "params": init_params(cfg, seed)}
    return case, shards


EDGE_MOLECULES = 512  # [edge-step]'s molecules a data rank
EDGE_TIMED_STEPS = 4  # [edge-step]'s steps a rank timed by StepTimer (the first a warm-up)


def unshard_edges(stacked, d: int, G: int):
    """Data shard ``d`` of a stacked (N, G, ...) edge-sharded host batch with
    its edges put back together (the padding edges stay masked)."""
    import dataclasses

    from aimnet_x2d_tpu_torch.data.batching import index_batch

    parts = [index_batch(stacked, d, g) for g in range(G)]
    return dataclasses.replace(parts[0], **{
        k: np.concatenate([getattr(p, k) for p in parts])
        for k in ("edge_src", "edge_dst", "edge_hop", "edge_mask")})


def edge_step_data(cfg, full, seed: int):
    """``[edge-step]``'s data: the first 2 x EDGE_MOLECULES molecules of the
    flat SMILES (each data shard holds molecules larger than a bin, so it is
    flat) through ``BatchLoader(stack_devices=2, edge_shards=2)``: the
    stacked (2, 2, ...) edge shards, every atom on both graph ranks of a
    data shard and half its edges on each.  Returns (the job's case: stacked
    shards, configs by dtype with the graph axis set and the dropouts off,
    the weights, the timed steps; the data shards with their edges put back
    together)."""
    import dataclasses

    from aimnet_x2d_tpu_torch.checkpoint import init_params
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset

    n = 2 * EDGE_MOLECULES
    ds = MoleculeDataset(full.smiles[:n], synthetic_targets(full, cfg.output_dim, seed)[:n],
                         full.features[:n], full.max_hops)
    t0 = time.perf_counter()
    loader = BatchLoader(ds, EDGE_MOLECULES, stack_devices=2, edge_shards=2)
    stacked = next(iter(loader))
    t_load = time.perf_counter() - t0
    sizes = ds.sizes()["atoms"]
    big = [int((sizes[d * EDGE_MOLECULES:(d + 1) * EDGE_MOLECULES] > 256).sum()) for d in range(2)]
    real = stacked.edge_mask.sum(axis=2).tolist()
    print(f"[edge-step] 2 data shards of {EDGE_MOLECULES} molecules ({big} larger than a bin; "
          f"binned {loader.binned}) x 2 edge shards: A {stacked.atom_type.shape[2]} atom slots, "
          f"{stacked.edge_src.shape[2]} edge slots a rank, real edges by rank {real}; loader "
          f"{t_load:.3f} s (host clock)", flush=True)
    if loader.binned or min(big) < 1 or stacked.fused_fwd is not None:
        raise AssertionError("[edge-step] the edge shards are not flat, hold no large molecule "
                             "or carry kernel-7 layouts")
    cfgs = {str(dt)[6:]: dataclasses.replace(cfg, shell_conv_dropout=0.0, ffn_dropout=0.0,
                                             compute_dtype=str(dt)[6:], graph_axis="graph")
            for dt in (torch.bfloat16, torch.float32)}
    case = {"stacked": stacked, "cfgs": cfgs, "params": init_params(cfg, seed),
            "timed": EDGE_TIMED_STEPS}
    return case, [unshard_edges(stacked, d, 2) for d in range(2)]


# [c3-halo-step]'s molecule that the graph cut splits: 197 atoms with
# hydrogens (it fits a bin, so the single-rank step runs binned), with a
# tetrahedral centre and a trans double bond
C3_SPLIT_SMILES = "C" * 30 + "[C@H](F)C/C=C/C" + "C" * 30


# each grid-step case's kernel launches on every rank: kernel 5 forward and
# backward once a layer on halo shards; on edge shards no kernel (the layers
# sum their edges by index_add and psum, as JAX's segment_sum), kernel 7 never
STEP_LAUNCHES = {
    "halo-step": {"mp_ext_fwd": 3, "mp_ext_bwd": 3, "inject_fwd": 0, "inject_bwd": 0},
    "c3-halo-step": {"mp_ext_fwd": 3, "mp_ext_bwd": 3, "inject_fwd": 0, "inject_bwd": 0},
    "edge-step": {"mp_ext_fwd": 0, "mp_ext_bwd": 0, "inject_fwd": 0, "inject_bwd": 0,
                  "fused_edge_fwd": 0, "fused_edge_bwd": 0},
}


def halo_step_phase(pkg, cases: dict, seed: int, work: str, edge=None) -> None:
    """``[halo-step]``, ``[c3-halo-step]`` and ``[edge-step]``, one start of
    4 ranks (data 2 x graph 2) sharing the card over gloo: one train step of
    each case's model (``cases``: tag -> (config, dataset); the flagship on
    the flat SMILES, config 3 with both features on the stereo SMILES;
    dropouts off) on ``halo_step_data``'s shards, and of the flagship on
    ``edge_step_data``'s edge shards of the flat SMILES (``edge``: (config,
    dataset)), in bf16 and fp32: loss and summed gradients against the
    single-rank step on the card over the same molecules (the weighted mean
    of the two data shards' steps, binned -- config 3 on the inject route,
    whose injections run in the compute dtype as the halo stack's do -- or,
    with molecules larger than a bin, flat, through kernel 7), gradients and
    parameters bit-identical across the ranks, each rank's launches as
    ``STEP_LAUNCHES`` has them; ``[edge-step]`` also prints each rank's
    StepTimer host ms and its traced step's device ms and trace file."""
    import dataclasses
    import pickle

    import torch.multiprocessing as mp

    from aimnet_x2d_tpu_torch.checkpoint import params_from_flax
    from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts
    from aimnet_x2d_tpu_torch.data.binning import bin_pack_batch
    from aimnet_x2d_tpu_torch.ops import fused_edge
    from aimnet_x2d_tpu_torch.training import trainer

    job, shards = {}, {}
    for tag, (cfg, full) in cases.items():
        job[tag], shards[tag] = halo_step_data(tag, cfg, full, seed)
    if edge is not None:
        job["edge-step"], shards["edge-step"] = edge_step_data(*edge, seed)
        cases = dict(cases, **{"edge-step": edge})
    out_dir = os.path.join(work, "halo-step")
    os.makedirs(out_dir, exist_ok=True)
    job_path = os.path.join(out_dir, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    t0 = time.perf_counter()
    mp.spawn(_halo_step_rank, args=(job_path, _free_port(), out_dir), nprocs=4, join=True)
    print(f"[halo-step] 4 ranks ran {list(cases)} in {time.perf_counter() - t0:.1f} s (host "
          f"clock, process start included)", flush=True)
    ranks = []
    for r in range(4):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for case in cases:
        flat = job[case]["params"]
        for tag, c in job[case]["cfgs"].items():
            dt = torch.bfloat16 if tag == "bfloat16" else torch.float32
            loss_fn = trainer.make_loss_fn(trainer.TrainConfig(task_type=c.task_type))
            r0 = ranks[0][(case, tag)]
            same = all(r[(case, tag)]["params_digest"] == r0["params_digest"]
                       and r[(case, tag)]["grads_digest"] == r0["grads_digest"] for r in ranks)
            want = STEP_LAUNCHES[case]
            launches = [{k: r[(case, tag)]["launches"][k] for k in want} for r in ranks]
            # the single-rank step on the card: each data shard whole
            # (binned when its molecules fit a bin, else flat), gradients
            # weighted by its molecules
            model = pkg.models.gnn.GNN(dataclasses.replace(c, graph_axis=None))
            model.load_state_dict(params_from_flax(flat))
            model.to("cuda").train()
            ref, loss_sum, n_sum = {}, 0.0, 0.0
            binned = cases[case][1].sizes()["atoms"].max() <= 256
            edge_kernels = (fused_edge.fused_edge_fwd, fused_edge.fused_edge_bwd)
            for k in edge_kernels:
                k.launches = 0
            for s in shards[case]:
                b = (bin_pack_batch(s) if binned else attach_flat_layouts(s)).to("cuda")
                model.zero_grad(set_to_none=True)
                n = float(b.graph_mask.sum())
                loss = loss_fn(model(b, train=True).predictions, b.targets, b.graph_mask)
                loss.backward()
                for k, p in model.named_parameters():
                    if p.grad is not None:
                        ref[k] = ref.get(k, 0.0) + p.grad.float().cpu() * n
                loss_sum, n_sum = loss_sum + float(loss.detach()) * n, n_sum + n
            ref = {k: v / n_sum for k, v in ref.items()}
            ref_edge = [k.launches for k in edge_kernels]
            params = {k: p.detach().float().cpu() for k, p in model.named_parameters()}
            errs = {k: float((r0["grads"][k] - g).abs().max()) / grad_scale(k, params, ref, c)
                    for k, g in ref.items()}
            worst = max(errs.items(), key=lambda kv: kv[1])
            loss_rel = abs(r0["loss"] - loss_sum / n_sum) / abs(loss_sum / n_sum)
            tol = HALO_STEP_TOL[dt]
            shown = (f"on every rank {launches[0]}" if launches.count(launches[0]) == len(launches)
                     else f"by rank {launches}")
            print(f"[{case}] {tag}: loss {r0['loss']:.6f} vs single rank {loss_sum / n_sum:.6f} "
                  f"(rel {loss_rel:.2e}); {len(ref)} gradients, worst max|d|/max|ref| "
                  f"{worst[1]:.3e} ({worst[0]}; tol {tol:g}); molecules {r0['n']:.0f}; launches "
                  f"{shown} (want {want}); the single rank's kernel 7 (fwd, bwd) "
                  f"{ref_edge}; gradients and parameters bit-identical across ranks: {same}; "
                  f"ranks on {[r[(case, tag)]['where'] for r in ranks]}", flush=True)
            # the single rank's flat step runs kernel 7 once a layer, forward
            # and backward, on each data shard
            ref_ok = binned or ref_edge == [3 * len(shards[case])] * 2
            if not (loss_rel <= tol and worst[1] <= tol and same and r0["n"] == n_sum
                    and all(l == want for l in launches) and ref_ok):
                raise AssertionError(f"[{case}] {tag}: the grid step disagrees with the single "
                                     f"rank or across ranks, or launched the wrong kernels")
            timed = [r[(case, tag)] for r in ranks if "timer" in r[(case, tag)]]
            card = card_line() if timed else ""
            for rank, t in enumerate(timed):
                device = "not measured" if not t["device_ms"] else f"{t['device_ms']:.3f}"
                print(f"[{case}] {tag} rank {rank} ({card}): StepTimer "
                      f"{t['timer']['steps']} steps after a warm-up, host mean "
                      f"{t['timer']['mean_step_ms']:.3f} ms, p50 {t['timer']['p50_step_ms']:.3f} "
                      f"ms, {t['timer']['edges_per_sec']:.0f} edges/s (this rank's); one traced "
                      f"step's device ms {device} ({t['trace_kernels']} kernel events, "
                      f"{t['trace_edge_agg']} of kernel 7); trace file {t['trace']} "
                      f"({t['trace_bytes']} bytes); its largest kernels (ms, launches): "
                      + "; ".join(f"{ms:.3f} x{n} {k[:70]}" for k, (n, ms) in t["trace_top"]),
                      flush=True)
                if not t["trace_bytes"] or t["trace_edge_agg"]:
                    raise AssertionError(f"[{case}] rank {rank}: the trace file is missing or "
                                         f"empty, or shows kernel 7")
            if job[case].get("timed") and tag == "bfloat16" and len(timed) != 4:
                raise AssertionError(f"[{case}] the ranks returned no timing")
            del model


def _halo_train_rank(rank: int, job_path: str, out_dir: str) -> None:
    """One of the two ranks of ``[halo-train]`` and ``[c3-halo-train]``
    (and ``[rows-halo-step]``): for each case of the job, the CLI as
    ``torchrun`` runs it (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), with the kernel counters read around it; then, in a
    second process group, the case's train steps of the grid on
    card-resident halo shards of the same data, timed (host clock around a
    synchronized step, and one step's device time from the profiler) on the
    targets as the CLI's artifact transforms them, and, where the case has
    one, the serving forward of flat halo shards."""
    import pickle

    sys.path.insert(0, ROOT)
    from aimnet_x2d_tpu_torch import cli
    from aimnet_x2d_tpu_torch.checkpoint import init_params, load_artifact, params_from_flax
    from aimnet_x2d_tpu_torch.data.batching import index_batch
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader
    from aimnet_x2d_tpu_torch.models.gnn import GNN
    from aimnet_x2d_tpu_torch.parallel import mesh, multihost
    from aimnet_x2d_tpu_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    counters = _counters()
    dev = mesh.local_rank_device(rank, "cuda")
    backend = mesh.choose_backend(dev, 2)
    results = {}
    for case in job:
        os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                          MASTER_PORT=str(case["ports"][0]))
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        summary = cli.main(case["argv"])
        out = {"cli_s": time.perf_counter() - t0, "summary": summary,
               "launches": {k: c.launches for k, c in counters.items()}, "where": f"{dev} {backend}"}
        multihost.initialize(f"localhost:{case['ports'][1]}", 2, rank, backend, dev)
        try:
            grid = mesh.make_grid(1, 2, dev, backend)
            cfg, ds = case["cfg"], case["ds"]
            ds = ds.with_targets(load_artifact(case["art"]).pipeline.transform(
                ds.atomic_numbers(), ds.targets))
            loader = BatchLoader(ds, 2048, shuffle=True, seed=case["seed"],
                                 stack_devices=1, halo_shards=2, rank=(0, rank))
            batches = []
            for epoch in range(case["steps"] // len(loader) + 1):
                loader.set_epoch(epoch)
                batches += [b.to(dev) for b in loader]
            batches = batches[:case["steps"]]
            model = GNN(cfg)
            model.load_state_dict(params_from_flax(init_params(cfg, case["seed"])))
            model.to(dev).train()
            opt = trainer.Optimizer(model.parameters(), 1.0)
            loss_fn = trainer.make_loss_fn(trainer.TrainConfig(task_type=cfg.task_type))
            gen = torch.Generator(device=dev).manual_seed(case["seed"])

            def step(b, lr, drop_seed, gen):
                return trainer.train_step(model, opt, b, lr, loss_fn, drop_seed, gen, grid)

            ms, losses = [], []
            for c in counters.values():
                c.launches = 0
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _ = step(b, 5e-4, 1000 + i, gen)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(float(loss))
            out.update(step_ms=ms, losses=losses, a_loc=int(batches[0].atom_type.shape[0]),
                       per_step={k: c.launches / len(batches) for k, c in counters.items()})
            # one session only: the ranks' steps meet in collectives
            out["device_ms"] = profile_step(lambda: step(batches[0], 5e-4, 7, gen),
                                            f"{case['tag']} rank {rank}", top=6, tries=1)
            rows = case.get("rows")
            if rows is not None:
                m = GNN(rows["cfg"])
                m.load_state_dict(params_from_flax(rows["params"]))
                m.to(dev).eval()
                shard = index_batch(rows["stacked"], rank).to(dev)
                for c in counters.values():
                    c.launches = 0
                with torch.inference_mode():
                    pred = m(shard).predictions.float().cpu()
                torch.cuda.synchronize()
                out["rows"] = {"pred": pred, "launches": {k: c.launches
                                                          for k, c in counters.items()}}
            multihost.sync()
        finally:
            multihost.shutdown()
        results[case["tag"]] = out
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def rows_halo_data(cfg, fl_full, seed: int):
    """``[rows-halo-step]``'s data: the largest molecule of the flat SMILES
    first, then the smaller ones that follow it up to 80% of its atoms, so
    it holds more atoms than a rank's share and the graph cut splits it;
    collated flat and halo-partitioned into 2 flat graph shards (the
    row-major halo route); returns (the job's entry, the collated batch,
    HaloStats)."""
    import dataclasses

    from aimnet_x2d_tpu_torch.checkpoint import init_params
    from aimnet_x2d_tpu_torch.data.batching import collate
    from aimnet_x2d_tpu_torch.parallel.halo import partition_halo

    sizes = np.array([f.num_atoms for f in fl_full.features])
    big = int(np.argmax(sizes))
    order = [big]
    for i in range(len(sizes)):
        if sizes[i] <= 256 and sizes[order[1:]].sum() + sizes[i] <= 0.8 * sizes[big]:
            order.append(i)
    b = collate([fl_full.features[i] for i in order], np.zeros((len(order), cfg.output_dim),
                                                               np.float32),
                num_hops=fl_full.max_hops)
    stacked, stats = partition_halo(b, 2, return_stats=True)
    scfg = dataclasses.replace(cfg, shell_conv_dropout=0.0, ffn_dropout=0.0)
    return {"stacked": stacked, "cfg": scfg, "params": init_params(scfg, seed)}, b, stats


def halo_train_phase(pkg, cases: list, seed: int, work: str, rows=None) -> dict:
    """``[halo-train]`` and ``[c3-halo-train]``, one start of 2 ranks
    sharing the card (gloo): for each case (tag, config, dataset, the
    ``train_phase`` CSV it trains on, timed steps, the CLI's learning rate)
    the flagship-width CLI with ``--graph_shards 2 --mixed_precision``, 3
    epochs of 2 steps at batch 2048, kernel launches summed over the ranks
    and a falling loss; then timed steps per rank.  ``rows`` (``rows_halo_data``; run in the first
    case's group): ``[rows-halo-step]``, one serving forward of flat halo
    shards on the 2 ranks against the one-rank forward of the unsplit batch
    (bf16 bar).  Then the flagship's artifact served by the single-rank
    ``run_csv``.  Returns the first case's launches summed over the ranks."""
    import pickle

    import pandas as pd
    import torch.multiprocessing as mp

    from aimnet_x2d_tpu_torch.checkpoint import load_artifact, params_from_flax
    from aimnet_x2d_tpu_torch.data.batching import attach_flat_layouts
    from aimnet_x2d_tpu_torch.data.dataset import MoleculeDataset
    from aimnet_x2d_tpu_torch.inference.pipeline import StreamingInferencePipeline

    out_dir = os.path.join(work, "halo-train")
    os.makedirs(out_dir, exist_ok=True)
    job, meta = [], {}
    for tag, cfg, full, csv_name, steps, lr in cases:
        csv = os.path.join(work, csv_name)
        df = pd.read_csv(csv)
        cols = [c for c in df.columns if c != "smiles"]
        art = os.path.join(work, f"{tag}-trained.npz")
        argv = ["--data_path", csv, "--task_type", "multitask", "--mixed_precision", "--epochs",
                "3", "--batch_size", "2048", "--learning_rate", lr, "--num_shells",
                str(cfg.num_shells), "--pooling_type", cfg.pooling_type,
                "--num_message_passing_layers", str(cfg.num_message_passing_layers),
                "--model_save_path", art, "--seed", str(seed), "--multi_target_columns",
                ",".join(cols), "--graph_shards", "2"]
        argv += ["--use_partial_charges"] if cfg.use_partial_charges else []
        argv += ["--use_stereochemistry"] if cfg.use_stereochemistry else []
        ds = MoleculeDataset(full.smiles, df[cols].to_numpy(np.float32), full.features,
                             full.max_hops)
        job.append({"tag": tag, "argv": argv, "ports": (_free_port(), _free_port()), "ds": ds,
                    "cfg": cfg, "seed": seed, "steps": steps, "art": art,
                    "rows": rows[0] if rows is not None and not job else None})
        meta[tag] = (cfg, art, cols, full)
    job_path = os.path.join(out_dir, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    t0 = time.perf_counter()
    mp.spawn(_halo_train_rank, args=(job_path, out_dir), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    print(f"[halo-train] 2 ranks ran {[c[0] for c in cases]} in {wall:.1f} s with process start "
          f"(host clock)", flush=True)
    first = None
    for tag, (cfg, art, cols, full) in meta.items():
        res = [r[tag] for r in ranks]
        launches = {k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}
        hist = res[0]["summary"]["history"]
        print(f"[{tag}] CLI --graph_shards 2 on 2 ranks: {res[0]['cli_s']:.1f} s (host clock); "
              f"epochs train loss {[round(h['train_loss'], 5) for h in hist]}, val loss "
              f"{[round(h['val_loss'], 5) for h in hist]}, edges/s "
              f"{[round(h['edges_per_sec']) for h in hist]}, input wait "
              f"{[round(1e3 * h['input_wait_seconds'], 1) for h in hist]} ms; kernel launches "
              f"summed over the ranks {launches}", flush=True)
        for r, x in enumerate(res):
            med = float(np.median(x["step_ms"][2:])) if len(x["step_ms"]) > 2 else float(
                np.median(x["step_ms"]))
            print(f"[{tag}] rank {r} ({x['where']}): {len(x['step_ms'])} steps on A_loc "
                  f"{x['a_loc']}: median {med:.3f} ms/step (host clock around a synchronized "
                  f"step), device "
                  f"{x['device_ms'] if x['device_ms'] is None else round(x['device_ms'], 3)} "
                  f"ms (one step, profiler); loss {x['losses'][0]:.5f} -> {x['losses'][-1]:.5f}; "
                  f"kernel launches per step {x['per_step']}; step ms "
                  f"{[round(v, 3) for v in x['step_ms']]}", flush=True)
        losses = [h["train_loss"] for h in hist] + [h["val_loss"] for h in hist]
        ext = ("mp_ext_fwd", "mp_ext_bwd")
        # kernel 4's forward serves the CLI's validation and test on whole
        # (unsharded) batches; no step on the shards runs kernel 4
        if (min(launches[k] for k in ext) <= 0 or launches["inject_bwd"]
                or not np.isfinite(losses).all() or not hist[-1]["train_loss"] < hist[0]["train_loss"]
                or any(x["per_step"][k] != 3 for x in res for k in ext)
                or any(x["per_step"]["inject_fwd"] or x["per_step"]["inject_bwd"] for x in res)
                or any(not x["losses"][-1] < x["losses"][0] for x in res)
                or res[0]["summary"]["best_val_loss"] != res[1]["summary"]["best_val_loss"]):
            raise AssertionError(f"[{tag}] kernel 5 did not run on every layer of every step, "
                                 f"kernel 4 ran in a step, the loss did not fall, or the ranks "
                                 f"disagree: {launches}")
        loaded = load_artifact(art)
        mc = loaded.model_config
        if (mc.graph_axis is not None or mc.compute_dtype != "bfloat16"
                or mc.use_partial_charges != cfg.use_partial_charges
                or mc.use_stereochemistry != cfg.use_stereochemistry):
            raise AssertionError(f"the halo run saved another config: {mc}")
        first = first or launches
    if rows is not None:
        entry, host, stats = rows
        tag = cases[0][0]
        got = [r[tag]["rows"] for r in ranks]
        model = pkg.models.gnn.GNN(entry["cfg"])
        model.load_state_dict(params_from_flax(entry["params"]))
        model.to("cuda").eval()
        with torch.inference_mode():
            ref = model(attach_flat_layouts(host).to("cuda")).predictions.float().cpu()
        abs_err, rel = rel_err(got[0]["pred"], ref)
        same = torch.equal(got[0]["pred"], got[1]["pred"])
        print(f"[rows-halo-step] serving forward of 2 flat halo shards ({int(host.graph_mask.sum())} "
              f"molecules, {stats.split_molecules} split, cut edges {stats.cut_edges}, halo rows "
              f"{stats.halo_rows}, A_loc {stats.atom_slots_per_device}) against the one-rank "
              f"forward (kernel 7): max_abs_err={abs_err:.3e} rel={rel:.3e} (tol {E2E_TOL:g}); "
              f"ranks equal: {same}; launches per rank {[g['launches'] for g in got]}", flush=True)
        if (not rel <= E2E_TOL or not same or stats.split_molecules < 1 or stats.cut_edges <= 0
                or any(v for g in got for v in g["launches"].values())):
            raise AssertionError("[rows-halo-step] the flat halo forward disagrees with one rank, "
                                 "split nothing or launched a kernel")
    # the flagship's artifact, served by one rank
    tag = cases[0][0]
    art, full = meta[tag][1], meta[tag][3]
    cols = meta[tag][2]
    mols, preds = os.path.join(out_dir, "mols.csv"), os.path.join(out_dir, "preds.csv")
    pd.DataFrame({"smiles": full.smiles[:512]}).to_csv(mols, index=False)
    t0 = time.perf_counter()
    StreamingInferencePipeline(art, batch_size=512, device="cuda").run_csv(mols, preds)
    got = pd.read_csv(preds)
    vals = got[cols].to_numpy(np.float64)
    print(f"[{tag}] the artifact served by run_csv on one rank: {len(got)} rows in "
          f"{time.perf_counter() - t0:.2f} s, predictions in [{vals.min():.3f}, {vals.max():.3f}]",
          flush=True)
    if len(got) != 512 or not np.isfinite(vals).all():
        raise AssertionError("serving the halo-trained artifact lost rows or gave non-finite values")
    return first


def rank_serve_phase(work: str, n_rows: int) -> None:
    """``[rank-serve]``: the ``[serve]`` phase's flagship artifact and CSV
    served by ``python -m torch.distributed.run --nproc_per_node 2 -m
    aimnet_x2d_tpu_torch.cli`` (two gloo ranks sharing the card, each a
    contiguous half of the CSV; rank 0 merges): every rank exits 0, the
    merged CSV holds every row in input order and no rank file is left, its
    values within E2E_TOL (max|d| / max|ref|) of the one-rank output."""
    import re

    import pandas as pd

    art = os.path.join(work, "serve.npz")
    csv_in, one = os.path.join(work, "serve-mols.csv"), os.path.join(work, "serve-preds.csv")
    out = os.path.join(work, "rank-serve-preds.csv")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()), "-m",
           "aimnet_x2d_tpu_torch.cli", "--inference_csv", csv_in, "--model_save_path", art,
           "--inference_output", out, "--device", "cuda"]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    # the two ranks' "[inference]" lines (their prints may share a line)
    found = re.findall(r"\(rank (\d+) of 2\), \w+ \(([\d.]+) mol/s", p.stdout)
    for line in p.stdout.splitlines():
        if "[inference]" in line:
            print(f"[rank-serve] {line}", flush=True)
    if p.returncode != 0:
        print(p.stdout[-4000:] + p.stderr[-4000:], flush=True)
        raise AssertionError(f"[rank-serve] a rank exited {p.returncode}")
    got, ref = pd.read_csv(out), pd.read_csv(one)
    cols = [c for c in ref.columns if c != "smiles"]
    left = [f for f in (out + ".rank0", out + ".rank1") if os.path.exists(f)]
    in_order = got["smiles"].tolist() == ref["smiles"].tolist() and len(got) == n_rows
    a, b = got[cols].to_numpy(np.float64), ref[cols].to_numpy(np.float64)
    rel = float(np.abs(a - b).max() / np.abs(b).max()) if in_order else float("inf")
    mps = {int(r): float(m) for r, m in found}
    print(f"[rank-serve] 2 ranks on the card: {len(got)} rows of {n_rows}, in input order: "
          f"{in_order}; rank files left: {left}; against the one-rank [serve] output max|d| / "
          f"max|ref| {rel:.3e} (tol {E2E_TOL:g}); mol/s by rank {mps} (merged count over each "
          f"rank's own clock, process start excluded) against [serve]'s "
          f"{SERVE_MPS.get('serve', float('nan')):.1f}; {wall:.1f} s with process start (host "
          f"clock)", flush=True)
    if not in_order or left or not rel <= E2E_TOL or sorted(mps) != [0, 1]:
        raise AssertionError("[rank-serve] the merged output lost or reordered rows, left a rank "
                             "file or disagrees with one rank")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def halo_phases(pkg, tcfg, ds, full, fl_full, seed: int, work: str, res: dict,
                launches: dict, marks_build, c3_tcfg, c3_full) -> None:
    """Halo graph-partitioned training (``--graph_shards``): kernel 5 alone;
    one step of a 2 x 2 rank grid for the flagship and for config 3 (one
    start of 4 ranks); the CLI on 2 ranks for both, with the flat halo
    shards' serving forward (one start of 2 ranks); on one card the ranks
    share it over gloo, on several each has its own (NCCL)."""
    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax

    hmodel = pkg.models.gnn.GNN(tcfg)
    hmodel.load_state_dict(params_from_flax(init_params(tcfg, seed)))
    hmodel.to("cuda")
    res.update(check_halo_kernel(tcfg, hmodel, ds, seed, marks_build))
    del hmodel
    from aimnet_x2d_tpu_torch.data.dataset import MoleculeDataset

    c3_smiles = c3_full.smiles[:1024] + [C3_SPLIT_SMILES] + c3_full.smiles[1024:1028]
    c3_step = MoleculeDataset.from_smiles(c3_smiles, np.zeros((len(c3_smiles), 1), np.float32),
                                          c3_full.max_hops, FEAT_THREADS)
    halo_step_phase(pkg, {"halo-step": (tcfg, fl_full), "c3-halo-step": (c3_tcfg, c3_step)},
                    seed, work, edge=(tcfg, fl_full))
    rows = rows_halo_data(tcfg, fl_full, seed)
    first = halo_train_phase(
        pkg, [("halo-train", tcfg, full, "train.csv", HALO_TIMED_STEPS, "1e-3"),
              ("c3-halo-train", c3_tcfg, c3_full, "c3-train.csv", HALO_TIMED_STEPS, C3_HALO_LR)],
        seed, work, rows=rows)
    launches.update({k: v for k, v in first.items() if k.startswith("mp_ext")})


# ---- the rest of the CLI: hyperparameter search, embedding output, HDF5 ---- #

# The search seed of [hyperopt]: chosen on the CPU beforehand
# (hyperopt.sample_trials over example_hyperparams.yaml) so that its three
# trials sample hidden 384 (mean pooling, 4 shells, 2 heads), 256 (attention,
# 8 heads, 3 shells) and 256 (attention, 4 heads, 2 shells): x_other 115 and
# 76, x_self 269 and 180, both pooling types, next to the flagship's widths.
HYPEROPT_SEED = 16
HYPEROPT_BATCH = 512  # the trials' --batch_size: 7 steps an epoch of [train]'s CSV
HDF5_BATCH = 256  # [hdf5-train]'s --batch_size: 13 steps an epoch, so the loss falls in 2
EMBED_CPU = 256  # molecules of [embed-serve]'s and [hyperopt]'s card-vs-CPU checks


def deps_line() -> bool:
    """Print whether ``h5py`` and ``yaml`` import here; returns whether
    ``h5py`` does (the HDF5 phases run only then)."""
    import importlib.util

    has = {m: importlib.util.find_spec(m) is not None for m in ("h5py", "yaml")}
    print(f"[deps] h5py imports: {'yes' if has['h5py'] else 'no'}; yaml imports: "
          f"{'yes' if has['yaml'] else 'no'}", flush=True)
    return has["h5py"]


def _training_kernels():
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp, bin_wpool

    return (bin_mp.mp_stack_fwd_train, bin_mp.mp_stack_bwd, bin_mp.mp_stack_bwd_proj,
            bin_attnpool.attnpool_fwd, bin_attnpool.attnpool_bwd, bin_wpool.wpool_fwd,
            bin_wpool.wpool_bwd, bin_mp.mp_stack_fwd)


def _card_vs_cpu(pkg, art_path: str, smiles, tag: str) -> float:
    """Serve ``smiles`` with the artifact through the CLI on the card, and
    the first EMBED_CPU of them with the plain versions on the CPU; returns
    max|d| / max|cpu| of the scaled outputs (fails past E2E_TOL)."""
    import pandas as pd

    from aimnet_x2d_tpu_torch import cli
    from aimnet_x2d_tpu_torch.checkpoint import load_artifact, params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.training.predictor import predict

    art = load_artifact(art_path)
    work = os.path.dirname(art_path)
    csv_in, csv_out = (os.path.join(work, f"{tag}-{s}.csv") for s in ("mols", "preds"))
    pd.DataFrame({"smiles": smiles[:EMBED_CPU]}).to_csv(csv_in, index=False)
    cli.main(["--inference_csv", csv_in, "--model_save_path", art_path, "--inference_output",
              csv_out, "--device", "cuda"])
    cols = art.extra["target_columns"]
    vals = pd.read_csv(csv_out)[cols].to_numpy(np.float64)
    model = pkg.models.gnn.GNN(art.model_config)
    model.load_state_dict(params_from_flax(art.params))
    ds = MoleculeDataset.from_smiles(smiles[:EMBED_CPU], np.zeros((EMBED_CPU, 1), np.float32),
                                     art.model_config.num_shells, FEAT_THREADS)
    cpu = predict(model.eval(), BatchLoader(ds, EMBED_CPU), "cpu")["predictions"]
    sc = art.pipeline.standard_scaler
    card = (vals - sc.means) / sc.stds
    if vals.shape != cpu.shape or not np.isfinite(vals).all():
        raise AssertionError(f"[{tag}] {vals.shape} predictions, not all finite")
    return float(np.abs(card - cpu).max()) / max(float(np.abs(cpu).max()), 1e-30)


def hyperopt_phase(pkg, work: str, csv: str, cols, smiles) -> dict:
    """``[hyperopt]``: the CLI's search over the committed
    example_hyperparams.yaml, 3 trials of 2 epochs (bf16), on [train]'s CSV;
    every trial must be ok with finite losses; each trial's sampled
    configuration, seconds and kernel launches by name are printed (the
    counts set to 0 as a trial starts, read as it ends); the best artifact
    reloads and serves EMBED_CPU SMILES on the card within E2E_TOL of its
    plain run on the CPU."""
    import yaml

    from aimnet_x2d_tpu_torch import cli, hyperopt, runner

    path = os.path.join(ROOT, "example_hyperparams.yaml")
    with open(path) as f:
        trials = hyperopt.sample_trials(yaml.safe_load(f), HYPEROPT_SEED, 3)
    hidden = {t["hidden_dim"] for t in trials}
    if not ({256, 384} <= hidden and {t["pooling_type"] for t in trials} == {"attention", "mean"}):
        raise AssertionError(f"seed {HYPEROPT_SEED} samples {trials}, not hidden 256 and 384 "
                             f"with both pooling types")
    counters = _training_kernels()
    per_trial = []
    inner = runner.main_runner

    def counted(args):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        try:
            return inner(args)
        finally:
            per_trial.append(({c.__name__: c.launches for c in counters if c.launches},
                              time.perf_counter() - t0))

    art = os.path.join(work, "hyperopt.npz")
    t0 = time.perf_counter()
    runner.main_runner = counted
    try:
        out = cli.main(["--data_path", csv, "--multi_target_columns", ",".join(cols),
                        "--task_type", "multitask", "--hyperparameter_file", path,
                        "--num_trials", "3", "--epochs", "2", "--mixed_precision",
                        "--batch_size", str(HYPEROPT_BATCH), "--seed", str(HYPEROPT_SEED),
                        "--model_save_path", art])
    finally:
        runner.main_runner = inner
    total = time.perf_counter() - t0
    failed = []
    for r, (launched, secs) in zip(out["results"], per_trial):
        c = r["config"]
        widths = f"x_self {c['hidden_dim'] - int(0.3 * c['hidden_dim'])} / x_other " \
                 f"{int(0.3 * c['hidden_dim'])}"
        print(f"[hyperopt] trial {r['trial']} ({widths}) {c}: status {r['status']}, "
              f"{secs:.1f} s, val loss {r.get('val_loss')}, test "
              f"{r.get('test_metrics', {}).get('loss')}; launches {launched}"
              + (f"; error {r['error']}" if r["status"] != "ok" else ""), flush=True)
        if r["status"] != "ok" or not np.isfinite(r["val_loss"]) or not np.isfinite(
                r["test_metrics"]["loss"]):
            failed.append(r["trial"])
    if failed or len(out["results"]) != 3:
        raise AssertionError(f"hyperopt trials failed or lost: {failed}")
    best = out["best"]
    rel = _card_vs_cpu(pkg, art, smiles, "hyperopt-best")
    print(f"[hyperopt] best trial {best['trial']} ({best['config']['hidden_dim']} hidden, "
          f"{best['config']['pooling_type']} pooling) reloaded from {os.path.basename(art)}: "
          f"card vs cpu on {EMBED_CPU} molecules rel {rel:.3e} (tol {E2E_TOL:g}); search "
          f"{total:.1f} s", flush=True)
    if not rel <= E2E_TOL:
        raise AssertionError(f"the best artifact's card predictions differ from the CPU: {rel}")
    return out


def embed_serve_phase(pkg, work: str, smiles, has_h5: bool) -> None:
    """``[embed-serve]``: ``predict(..., return_embeddings=True)`` with
    [serve]'s flagship artifact over [serve]'s SMILES on the card: its
    predictions bit-equal to the call without embeddings, the molecule and
    atom embeddings of the first EMBED_CPU molecules within E2E_TOL of the
    plain run on the CPU and their atoms' molecule index equal; mol/s with
    and without embeddings (featurization apart).  Where h5py imports, the
    CLI's --save_embeddings --include_atom_embeddings file is read back."""
    from aimnet_x2d_tpu_torch.checkpoint import load_artifact, params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import bin_mp, bin_wpool
    from aimnet_x2d_tpu_torch.training.predictor import predict

    art_path = os.path.join(work, "serve.npz")
    art = load_artifact(art_path)
    cfg = art.model_config
    model = pkg.models.gnn.GNN(cfg)
    model.load_state_dict(params_from_flax(art.params))
    model.to("cuda").eval()
    ds = MoleculeDataset.from_smiles(smiles, np.zeros((len(smiles), 1), np.float32),
                                     cfg.num_shells, FEAT_THREADS)
    loader = BatchLoader(ds, 2048)
    loader.warm_bin_pins()
    predict(model, loader, "cuda", return_embeddings=True)  # warm-up
    counters = (bin_mp.mp_stack_fwd, bin_wpool.wpool_fwd)
    runs, secs = {}, {}
    for emb in (True, False):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[emb] = predict(model, loader, "cuda", pipeline=art.pipeline, return_embeddings=emb)
        torch.cuda.synchronize()
        secs[emb] = time.perf_counter() - t0
        if emb:
            launched = {c.__name__: c.launches for c in counters}
    if min(launched.values()) <= 0:
        raise AssertionError(f"[embed-serve] a serving kernel never launched: {launched}")
    got, plain = runs[True], runs[False]
    same = np.array_equal(got["predictions"], plain["predictions"])
    model_cpu = pkg.models.gnn.GNN(cfg)
    model_cpu.load_state_dict(params_from_flax(art.params))
    small = MoleculeDataset(ds.smiles[:EMBED_CPU], ds.targets[:EMBED_CPU],
                            ds.features[:EMBED_CPU], ds.max_hops)
    cpu = predict(model_cpu.eval(), BatchLoader(small, EMBED_CPU), "cpu", return_embeddings=True)
    keep = got["atom_mol_index"] < EMBED_CPU
    errs = {}
    for k, card in (("mol_embeddings", got["mol_embeddings"][:EMBED_CPU]),
                    ("atom_embeddings", got["atom_embeddings"][keep])):
        ref = cpu[k]
        if card.shape != ref.shape or not np.isfinite(card).all():
            raise AssertionError(f"[embed-serve] {k}: {card.shape} against {ref.shape}")
        errs[k] = float(np.abs(card - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
    index_same = np.array_equal(got["atom_mol_index"][keep], cpu["atom_mol_index"])
    n = len(ds)
    print(f"[embed-serve] {n} molecules on the card, launches {launched}: predictions "
          f"{'bit-equal' if same else 'NOT equal'} to serving without embeddings; card vs cpu "
          f"on {EMBED_CPU} molecules: mol_embeddings rel {errs['mol_embeddings']:.3e}, "
          f"atom_embeddings rel {errs['atom_embeddings']:.3e} (tol {E2E_TOL:g}), atom_mol_index "
          f"{'equal' if index_same else 'NOT equal'}; {n / secs[True]:.1f} mol/s with embeddings, "
          f"{n / secs[False]:.1f} without (featurized batches, host clock; [serve] run_csv "
          f"{SERVE_MPS.get('serve', float('nan')):.1f})", flush=True)
    if not same or not index_same or max(errs.values()) > E2E_TOL:
        raise AssertionError("[embed-serve] embeddings or predictions disagree")
    if not has_h5:
        print("[embed-serve] --save_embeddings skipped: h5py does not import here", flush=True)
        return
    import h5py

    from aimnet_x2d_tpu_torch import cli

    emb_path = os.path.join(work, "embed-serve.h5")
    cli.main(["--inference_csv", os.path.join(work, "serve-mols.csv"), "--model_save_path",
              art_path, "--inference_output", os.path.join(work, "embed-serve-preds.csv"),
              "--save_embeddings", "--include_atom_embeddings", "--embeddings_output_path",
              emb_path, "--device", "cuda"])
    with h5py.File(emb_path, "r") as f:
        mol, atoms, offs = f["mol_embeddings"][:], f["atom_embeddings"][:], f["atom_offsets"][:]
    ok = (mol.shape == got["mol_embeddings"].shape and offs[-1] == len(atoms) == len(keep)
          and np.allclose(mol, got["mol_embeddings"], rtol=0, atol=0))
    print(f"[embed-serve] --save_embeddings file: mol_embeddings {mol.shape}, atom_embeddings "
          f"{atoms.shape}, {'equal to' if ok else 'NOT equal to'} predict's", flush=True)
    if not ok:
        raise AssertionError("[embed-serve] the embedding file disagrees with predict")


def hdf5_phases(work: str, csv: str, cols, has_h5: bool) -> None:
    """``[hdf5-train]``: the CLI with --iterable_dataset on [train]'s CSV
    (the three HDF5 files built out of core), 2 epochs of HDF5_BATCH at lr
    5e-4, bf16; the loss must fall, kernel launches printed.  ``[hdf5-serve]``: --inference_hdf5 on its
    test file equals --inference_csv on the test split's SMILES.  Skipped,
    with a line saying so, where h5py does not import."""
    if not has_h5:
        print("[hdf5-train] skipped: h5py does not import here", flush=True)
        print("[hdf5-serve] skipped: h5py does not import here", flush=True)
        return
    import pandas as pd

    from aimnet_x2d_tpu_torch import cli, runner

    files = [os.path.join(work, f"hdf5-{s}.h5") for s in ("train", "val", "test")]
    for p in files:
        if os.path.exists(p):
            os.remove(p)
    art = os.path.join(work, "hdf5-train.npz")
    argv = ["--data_path", csv, "--multi_target_columns", ",".join(cols), "--task_type",
            "multitask", "--epochs", "2", "--mixed_precision", "--batch_size",
            str(HDF5_BATCH), "--learning_rate", "5e-4", "--iterable_dataset",
            "--train_hdf5", files[0], "--val_hdf5", files[1], "--test_hdf5", files[2]]
    counters = _training_kernels()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    summary = cli.main(argv + ["--model_save_path", art])
    launched = {c.__name__: c.launches for c in counters}
    hist = [h["train_loss"] for h in summary["history"]]
    print(f"[hdf5-train] {time.perf_counter() - t0:.1f} s, train loss {hist}, launches "
          f"{launched}", flush=True)
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]) or min(launched.values()) <= 0:
        raise AssertionError("[hdf5-train] the loss did not fall, or a kernel never launched")
    _, _, (te_s, _) = runner._load_splits(cli.parse_arguments(argv))
    te_csv = os.path.join(work, "hdf5-test.csv")
    pd.DataFrame({"smiles": te_s}).to_csv(te_csv, index=False)
    outs = []
    for flag, path in (("--inference_hdf5", files[2]), ("--inference_csv", te_csv)):
        out = os.path.join(work, f"hdf5-serve{flag[11:]}.csv")
        res = cli.main([flag, path, "--model_save_path", art, "--inference_output", out])
        outs.append((pd.read_csv(out), res))
    (a, ra), (b, rb) = outs
    same = a.equals(b)
    print(f"[hdf5-serve] {len(a)} molecules: --inference_hdf5 "
          f"{'equal to' if same else 'NOT equal to'} --inference_csv; "
          f"{ra['molecules_per_second']:.1f} against {rb['molecules_per_second']:.1f} mol/s",
          flush=True)
    if not same:
        raise AssertionError("[hdf5-serve] HDF5 serving differs from CSV serving")


def main() -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on one GPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--molecules", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import aimnet_x2d_tpu_torch as pkg
    import aimnet_x2d_tpu_torch.models.gnn  # noqa: F401
    from aimnet_x2d_tpu_torch.chem import native
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}", flush=True)
    has_h5 = deps_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)

    t0 = time.perf_counter()
    marks_build = start_marks_build()
    native_build = {}

    def build_native():
        t = time.perf_counter()
        try:
            native.build()
        except Exception as e:  # re-raised below
            native_build["error"] = e
        native_build["s"] = time.perf_counter() - t

    native_thread = threading.Thread(target=build_native)
    native_thread.start()  # g++ beside the nvcc processes
    cuda_build.build_all(verbose=True)
    native_thread.join()
    if "error" in native_build:
        raise native_build["error"]
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = flagship_config(pkg)
    smiles = make_smiles(args.molecules, args.seed)
    native_phase(smiles, args.seed, native_build["s"])
    t0 = time.perf_counter()
    ds = MoleculeDataset.from_smiles(smiles[:2048], np.zeros((2048, 1), np.float32), cfg.num_shells,
                                     FEAT_THREADS)
    t1 = time.perf_counter()
    loader = BatchLoader(ds, 2048)
    loader.warm_bin_pins()
    host_batch = next(iter(loader))
    t2 = time.perf_counter()
    host_batch.to("cuda")  # first copy of the process: CUDA set-up
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    batch = host_batch.to("cuda")
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    print(f"[data] 2048 molecules (mean {ds.sizes()['atoms'].mean():.1f} atoms "
          f"with H): featurize {t1 - t0:.3f} s ({native.describe(FEAT_THREADS)}), "
          f"collate + bin-pack {t2 - t1:.3f} s ({'native' if native.native_enabled() else 'Python'}), "
          f"copy to the card {t4 - t3:.4f} s (first copy {t3 - t2:.3f} s; host clock)", flush=True)

    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax

    tcfg = train_config(cfg)
    tloader = BatchLoader(ds, 2048, shuffle=True, seed=args.seed)
    tbatch = next(iter(tloader)).to("cuda")
    tmodel = pkg.models.gnn.GNN(tcfg)
    tmodel.load_state_dict(params_from_flax(init_params(tcfg, args.seed)))
    tmodel.to("cuda")
    res = check_kernels(pkg, cfg, batch, args.seed)
    launches = serve(pkg, cfg, smiles, args.seed, work, batch)
    rank_serve_phase(work, len(smiles))
    t0 = time.perf_counter()
    embed_serve_phase(pkg, work, smiles, has_h5)
    print(f"[time] [embed-serve] {time.perf_counter() - t0:.1f} s", flush=True)
    mc_serve(pkg, tcfg, smiles[:2048], args.seed, work, batch)
    evid_serve(pkg, cfg, smiles[:2048], args.seed, work)
    print(f"[time] serving phases done at {time.perf_counter() - t_start:.1f} s", flush=True)
    for name, r in check_train_kernels(pkg, tcfg, tmodel, tbatch, args.seed, marks_build).items():
        res[(name, torch.bfloat16)] = r
    res.update(check_fold_kernels(pkg, tcfg, tmodel, tbatch, args.seed, marks_build))
    full = MoleculeDataset.from_smiles(smiles, np.zeros((len(smiles), 1), np.float32),
                                       cfg.num_shells, FEAT_THREADS)
    launches.update(train_phase(pkg, tcfg, smiles, full, args.seed, work))
    print(f"[time] flagship phases done at {time.perf_counter() - t_start:.1f} s", flush=True)
    train_csv = os.path.join(work, "train.csv")
    train_cols = [f"target_{i}" for i in range(tcfg.output_dim)]
    t0 = time.perf_counter()
    hyperopt_phase(pkg, work, train_csv, train_cols, smiles)
    t1 = time.perf_counter()
    hdf5_phases(work, train_csv, train_cols, has_h5)
    print(f"[time] [hyperopt] {t1 - t0:.1f} s, [hdf5-train] and [hdf5-serve] "
          f"{time.perf_counter() - t1:.1f} s; done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # --- the embedding fold (AIMNET_EMBED_FOLD=1): the flagship's CLI and
    # train step with the switch set in the environment they run in
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp

    folded = (bin_mp.mp_stack_fwd_train_vocab, bin_mp.mp_stack_bwd, bin_mp.mp_stack_bwd_vocab,
              bin_attnpool.attnpool_fwd_vocab, bin_attnpool.attnpool_bwd_vocab)
    os.environ["AIMNET_EMBED_FOLD"] = "1"
    try:
        fold_launches = train_phase(
            pkg, tcfg, smiles, full, args.seed, work, tag="fold-train", counters=folded,
            forbidden=(bin_mp.mp_stack_fwd_train, bin_attnpool.attnpool_fwd,
                       bin_attnpool.attnpool_bwd, bin_mp.mp_stack_bwd_proj),
            steps=FOLD_TRAIN_STEPS, want_per_step={c.__name__: 1 for c in folded})
    finally:
        os.environ.pop("AIMNET_EMBED_FOLD", None)
    for c in folded[2:] + folded[:1]:
        launches[c.__name__] = fold_launches[c.__name__]
    fold_compare(pkg, tcfg, tbatch, args.seed)
    print(f"[time] embedding-fold phases done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # --- config 3 (partial charges + stereochemistry) at the flagship width,
    # on SMILES with stereo content
    from aimnet_x2d_tpu_torch.ops import bin_inject, bin_wpool

    c3 = config3(cfg)
    c3_smiles = make_smiles(args.molecules, args.seed + 1, stereo=True)
    c3_full = MoleculeDataset.from_smiles(c3_smiles, np.zeros((len(c3_smiles), 1), np.float32),
                                          cfg.num_shells, FEAT_THREADS)
    c3_ds = MoleculeDataset(c3_full.smiles[:2048], c3_full.targets[:2048],
                            c3_full.features[:2048], c3_full.max_hops)
    c3_tcfg = train_config(c3)
    c3_model = pkg.models.gnn.GNN(c3_tcfg)
    c3_model.load_state_dict(params_from_flax(init_params(c3_tcfg, args.seed)))
    c3_model.to("cuda")
    c3_tbatch = next(iter(BatchLoader(c3_ds, 2048, shuffle=True, seed=args.seed))).to("cuda")
    for name, r in check_c3_kernels(pkg, c3_tcfg, c3_model, c3_tbatch, args.seed,
                                    marks_build).items():
        res[(name, torch.bfloat16)] = r
    del c3_model, c3_tbatch
    c3_loader = BatchLoader(c3_ds, 2048)
    c3_loader.warm_bin_pins()
    c3_batch = next(iter(c3_loader)).to("cuda")
    bin_mp.mp_stack_fwd.launches = 0
    c3_launches = serve(pkg, c3, c3_full.smiles[:2048], args.seed, work, c3_batch, tag="c3-serve",
                        counters=(bin_inject.inject_fwd, bin_mp.mp_layer_fwd, bin_wpool.wpool_fwd))
    if bin_mp.mp_stack_fwd.launches != 0:
        raise AssertionError("config 3 served through the multi-layer stack kernel")
    del c3_batch
    c3_routes(pkg, c3, c3_full.smiles, args.seed)
    c3_launches.update(train_phase(
        pkg, c3_tcfg, c3_full.smiles, c3_full, args.seed, work, tag="c3-train",
        counters=(bin_inject.inject_fwd, bin_inject.inject_bwd, bin_mp.mp_layer_fwd_train,
                  bin_mp.mp_layer_bwd, bin_attnpool.attnpool_fwd, bin_attnpool.attnpool_bwd),
        steps=C3_TRAIN_STEPS))
    for name in ("inject_bwd", "mp_layer_fwd_train", "mp_layer_bwd"):
        launches[name] = c3_launches[name]
    for name in ("inject_fwd", "mp_layer_fwd"):  # serving's counts
        launches[name] = c3_launches[name]
    print(f"[time] config-3 phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # --- config 1 (1 shell, mean pooling, 1 target) on the same SMILES,
    # featurized for 1 shell
    c1 = config1(cfg)
    c1_full = MoleculeDataset.from_smiles(smiles, np.zeros((len(smiles), 1), np.float32),
                                          c1.num_shells, FEAT_THREADS)
    c1_ds = MoleculeDataset(c1_full.smiles[:2048], c1_full.targets[:2048],
                            c1_full.features[:2048], c1_full.max_hops)
    c1_tcfg = train_config(c1)
    c1_tbatch = next(iter(BatchLoader(c1_ds, 2048, shuffle=True, seed=args.seed))).to("cuda")
    res.update(check_c1_kernel(c1_tcfg, c1_tbatch, args.seed))
    del c1_tbatch
    c1_loader = BatchLoader(c1_ds, 2048)
    c1_loader.warm_bin_pins()
    c1_batch = next(iter(c1_loader)).to("cuda")
    c1_launches = serve(pkg, c1, smiles, args.seed, work, c1_batch, tag="c1-serve")
    del c1_batch
    c1_launches.update(train_phase(
        pkg, c1_tcfg, smiles, c1_full, args.seed, work, tag="c1-train",
        counters=(bin_mp.mp_stack_fwd_train, bin_mp.mp_stack_bwd, bin_wpool.wpool_fwd,
                  bin_wpool.wpool_bwd),
        steps=C1_TRAIN_STEPS, forbidden=(bin_attnpool.attnpool_fwd, bin_attnpool.attnpool_bwd)))
    launches["wpool_bwd"] = c1_launches["wpool_bwd"]
    print(f"[time] config-1 serving and training done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    finetune_phase(c1_full, args.seed, work, os.path.join(work, "c1-train-trained.npz"))
    pool_routes(pkg, c1_tcfg, c1_full, args.seed)
    fold_routes(pkg, {"config3": c3_tcfg, "config1": c1_tcfg},
                {"config3": c3_full, "config1": c1_full}, args.seed)
    print(f"[time] config-1 phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # --- the flat layout: the flagship on SMILES of which 1 in 100 is larger
    # than a bin, so every batch goes flat
    from aimnet_x2d_tpu_torch.ops import fused_edge, pallas_segment

    fl_smiles = flat_smiles(args.molecules, args.seed)
    t0 = time.perf_counter()
    fl_full = MoleculeDataset.from_smiles(fl_smiles, np.zeros((len(fl_smiles), 1), np.float32),
                                          cfg.num_shells, FEAT_THREADS)
    sizes = fl_full.sizes()["atoms"]
    big = sizes > 256
    print(f"[flat-data] {len(fl_full)} molecules, {int(big.sum())} of them larger than a bin "
          f"({int(sizes[big].min())}-{int(sizes[big].max())} atoms with H), {int(big[:128].sum())} "
          f"in the first 128; featurize {time.perf_counter() - t0:.3f} s (host clock)", flush=True)
    if len(fl_full) != len(fl_smiles) or int(big[:128].sum()) < 2:
        raise AssertionError("the flat data lost molecules or holds too few large ones")
    fl_ds = MoleculeDataset(fl_full.smiles[:2048], fl_full.targets[:2048],
                            fl_full.features[:2048], fl_full.max_hops)
    fl_loader = BatchLoader(fl_ds, 2048)
    if fl_loader.binned:
        raise AssertionError("a loader over molecules larger than a bin stayed binned")
    fl_host = next(iter(fl_loader))
    fl_batch = fl_host.to("cuda")
    fl_res, wseg_launches = check_flat_kernels(cfg, fl_host, fl_batch, args.seed, marks_build)
    res.update(fl_res)
    binned_serving = (bin_mp.mp_stack_fwd, bin_mp.mp_layer_fwd, bin_wpool.wpool_fwd,
                      bin_attnpool.attnpool_fwd, bin_inject.inject_fwd)
    # the serving phases of the flat layout run the first batch of SMILES:
    # their featurization (the large molecules') is most of the script's time
    edge_routes = [fused_edge.fused_edge_fwd.routes, fused_edge.fused_edge_bwd.routes]
    for r in edge_routes:
        r.update({k: 0 for k in r})
    fl_launches = serve(pkg, cfg, fl_smiles[:FLAT_SERVE], args.seed, work, fl_batch,
                        tag="flat-serve",
                        counters=(fused_edge.fused_edge_fwd,), forbidden=binned_serving, n_cpu=128)
    n_batches = -(-min(len(fl_smiles), FLAT_SERVE) // 2048)
    if fl_launches["fused_edge_fwd"] != 3 * n_batches:
        raise AssertionError(f"kernel 7 launched {fl_launches['fused_edge_fwd']} times for "
                             f"{n_batches} batches of a 3-layer model")
    print(f"[flat-serve] kernel 7's launches by route: forward {edge_routes[0]}", flush=True)
    for r in edge_routes:
        r.update({k: 0 for k in r})
    del fl_batch
    binned_training = (bin_mp.mp_stack_fwd_train, bin_mp.mp_stack_bwd, bin_mp.mp_layer_fwd_train,
                       bin_mp.mp_layer_bwd, bin_wpool.wpool_fwd, bin_wpool.wpool_bwd,
                       bin_attnpool.attnpool_fwd, bin_attnpool.attnpool_bwd,
                       bin_inject.inject_fwd, bin_inject.inject_bwd)
    fl_train = train_phase(pkg, tcfg, fl_smiles, fl_full, args.seed, work, tag="flat-train",
                           counters=(fused_edge.fused_edge_fwd, fused_edge.fused_edge_bwd),
                           forbidden=binned_training,
                           want_per_step={"fused_edge_fwd": 3, "fused_edge_bwd": 3})
    print(f"[flat-train] kernel 7's launches by route: forward {edge_routes[0]}, backward "
          f"{edge_routes[1]}", flush=True)
    launches["fused_edge_fwd"] = fl_launches["fused_edge_fwd"]  # serving's count
    launches["fused_edge_bwd"] = fl_train["fused_edge_bwd"]
    launches["wseg_sum"] = wseg_launches
    synthetic_phase(pkg, cfg, args.seed)
    print(f"[time] flat-layout phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # --- true per-hop aggregation: the flagship on the row-major binned
    # route, its attention pool kernel 6
    import dataclasses

    from aimnet_x2d_tpu_torch.ops import bin_pool

    mh = dataclasses.replace(cfg, parity_mode=False)
    for key, r in check_pool6_kernel(mh, tmodel, tbatch, args.seed, marks_build).items():
        res[key] = r
    del tmodel, tbatch
    edge_kernels = (fused_edge.fused_edge_fwd, fused_edge.fused_edge_bwd)
    mh_launches = serve(pkg, mh, smiles, args.seed, work, batch, tag="mh-serve",
                        counters=(bin_pool.bin_pool_fwd,),
                        forbidden=binned_serving + edge_kernels)
    mh_launches.update(train_phase(
        pkg, train_config(mh), smiles, full, args.seed, work, tag="mh-train",
        counters=(bin_pool.bin_pool_fwd, bin_pool.bin_pool_bwd),
        forbidden=binned_training + edge_kernels, steps=MH_TRAIN_STEPS,
        want_per_step={"bin_pool_fwd": 1, "bin_pool_bwd": 1}))
    # the training CLI's counts ([mh-serve] prints serving's)
    launches["bin_pool_fwd"] = mh_launches["bin_pool_fwd"]
    launches["bin_pool_bwd"] = mh_launches["bin_pool_bwd"]
    print(f"[time] per-hop phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # --- config 3 on the flat layout, on SMILES with stereo content and 1
    # in 100 larger than a bin
    c3f_smiles = flat_smiles(args.molecules, args.seed + 1, stereo=True)
    t0 = time.perf_counter()
    c3f_full = MoleculeDataset.from_smiles(c3f_smiles, np.zeros((len(c3f_smiles), 1), np.float32),
                                           cfg.num_shells, FEAT_THREADS)
    c3f_host = next(iter(BatchLoader(c3f_full, 2048)))
    n_big = int((c3f_full.sizes()["atoms"] > 256).sum())
    print(f"[c3-flat] {len(c3f_full)} molecules, {n_big} larger than a bin; the first batch: "
          f"{int(c3f_host.tet_mask.sum())} tetrahedral centres, "
          f"{int(c3f_host.cis_mask.sum() + c3f_host.trans_mask.sum())} cis/trans rows; featurize "
          f"{time.perf_counter() - t0:.3f} s (host clock)", flush=True)
    if (len(c3f_full) != len(c3f_smiles) or c3f_host.pool_mat is not None or n_big < 2
            or not c3f_host.tet_mask.any() or not (c3f_host.cis_mask.any()
                                                   and c3f_host.trans_mask.any())):
        raise AssertionError("the config-3 flat data lost molecules, went binned or has no "
                             "stereo content")
    c3f = serve(pkg, c3, c3f_smiles[:FLAT_SERVE], args.seed, work, c3f_host.to("cuda"),
                tag="c3-flat-serve",
                counters=(fused_edge.fused_edge_fwd,),
                forbidden=binned_serving + (bin_pool.bin_pool_fwd,), n_cpu=128)
    if c3f["fused_edge_fwd"] != 3 * -(-min(len(c3f_smiles), FLAT_SERVE) // 2048):
        raise AssertionError(f"kernel 7 launched {c3f['fused_edge_fwd']} times in config-3 flat "
                             f"serving")
    del c3f_host
    train_phase(pkg, train_config(c3), c3f_smiles, c3f_full, args.seed, work,
                tag="c3-flat-train", counters=edge_kernels,
                forbidden=binned_training + (bin_pool.bin_pool_fwd, bin_pool.bin_pool_bwd),
                steps=C3_TRAIN_STEPS, want_per_step={"fused_edge_fwd": 3, "fused_edge_bwd": 3})
    print(f"[time] config-3 flat phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    halo_phases(pkg, tcfg, ds, full, fl_full, args.seed, work, res, launches, marks_build,
                c3_tcfg, c3_full)
    print(f"[time] halo phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for name, src, tpu in (
        ("mp_stack_fwd", "aimnet_x2d_tpu_torch/csrc/mp_stack.cu", "aimnet_x2d_tpu/ops/bin_mp.py:639"),
        ("wpool_fwd", "aimnet_x2d_tpu_torch/csrc/wpool.cu", "aimnet_x2d_tpu/ops/bin_wpool.py:83"),
        ("mp_stack_fwd_train", "aimnet_x2d_tpu_torch/csrc/mp_stack.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:639"),
        ("mp_stack_bwd", "aimnet_x2d_tpu_torch/csrc/mp_stack_bwd.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:659"),
        ("mp_stack_bwd_proj", "aimnet_x2d_tpu_torch/csrc/mp_stack_bwd.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:726"),
        ("attnpool_fwd", "aimnet_x2d_tpu_torch/csrc/attnpool.cu",
         "aimnet_x2d_tpu/ops/bin_attnpool.py:202"),
        ("attnpool_bwd", "aimnet_x2d_tpu_torch/csrc/attnpool.cu",
         "aimnet_x2d_tpu/ops/bin_attnpool.py:228"),
        ("inject_fwd", "aimnet_x2d_tpu_torch/csrc/inject.cu",
         "aimnet_x2d_tpu/ops/bin_inject.py:336"),
        ("inject_bwd", "aimnet_x2d_tpu_torch/csrc/inject.cu",
         "aimnet_x2d_tpu/ops/bin_inject.py:355"),
        ("mp_layer_fwd", "aimnet_x2d_tpu_torch/csrc/mp_stack.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:1278"),
        ("mp_layer_fwd_train", "aimnet_x2d_tpu_torch/csrc/mp_stack.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:1278"),
        ("mp_layer_bwd", "aimnet_x2d_tpu_torch/csrc/mp_stack_bwd.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:659"),
        ("wpool_bwd", "aimnet_x2d_tpu_torch/csrc/wpool.cu", "aimnet_x2d_tpu/ops/bin_wpool.py:98"),
        ("fused_edge_fwd", "aimnet_x2d_tpu_torch/csrc/fused_edge.cu",
         "aimnet_x2d_tpu/ops/fused_edge.py:155"),
        ("fused_edge_bwd", "aimnet_x2d_tpu_torch/csrc/fused_edge.cu",
         "aimnet_x2d_tpu/ops/fused_edge.py:273"),
        ("wseg_sum", "aimnet_x2d_tpu_torch/csrc/fused_edge.cu",
         "aimnet_x2d_tpu/ops/pallas_segment.py:79"),
        ("bin_pool_fwd", "aimnet_x2d_tpu_torch/csrc/bin_pool.cu",
         "aimnet_x2d_tpu/ops/bin_pool.py:181"),
        ("bin_pool_bwd", "aimnet_x2d_tpu_torch/csrc/bin_pool.cu",
         "aimnet_x2d_tpu/ops/bin_pool.py:205"),
        ("mp_stack_fwd_train_vocab", "aimnet_x2d_tpu_torch/csrc/mp_stack.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:814"),
        ("mp_stack_bwd_vocab", "aimnet_x2d_tpu_torch/csrc/mp_stack_bwd.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:869"),
        ("attnpool_fwd_vocab", "aimnet_x2d_tpu_torch/csrc/attnpool.cu",
         "aimnet_x2d_tpu/ops/bin_attnpool.py:368"),
        ("attnpool_bwd_vocab", "aimnet_x2d_tpu_torch/csrc/attnpool.cu",
         "aimnet_x2d_tpu/ops/bin_attnpool.py:408"),
        ("mp_ext_fwd", "aimnet_x2d_tpu_torch/csrc/mp_ext.cu", "aimnet_x2d_tpu/ops/bin_mp.py:1167"),
        ("mp_ext_bwd", "aimnet_x2d_tpu_torch/csrc/mp_ext.cu", "aimnet_x2d_tpu/ops/bin_mp.py:1196"),
    ):
        # the flagship's dtype; kernel 8 at its op's default, exact fp32
        r = res[(name, torch.float32 if name == "wseg_sum" else torch.bfloat16)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timing": r.get("timing", "events"),
        })
    steps = {k: round(v, 3) for k, v in STEP_DEVICE_MS.items()
             if k in ("train", "c3-train", "c1-train", "fold-train on", "fold-train off")}
    print(f"[bwd-record] {card}: the backward forms of kernels 1b, 1d, 3, 1c-vocab's pool, 4 "
          f"and 5, kernel 4's forward and the stack's forwards (kernels 1, 1d, 1c-vocab's "
          f"stack site; device ms, split, host us a call) "
          f"{json.dumps(BWD_RECORD)}; train steps' device ms "
          f"{json.dumps(steps)}", flush=True)
    print(f"[time] total {time.perf_counter() - t_start:.1f} s (host clock)", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
