#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aimnet_x2d_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--molecules N]

Phases, each of which fails the run when it fails:

1. print the card's name and power limit; turn TF32 off for fp32 products;
2. build the CUDA kernels from ``aimnet_x2d_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source, all at once);
3. ``[kernel]``: hold each serving kernel against its plain PyTorch version
   at the flagship serving shapes (a batch of 2048 molecules of the
   script's SMILES), in fp32 and bf16, and time kernel, plain version and
   library yardstick;
4. ``[serve]``: write a flagship artifact (hidden 512, bf16, random weights
   from the seed, fitted scaler), run a CSV of the script's SMILES through
   the port's CLI on ``cuda`` with the launch counters reset just before,
   check every row is present and finite and both kernels ran, and compare
   one batch with the same model run on the CPU (plain versions);
5. ``[train-kernel]``: hold each training kernel (stack forward with
   dropout and the projection fold, stack backward, attention pool forward
   and backward) against its plain version at the flagship training shapes
   (a size-sorted batch of 2048), bf16, and time kernel and plain version;
6. ``[train]``: train the flagship model (bf16, dropout 0.05, 12 synthetic
   targets from the seed) through the port's CLI at batch 2048 with the
   launch counters reset just before; then 24 steps of the train step on
   card-resident batches, timed, with a falling loss, launches per step and
   a profiler breakdown of one step; then one step on a small batch on the
   card and on the CPU (plain versions) from the same weights, both
   backpropagating the CPU's cotangent of the loss, all gradients compared;
7. config 3 (partial charges + stereochemistry, BASELINE.json config 3) at
   the flagship width, on SMILES of which about half carry a tetrahedral
   centre or a cis/trans double bond:
   - ``[c3-kernel]``: the inject kernels (kernel 4, forward and backward)
     and kernel 1d (serving form, training form, backward) against their
     plain versions at the config-3 training shape, bf16, timed, with
     bounds; the batch must hold tetrahedral centres and cis/trans pairs;
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
     batch's mb and two mb that are not multiples of 16, w = 1 and a random
     w on the real atoms; timed at the training batch with its bound and
     the einsum yardstick;
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
     the flat serving batch, D 153 and 359, fp32 and bf16, timed with
     bounds and the library yardsticks (``torch.sparse.mm`` of the batch's
     multiplicity adjacency; ``index_add_``); then kernel 8's op driven
     once as its caller would, on the batch's edges (it lies on no model
     path, in either package);
   - ``[flat-serve]``: phase 4 on those SMILES: kernel 7 launches 3 times
     per batch and no binned kernel launches; card against CPU on 128
     molecules that hold 2 large ones;
   - ``[flat-train]``: phase 6 on them: kernel 7 launches 3 times forward
     and 3 times backward per step, no binned kernel launches; the one step
     card against CPU runs with both dropouts off (the flat layers draw
     their masks from a generator);
10. true per-hop aggregation (``--true_multi_hop``, the row-major route on
   binned batches):
   - ``[pool6-kernel]``: kernel 6 (``bin_pool_fwd``, ``bin_pool_bwd``: the
     binned attention pool of row-major arrays) against its plain version
     at the flagship training shape on the loader's pool matrix, fp32 and
     bf16, timed with the byte bound;
   - ``[mh-serve]``: phase 4 for the flagship with per-hop aggregation:
     kernel 6 launches, no stack, layer, inject, attention-pool,
     weighted-pool or edge kernel;
   - ``[mh-train]``: phase 6 for it, ``--true_multi_hop`` on the CLI;
     kernel 6 forward and backward once a step, none of those others;
11. ``[c3-flat]``: config 3 on the flat layout, on the script's SMILES with
   stereo content, 1 in 100 replaced by a molecule larger than a bin (so
   every split of the CLI's training holds one and goes flat): phase 4
   (``[c3-flat-serve]``) and phase 6 with ``--output_partial_charges``
   (``[c3-flat-train]``); kernel 7 launches 3 times forward (and 3
   backward per step), no binned kernel;
12. the embedding fold (``AIMNET_EMBED_FOLD=1``, kernel 1c-vocab), run
   right after the phases it rides on:
   - ``[fold-kernel]`` (after phase 5): the four folded kernels
     (``mp_stack_fwd_train_vocab``, ``mp_stack_bwd_vocab``,
     ``attnpool_fwd_vocab``, ``attnpool_bwd_vocab``) against their plain
     versions at the flagship training shapes on the batch's own codes,
     fp32 and bf16, timed with bounds; each backward twice, bit-equal;
   - ``[fold-train]`` (after phase 6): phase 6 with the switch set in the
     CLI's environment: the folded kernels launch once a step and the
     stack's and pool's emb forms never; then, on one batch, the training
     forward with the switch on against off (bit-equal) and the step in
     blocks off, on, on, off: host-clock medians, launches and device time;
   - ``[fold-routes]`` (after phase 8): one config-3 and one config-1 train
     step under the switch, card against CPU; the pool folds only for
     config 3, the stack only for config 1;
13. print the ``kernels`` JSON line, the card line and, last, the result
   line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Without CUDA it exits non-zero and prints no
result.  Work files go to ``build/smoke/`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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
TRAIN_STEPS = 24
C3_TRAIN_STEPS = 12
C1_TRAIN_STEPS = 24
FLAT_EVERY = 100  # one molecule larger than a bin in every FLAT_EVERY SMILES
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
    from aimnet_x2d_tpu_torch.ops import bin_mp, bin_wpool

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
        ref = bin_mp.mp_stack_plain(x, adj, sw, cfg.activation_type)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, ref)
        tol = TOL[("mp_stack_fwd", dt)]
        ms = time_ms(lambda: bin_mp.mp_stack_fwd(x, adj, sw, cfg.activation_type))
        plain_ms = time_ms(lambda: bin_mp.mp_stack_plain(x, adj, sw, cfg.activation_type), iters=5)
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
            bound_by=bound_by, library_ms=None,
        )

    # --- kernel 2: the weighted pool (x_self 359 and x_other 153 rows;
    # the batch's own mb plus two mb that are not multiples of 16)
    def rand_pm(mb_):
        owner = torch.randint(-1, mb_, (nb, ab), generator=gen, device=dev)
        m = torch.arange(mb_, device=dev)[None, :, None]
        return (owner[:, None, :] == m).to(torch.int8).contiguous()

    pms = [pm, rand_pm(20), rand_pm(44)]
    w = torch.rand(A, generator=gen, device=dev) * batch.atom_mask.float()
    for dt in (torch.float32, torch.bfloat16):
        tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        for pm_ in pms:
            for d in (cfg.x_self_dim, D):
                x = torch.randn(d, A, generator=gen, device=dev).to(dt)
                got = bin_wpool.wpool_fwd(x, w, pm_)
                ref = bin_wpool.wpool_plain(x, w, pm_)
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, ref)
                tol = TOL[("wpool_fwd", dt)]
                mb_ = pm_.shape[1]
                print(f"[kernel] wpool_fwd {str(dt)[6:]} D={d} mb={mb_}: max_abs_err={abs_err:.3e} "
                      f"rel={rel:.3e} (tol {tol:g})", flush=True)
                if not rel <= tol:
                    raise AssertionError(f"wpool_fwd {dt} D={d} mb={mb_}: rel err {rel:.3e} > {tol:g}")
                if pm_ is not pm:
                    continue
                # main-path shapes: time both launches of a batch
                xw = (x * w.to(dt)[None, :]).reshape(d, nb, ab)
                pm_dt = pm_.to(dt)
                isz = x.element_size()
                nbytes = d * A * isz + 4 * A + nb * mb_ * ab + 4 * d * nb * mb_
                ops = 2 * d * int((pm_ != 0).sum())
                tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
                tot["ms"] += time_ms(lambda: bin_wpool.wpool_fwd(x, w, pm_))
                tot["plain_ms"] += time_ms(lambda: bin_wpool.wpool_plain(x, w, pm_))
                tot["library_ms"] += time_ms(lambda: torch.einsum("dba,bma->dbm", xw, pm_dt))
                tot["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[torch.float32])
        tot["bound_by"] = "bytes"
        print(f"[kernel] wpool_fwd {str(dt)[6:]} per batch (D={cfg.x_self_dim} + D={D}, "
              f"mb={pm.shape[1]}): ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
              f"library_ms={tot['library_ms']:.4f} bound_ms={tot['bound_ms']:.4f} (bytes)",
              flush=True)
        res[("wpool_fwd", dt)] = tot
    return res


def profile_forward(model, batch, top: int = 8) -> None:
    """Device time of one forward, by kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    model(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        model(batch)
        torch.cuda.synchronize()
    # device-side entries only (the kernels), so no time is counted twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        print("[profile] device time not measured (no CUDA events in the trace)", flush=True)
        return
    print(f"[profile] one forward, device time {total / 1e3:.3f} ms summed over kernels:", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}%  x{e.count:<3d} {e.key[:90]}",
              flush=True)


def serve(pkg, cfg, smiles, seed: int, work: str, dev_batch, tag: str = "serve",
          counters=None, forbidden=(), n_cpu: int = 256) -> dict:
    """Phase 4 (and ``[c3-serve]``, ``[c1-serve]``, ``[flat-serve]``): the
    port's CLI on cuda, counters of the path's kernels (default: the
    flagship's), which must all launch, and of ``forbidden`` kernels, which
    must not; output checks, CPU comparison of the first ``n_cpu``
    molecules, model-only throughput."""
    from aimnet_x2d_tpu_torch import cli
    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax, save_artifact
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.data.preprocessing import (
        PreprocessingConfig, PreprocessingPipeline, StandardScaler,
    )
    from aimnet_x2d_tpu_torch.ops import bin_mp, bin_wpool
    from aimnet_x2d_tpu_torch.training.predictor import predict

    import pandas as pd

    counters = counters or (bin_mp.mp_stack_fwd, bin_wpool.wpool_fwd)
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
    ds = MoleculeDataset.from_smiles(smiles[:n_cpu], np.zeros((n_cpu, 1), np.float32), cfg.num_shells)
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
    print(f"[{tag}] run_csv: {summary['valid_molecules']} molecules in {summary['seconds']:.3f} s "
          f"= {summary['molecules_per_second']:.1f} mol/s end to end, of which featurization "
          f"{summary['featurize_seconds']:.3f} s (host, pure-Python featurizer)", flush=True)
    print(f"[{tag}] model forward, batch of {n_mol} molecules (already on the card): "
          f"{step_ms:.3f} ms = {mps:.1f} mol/s", flush=True)
    return launches


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


def check_train_kernels(pkg, cfg, model, batch, seed: int) -> dict:
    """Phase 5: each training kernel against its plain version at the
    flagship training shapes (bf16), with times and bounds."""
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
    ref, ref_saved = bin_mp.mp_stack_train_plain(emb, adj, sw, spec, pw)
    torch.cuda.synchronize()
    ops = 2 * n * E * D + L * (2 * nnz * D + n * 2 * w_layer)
    nbytes = (E * A + D * A + L * D * A) * isz + nb * ab * ab + (w_mat + E * D) * isz
    record("mp_stack_fwd_train", [(out, ref, None)] + [(a, r, None) for a, r in zip(saved, ref_saved)],
           time_ms(lambda: bin_mp.mp_stack_fwd_train(emb, adj, sw, spec, pw)),
           time_ms(lambda: bin_mp.mp_stack_train_plain(emb, adj, sw, spec, pw), iters=5),
           ops, nbytes)

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
    record("mp_stack_bwd", pairs,
           time_ms(lambda: bin_mp.mp_stack_bwd(emb, adj, sw, spec, saved, g, pw), iters=10),
           time_ms(lambda: bin_mp.mp_stack_bwd_plain(emb, adj, sw, spec, ref_saved, g, pw), iters=3),
           ops, nbytes)

    # --- kernel 3: attention pool, forward and backward
    xo = out
    bin_attnpool.check_one_owner(pm)  # the kernels' precondition, on the loader's matrix
    fwd = bin_attnpool.attnpool_fwd(emb, xo, pm, aw, act)
    fref = bin_attnpool.attnpool_fwd_plain(emb, xo, pm, aw, act)
    torch.cuda.synchronize()
    npm = int((pm != 0).sum())
    ops = 2 * n * E * Ds + 2 * n * H * (Ds + D) + 2 * npm * (Ds + D + 1)
    nbytes = (E + D) * A * isz + nb * mb * ab + 4 * ((Ds + D + 1) * B + H * A)
    record("attnpool_fwd", list(zip(fwd, fref, [None] * 4)),
           time_ms(lambda: bin_attnpool.attnpool_fwd(emb, xo, pm, aw, act)),
           time_ms(lambda: bin_attnpool.attnpool_fwd_plain(emb, xo, pm, aw, act), iters=5),
           ops, nbytes)
    gps = torch.randn(Ds, B, generator=gen, device=dev) * 1e-3
    gpo = torch.randn(D, B, generator=gen, device=dev) * 1e-3
    gcov = torch.randn(B, generator=gen, device=dev) * 1e-3
    args = (emb, xo, pm, aw, act, fref[3], gps, gpo, gcov)
    bg = bin_attnpool.attnpool_bwd(*args)
    br = bin_attnpool.attnpool_bwd_plain(*args)
    torch.cuda.synchronize()
    dks_scale = float(br[2][2].abs().max())  # d_sb's exact value is 0: held to d_ks's scale
    pairs = [(bg[0], br[0], None), (bg[1], br[1], None)]
    pairs += [(a, r, dks_scale if i == 4 else None) for i, (a, r) in enumerate(zip(bg[2], br[2]))]
    ops = 3 * 2 * n * E * Ds + 4 * 2 * n * H * (Ds + D) + 2 * npm * (Ds + D)
    nbytes = (2 * E + 2 * D) * A * isz + nb * mb * ab + 4 * (H * A + (Ds + D + 1) * B) + 4 * (E * Ds)
    record("attnpool_bwd", pairs,
           time_ms(lambda: bin_attnpool.attnpool_bwd(*args), iters=10),
           time_ms(lambda: bin_attnpool.attnpool_bwd_plain(*args), iters=5), ops, nbytes)
    return res


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
    """The embedding fold's operands of a batch: the code rows (F, A) int32
    and the tables' block-diagonal table in the kernels' form."""
    from aimnet_x2d_tpu_torch.ops import embed

    names = ("atom_type", "hydrogen_count", "degree", "hybridization")
    tables = [getattr(model, f"{k}_embedding").weight.detach() for k in names]
    codes = embed.code_rows([getattr(batch, k) for k in names])
    vt = embed.prep_vocab(embed.blockdiag_table_t(tables), tuple(t.shape[0] for t in tables), dt)
    return codes, vt


def check_fold_kernels(pkg, cfg, model, batch, seed: int) -> dict:
    """[fold-kernel]: kernel 1c-vocab at both sites (stack forward, the
    projection's backward, attention pool forward and backward) against
    their plain versions at the flagship training shapes, fp32 and bf16,
    timed, with bounds; each backward twice, bit-equal."""
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp

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
        codes, vt = fold_inputs(model, batch, dt)
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
        torch.cuda.synchronize()
        ops = 2 * n * E * D + L * (2 * nnz * D + n * 2 * w_layer)
        nbytes = lookup + (D * A + L * D * A) * isz + nb * ab * ab + (L * w_layer + E * D) * isz
        record("mp_stack_fwd_train_vocab",
               [(out, ref, None)] + [(a, r, None) for a, r in zip(saved, ref_saved)],
               time_ms(lambda: bin_mp.mp_stack_fwd_train_vocab(codes, adj, sw, spec, pw, vt)),
               time_ms(lambda: bin_mp.mp_stack_train_plain(codes, adj, sw, spec, pw, vt), iters=5),
               ops, nbytes, 1e-4 if f32 else TRAIN_TOL)
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
        record("mp_stack_bwd_vocab", [(a, r, None) for a, r in zip(got, want)],
               time_ms_reset(run, lambda: g32.copy_(g_src)),
               time_ms_reset(lambda: bin_mp.mp_stack_bwd_vocab_plain(codes, g32, pw, vt, act),
                             lambda: g32.copy_(g_src), iters=3),
               ops, nbytes, 1e-4 if f32 else TRAIN_TOL, same)
        # --- the attention pool, forward and backward
        xo = out
        fwd = bin_attnpool.attnpool_fwd_vocab(codes, xo, pm, aw, act, vt)
        fref = bin_attnpool.attnpool_fwd_vocab_plain(codes, xo, pm, aw, act, vt)
        torch.cuda.synchronize()
        ops = 2 * n * E * Ds + 2 * n * H * (Ds + D) + 2 * npm * (Ds + D + 1)
        nbytes = lookup + D * A * isz + nb * mb * ab + 4 * ((Ds + D + 1) * B + H * A)
        record("attnpool_fwd_vocab", list(zip(fwd, fref, [None] * 4)),
               time_ms(lambda: bin_attnpool.attnpool_fwd_vocab(codes, xo, pm, aw, act, vt)),
               time_ms(lambda: bin_attnpool.attnpool_fwd_vocab_plain(codes, xo, pm, aw, act, vt),
                       iters=5),
               ops, nbytes, 1e-5 if f32 else TRAIN_TOL)
        gps = torch.randn(Ds, B, generator=gen, device=dev) * 1e-3
        gpo = torch.randn(D, B, generator=gen, device=dev) * 1e-3
        gcov = torch.randn(B, generator=gen, device=dev) * 1e-3
        args = (codes, xo, pm, aw, act, fref[3], gps, gpo, gcov, vt)
        bg = bin_attnpool.attnpool_bwd_vocab(*args)
        again = bin_attnpool.attnpool_bwd_vocab(*args)
        br = bin_attnpool.attnpool_bwd_vocab_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip((bg[0], bg[1], *bg[2]),
                                                      (again[0], again[1], *again[2])))
        dks_scale = float(br[2][2].abs().max())  # d_sb's exact value is 0: held to d_ks's scale
        pairs = [(bg[0], br[0], None), (bg[1], br[1], None)]
        pairs += [(a, r, dks_scale if i == 4 else None)
                  for i, (a, r) in enumerate(zip(bg[2], br[2]))]
        ops = 3 * 2 * n * E * Ds + 4 * 2 * n * H * (Ds + D) + 2 * npm * (Ds + D)
        nbytes = (lookup + 2 * D * A * isz + nb * mb * ab + 4 * (H * A + (Ds + D + 1) * B)
                  + 4 * (E * Ds + E * SV))
        record("attnpool_bwd_vocab", pairs,
               time_ms(lambda: bin_attnpool.attnpool_bwd_vocab(*args), iters=10),
               time_ms(lambda: bin_attnpool.attnpool_bwd_vocab_plain(*args), iters=5),
               ops, nbytes, 1e-4 if f32 else TRAIN_TOL, same)
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


def check_c3_kernels(pkg, cfg, model, batch, seed: int) -> dict:
    """``[c3-kernel]``: kernel 4 (the inject kernels, forward and backward)
    and kernel 1d (one layer: serving form, training form, backward)
    against their plain versions at the config-3 training shape (a
    size-sorted batch of 2048, bf16), with times and bounds."""
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
    rpre, rxct = bin_inject.inject_fwd_plain(x, *tables, iw)
    torch.cuda.synchronize()
    ops = 2 * snz * D + n * 2 * w_proj + 10 * tet_ops
    nbytes = (D * A + D * A + 3 * D * A) * isz + table_bytes + w_proj * isz
    record("inject_fwd", [(pre, rpre, None), (xct, rxct, None)],
           time_ms(lambda: bin_inject.inject_fwd(x, *tables, iw)),
           time_ms(lambda: bin_inject.inject_fwd_plain(x, *tables, iw), iters=5), ops, nbytes)

    # --- kernel 1d, serving form and training form: layer(pre) + pre
    w_layer = 2 * D * 2 * D + nblk * 2 * D * D
    ops = 2 * nnz * D + n * 2 * w_layer
    nbytes = 2 * D * A * isz + nb * ab * ab + w_layer * isz
    got = bin_mp.mp_layer_fwd(rpre, adj, sw, act)
    ref = bin_mp.mp_stack_plain(rpre, adj, sw, act)
    torch.cuda.synchronize()
    record("mp_layer_fwd", [(got, ref, None)],
           time_ms(lambda: bin_mp.mp_layer_fwd(rpre, adj, sw, act)),
           time_ms(lambda: bin_mp.mp_stack_plain(rpre, adj, sw, act), iters=5), ops, nbytes)
    got = bin_mp.mp_layer_fwd_train(rpre, adj, sw, spec)
    ref = bin_mp.mp_stack_train_plain(rpre, adj, sw, spec)[0]
    torch.cuda.synchronize()
    record("mp_layer_fwd_train", [(got, ref, None)],
           time_ms(lambda: bin_mp.mp_layer_fwd_train(rpre, adj, sw, spec)),
           time_ms(lambda: bin_mp.mp_stack_train_plain(rpre, adj, sw, spec), iters=5), ops, nbytes)

    # --- kernel 1d backward (1b for one layer): dpre (residual included) and
    # the layer's weight gradients
    g = (torch.randn(D, A, generator=gen, device=dev) * 0.05).to(dt)
    g32, lg = bin_mp.mp_layer_bwd(rpre, adj, sw, spec, g)
    rg32, rlg = bin_mp.mp_layer_bwd_plain(rpre, adj, sw, spec, g)
    torch.cuda.synchronize()
    ops = (2 * 2 * nnz * D + n * 2 * (2 * D * D + (2 * nblk - 1) * D * D)
           + n * 2 * (2 * nblk * D * D + 4 * D * D) + n * 2 * w_layer)
    nbytes = 3 * D * A * isz + nb * ab * ab + 4 * w_layer
    record("mp_layer_bwd", [(g32, rg32, None)] + [(a, r, None) for a, r in zip(lg, rlg)],
           time_ms(lambda: bin_mp.mp_layer_bwd(rpre, adj, sw, spec, g), iters=10),
           time_ms(lambda: bin_mp.mp_layer_bwd_plain(rpre, adj, sw, spec, g), iters=3),
           ops, nbytes)

    # --- kernel 4, inject backward: dx through the projection, the
    # polynomial and the equilibration, and d_kb, d_b (split-K contraction)
    dpre, rdpre = g32.to(dt), rg32.to(dt)

    def bwd():
        return (bin_inject.inject_bwd(x, *tables, iw, rxct, rdpre),
                *bin_mp.wgrad(rdpre, rxct, bias_src=rg32))

    def bwd_plain():
        return (bin_inject.inject_bwd_plain(x, *tables, iw, rxct, rdpre),
                rdpre.float() @ rxct.float().T, rg32.sum(1))

    got, want = bwd(), bwd_plain()
    torch.cuda.synchronize()
    ops = 2 * n * 2 * w_proj + 2 * snz * D + 30 * tet_ops
    nbytes = (D * A + 3 * D * A + D * A + D * A) * isz + 4 * D * A + table_bytes + 4 * (w_proj + D)
    record("inject_bwd", list(zip(got, want, [None] * 3)), time_ms(bwd, iters=10),
           time_ms(bwd_plain, iters=3), ops, nbytes)
    del dpre
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


def profile_step(step, tag: str = "train", top: int = 12):
    """Device time of one train step, by kernel (torch.profiler); returns
    the total in ms, or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        print(f"[{tag}] device time not measured (no CUDA events in the trace)", flush=True)
        return None
    print(f"[{tag}] one step, device time {total / 1e3:.3f} ms summed over kernels:", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}%  x{e.count:<3d} {e.key[:90]}",
              flush=True)
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
    counters = counters or (bin_mp.mp_stack_fwd_train, bin_mp.mp_stack_bwd,
                            bin_attnpool.attnpool_fwd, bin_attnpool.attnpool_bwd)
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
        loss = trainer.train_step(model, opt, b, 5e-4, loss_fn, drop_seed, gen)
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

    def scale(k):
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
                return sum(float((params[n + w] * grads["cpu"][n + w]).sum())
                           for w in ("weight", "bias"))

            return sum(abs(head(h)) for h in range(cfg.attention_num_heads)) / abs(
                float(params[k]))
        return max(float(grads["cpu"][k].abs().max()), 1e-30)

    errs = {k: float((grads["cuda"][k] - g).abs().max()) / scale(k)
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
    """``[c1-kernel]``: kernel 2b (``wpool_bwd``: dx and dw) against its
    plain version on x_self's and x_other's rows, fp32 and bf16, at the
    config-1 training batch's pool matrix and two with mb not a multiple
    of 16, with w = 1 (mean pooling) and a random w on the real atoms;
    timed (both launches of a step, dx and dw) at the training batch."""
    from aimnet_x2d_tpu_torch.ops import bin_wpool

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    pm = batch.pool_mat
    nb, mb, ab = pm.shape
    A = nb * ab
    print(f"[c1-kernel] shapes nb={nb} ab={ab} mb={mb} A={A} real atoms="
          f"{int(batch.atom_mask.sum())} molecules={int(batch.graph_mask.sum())}", flush=True)

    def rand_pm(mb_):
        owner = torch.randint(-1, mb_, (nb, ab), generator=gen, device=dev)
        return (owner[:, None, :] == torch.arange(mb_, device=dev)[None, :, None]).to(torch.int8)

    real = batch.atom_mask.float()
    weights = {"w=1": torch.ones(A, device=dev),
               "w random": torch.rand(A, generator=gen, device=dev) * real}
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[("wpool_bwd", dt)]
        worst = 0.0
        for pm_ in (pm, rand_pm(20), rand_pm(44)):
            mb_ = pm_.shape[1]
            for d in (cfg.x_self_dim, cfg.x_other_dim):
                x = torch.randn(d, A, generator=gen, device=dev).to(dt)
                g = torch.randn(d, nb * mb_, generator=gen, device=dev)
                for wname, w in weights.items():
                    dx, dw = bin_wpool.wpool_bwd(x, w, pm_, g)
                    rdx, rdw = bin_wpool.wpool_bwd_plain(x, w, pm_, g)
                    torch.cuda.synchronize()
                    (ax, rx), (aw, rw) = rel_err(dx, rdx), rel_err(dw, rdw)
                    worst = max(worst, ax, aw)
                    print(f"[c1-kernel] wpool_bwd {str(dt)[6:]} D={d} mb={mb_} {wname}: dx "
                          f"max_abs_err={ax:.3e} rel={rx:.3e}, dw max_abs_err={aw:.3e} "
                          f"rel={rw:.3e} (tol {tol:g})", flush=True)
                    if not max(rx, rw) <= tol:
                        raise AssertionError(f"wpool_bwd {dt} D={d} mb={mb_} {wname}: rel err "
                                             f"{max(rx, rw):.3e} > {tol:g}")
        # main-path shapes: both launches of a step (x_self's and x_other's
        # rows, w = 1), with dw; bytes: x read, dx written, g, pm, w, dw
        tot = dict(max_abs_err=worst, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   bound_by="bytes")
        no_dw_ms = 0.0
        w = weights["w=1"]
        npm = int((pm != 0).sum())
        for d in (cfg.x_self_dim, cfg.x_other_dim):
            x = torch.randn(d, A, generator=gen, device=dev).to(dt)
            g = torch.randn(d, nb * mb, generator=gen, device=dev)
            g3, pm_dt = g.reshape(d, nb, mb).to(dt), pm.to(dt)
            isz = x.element_size()
            nbytes = 2 * d * A * isz + 4 * d * nb * mb + nb * mb * ab + 4 * A + 4 * A
            ops = 2 * d * npm + 3 * d * A
            t_ops = ops / PEAK_FLOPS[torch.float32]
            tot["ms"] += time_ms(lambda: bin_wpool.wpool_bwd(x, w, pm, g))
            no_dw_ms += time_ms(lambda: bin_wpool.wpool_bwd(x, w, pm, g, need_dw=False))
            tot["plain_ms"] += time_ms(lambda: bin_wpool.wpool_bwd_plain(x, w, pm, g), iters=5)
            tot["library_ms"] += time_ms(lambda: torch.einsum("dbm,bma->dba", g3, pm_dt))
            tot["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_S, t_ops)
            if t_ops > nbytes / HBM_BYTES_S:
                tot["bound_by"] = "operations"
        print(f"[c1-kernel] wpool_bwd {str(dt)[6:]} per step (D={cfg.x_self_dim} + "
              f"D={cfg.x_other_dim}, mb={mb}, dx and dw): ms={tot['ms']:.4f} "
              f"plain_ms={tot['plain_ms']:.4f} library_ms={tot['library_ms']:.4f} (einsum of "
              f"g with pm) bound_ms={tot['bound_ms']:.4f} ({tot['bound_by']}); without dw, as "
              f"mean pooling runs it: {no_dw_ms:.4f} ms", flush=True)
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


def check_flat_kernels(cfg, host_batch, batch, seed: int) -> tuple:
    """``[flat-kernel]``: kernel 7 (``fused_edge_fwd`` on the batch's
    destination-keyed layout, ``fused_edge_bwd`` on the source-keyed one
    with an fp32 cotangent) and kernel 8 (``wseg_sum`` on the batch's
    windowed layout) against their plain versions, D 153 and 359, fp32 and
    bf16 (kernel 8: exact, and data rounded to bf16), timed at the main
    path's shape (D = x_other's 153; kernel 7 in bf16, kernel 8 exact) with
    bounds and library yardsticks.  Then kernel 8's op driven once, counts
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

    def adjacency(layout):
        # the multiplicity adjacency as one coalesced CSR matrix (library operand)
        rows = torch.repeat_interleave(torch.arange(A, device=dev), torch.diff(layout.row_ptr))
        idx = torch.stack([rows, layout.col.long()])
        coo = torch.sparse_coo_tensor(idx, torch.ones(E, device=dev), (A, A)).coalesce()
        return coo.to_sparse_csr()

    def record(name, key, got_ref, ms, plain_ms, library_ms, nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[torch.float32]
        res[key] = dict(max_abs_err=got_ref, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=1e3 * max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
        r = res[key]
        print(f"[flat-kernel] {name} at the main path's shape: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}; "
              f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)", flush=True)

    def compare(name, got, ref, what):
        torch.cuda.synchronize()
        abs_err, rel32 = rel_err(got, ref)
        _, rel16 = rel_err(got.to(torch.bfloat16), ref.to(torch.bfloat16))
        ok = rel32 <= FLAT_TOL[torch.float32] and rel16 <= FLAT_TOL[torch.bfloat16]
        print(f"[flat-kernel] {name} {what}: max_abs_err={abs_err:.3e} rel={rel32:.3e} (tol "
              f"{FLAT_TOL[torch.float32]:g}), after the cast to bf16 rel={rel16:.3e} (tol "
              f"{FLAT_TOL[torch.bfloat16]:g})", flush=True)
        if not ok:
            raise AssertionError(f"{name} {what}: rel err {rel32:.3e} / {rel16:.3e}")
        return abs_err

    res = {}
    adj = {"fused_edge_fwd": adjacency(fwd), "fused_edge_bwd": adjacency(bwd)}
    for D in (cfg.x_other_dim, cfg.x_self_dim):
        for dt in (torch.float32, torch.bfloat16):
            exact = dt == torch.float32
            x = torch.randn(A, D, generator=gen, device=dev).to(dt)
            g = torch.randn(A, D, generator=gen, device=dev)
            for name, fn, lay, inp in (("fused_edge_fwd", fused_edge.fused_edge_fwd, fwd, x),
                                       ("fused_edge_bwd", fused_edge.fused_edge_bwd, bwd, g)):
                err = compare(name, fn(inp, lay, exact), fused_edge.fused_edge_plain(inp, lay, exact),
                              f"{str(dt)[6:]} D={D}")
                if D != cfg.x_other_dim or exact:
                    continue
                x32 = inp.float()
                nbytes = inp.numel() * inp.element_size() + 4 * A * D + 4 * (A + 1) + 4 * E
                record(name, (name, torch.bfloat16), err,
                       time_ms(lambda: fn(inp, lay, exact)),
                       time_ms(lambda: fused_edge.fused_edge_plain(inp, lay, exact), iters=5),
                       time_ms(lambda: torch.sparse.mm(adj[name], x32)), nbytes, E * D)

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
            got = pallas_segment.wseg_sum(data, sl, W, cap, window, exact)
            ref = pallas_segment.windowed_segment_sum_plain(data, sl, W, cap, window, exact)
            err = compare("wseg_sum", got, ref,
                          f"{'exact' if exact else 'data rounded to bf16'} D={D}")
            if D != cfg.x_other_dim or not exact:
                continue
            ids = torch.where(sl < window, torch.arange(W, device=dev).repeat_interleave(cap)
                              * window + sl, W * window).long()
            out = torch.zeros(W * window + 1, D, device=dev)
            # the real slots' rows read, the seg ids read, the output written
            nbytes = 4 * E * D + 4 * W * cap + 4 * W * window * D
            record("wseg_sum", ("wseg_sum", torch.float32), err,
                   time_ms(lambda: pallas_segment.wseg_sum(data, sl, W, cap, window, exact)),
                   time_ms(lambda: pallas_segment.windowed_segment_sum_plain(
                       data, sl, W, cap, window, exact), iters=5),
                   time_ms(lambda: out.index_add_(0, ids, data)), nbytes, E * D)
        del data
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


def check_pool6_kernel(cfg, model, batch, seed: int) -> dict:
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
            ms = time_ms(lambda: fn(*args))
            plain_ms = time_ms(lambda: plain(*args), iters=5)
            t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_FLOPS[dt]
            bound_ms = 1e3 * max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"[pool6-kernel] {name} {str(dt)[6:]}: max_abs_err={abs_err:.3e} rel={rel:.3e} "
                  f"(tol {tol:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by}; {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)", flush=True)
            if not rel <= tol:
                raise AssertionError(f"{name} {dt}: rel err {rel:.3e} > {tol:g}")
            res[(name, dt)] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    again = bin_pool.bin_pool_bwd(*bwd)
    same = all(torch.equal(a, r) for a, r in zip((bg[0], bg[1], *bg[2]),
                                                   (again[0], again[1], *again[2])))
    print(f"[pool6-kernel] bin_pool_bwd bf16 twice: bit-equal {same}", flush=True)
    if not same:
        raise AssertionError("two runs of bin_pool_bwd differ")
    return res


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
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)

    t0 = time.perf_counter()
    cuda_build.build_all(verbose=True)
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = flagship_config(pkg)
    smiles = make_smiles(args.molecules, args.seed)
    t0 = time.perf_counter()
    ds = MoleculeDataset.from_smiles(smiles[:2048], np.zeros((2048, 1), np.float32), cfg.num_shells)
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
    print(f"[data] 2048 molecules (mean {np.mean([f.num_atoms for f in ds.features]):.1f} atoms "
          f"with H): featurize {t1 - t0:.3f} s, collate + bin-pack {t2 - t1:.3f} s, "
          f"copy to the card {t4 - t3:.4f} s (first copy {t3 - t2:.3f} s; host clock)", flush=True)

    res = check_kernels(pkg, cfg, batch, args.seed)
    launches = serve(pkg, cfg, smiles, args.seed, work, batch)

    from aimnet_x2d_tpu_torch.checkpoint import init_params, params_from_flax

    tcfg = train_config(cfg)
    tloader = BatchLoader(ds, 2048, shuffle=True, seed=args.seed)
    tbatch = next(iter(tloader)).to("cuda")
    tmodel = pkg.models.gnn.GNN(tcfg)
    tmodel.load_state_dict(params_from_flax(init_params(tcfg, args.seed)))
    tmodel.to("cuda")
    for name, r in check_train_kernels(pkg, tcfg, tmodel, tbatch, args.seed).items():
        res[(name, torch.bfloat16)] = r
    res.update(check_fold_kernels(pkg, tcfg, tmodel, tbatch, args.seed))
    full = MoleculeDataset.from_smiles(smiles, np.zeros((len(smiles), 1), np.float32),
                                       cfg.num_shells)
    launches.update(train_phase(pkg, tcfg, smiles, full, args.seed, work))
    print(f"[time] flagship phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

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
                       bin_attnpool.attnpool_bwd),
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
                                          cfg.num_shells)
    c3_ds = MoleculeDataset(c3_full.smiles[:2048], c3_full.targets[:2048],
                            c3_full.features[:2048], c3_full.max_hops)
    c3_tcfg = train_config(c3)
    c3_model = pkg.models.gnn.GNN(c3_tcfg)
    c3_model.load_state_dict(params_from_flax(init_params(c3_tcfg, args.seed)))
    c3_model.to("cuda")
    c3_tbatch = next(iter(BatchLoader(c3_ds, 2048, shuffle=True, seed=args.seed))).to("cuda")
    for name, r in check_c3_kernels(pkg, c3_tcfg, c3_model, c3_tbatch, args.seed).items():
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
                                          c1.num_shells)
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
                                          cfg.num_shells)
    sizes = np.array([f.num_atoms for f in fl_full.features])
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
    fl_res, wseg_launches = check_flat_kernels(cfg, fl_host, fl_batch, args.seed)
    res.update(fl_res)
    binned_serving = (bin_mp.mp_stack_fwd, bin_mp.mp_layer_fwd, bin_wpool.wpool_fwd,
                      bin_attnpool.attnpool_fwd, bin_inject.inject_fwd)
    fl_launches = serve(pkg, cfg, fl_smiles, args.seed, work, fl_batch, tag="flat-serve",
                        counters=(fused_edge.fused_edge_fwd,), forbidden=binned_serving, n_cpu=128)
    n_batches = -(-len(fl_smiles) // 2048)
    if fl_launches["fused_edge_fwd"] != 3 * n_batches:
        raise AssertionError(f"kernel 7 launched {fl_launches['fused_edge_fwd']} times for "
                             f"{n_batches} batches of a 3-layer model")
    del fl_batch
    binned_training = (bin_mp.mp_stack_fwd_train, bin_mp.mp_stack_bwd, bin_mp.mp_layer_fwd_train,
                       bin_mp.mp_layer_bwd, bin_wpool.wpool_fwd, bin_wpool.wpool_bwd,
                       bin_attnpool.attnpool_fwd, bin_attnpool.attnpool_bwd,
                       bin_inject.inject_fwd, bin_inject.inject_bwd)
    fl_train = train_phase(pkg, tcfg, fl_smiles, fl_full, args.seed, work, tag="flat-train",
                           counters=(fused_edge.fused_edge_fwd, fused_edge.fused_edge_bwd),
                           forbidden=binned_training,
                           want_per_step={"fused_edge_fwd": 3, "fused_edge_bwd": 3})
    launches["fused_edge_fwd"] = fl_launches["fused_edge_fwd"]  # serving's count
    launches["fused_edge_bwd"] = fl_train["fused_edge_bwd"]
    launches["wseg_sum"] = wseg_launches
    print(f"[time] flat-layout phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # --- true per-hop aggregation: the flagship on the row-major binned
    # route, its attention pool kernel 6
    import dataclasses

    from aimnet_x2d_tpu_torch.ops import bin_pool

    mh = dataclasses.replace(cfg, parity_mode=False)
    for key, r in check_pool6_kernel(mh, tmodel, tbatch, args.seed).items():
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
                                           cfg.num_shells)
    c3f_host = next(iter(BatchLoader(c3f_full, 2048)))
    n_big = int(sum(f.num_atoms > 256 for f in c3f_full.features))
    print(f"[c3-flat] {len(c3f_full)} molecules, {n_big} larger than a bin; the first batch: "
          f"{int(c3f_host.tet_mask.sum())} tetrahedral centres, "
          f"{int(c3f_host.cis_mask.sum() + c3f_host.trans_mask.sum())} cis/trans rows; featurize "
          f"{time.perf_counter() - t0:.3f} s (host clock)", flush=True)
    if (len(c3f_full) != len(c3f_smiles) or c3f_host.pool_mat is not None or n_big < 2
            or not c3f_host.tet_mask.any() or not (c3f_host.cis_mask.any()
                                                   and c3f_host.trans_mask.any())):
        raise AssertionError("the config-3 flat data lost molecules, went binned or has no "
                             "stereo content")
    c3f = serve(pkg, c3, c3f_smiles, args.seed, work, c3f_host.to("cuda"), tag="c3-flat-serve",
                counters=(fused_edge.fused_edge_fwd,),
                forbidden=binned_serving + (bin_pool.bin_pool_fwd,), n_cpu=128)
    if c3f["fused_edge_fwd"] != 3 * -(-len(c3f_smiles) // 2048):
        raise AssertionError(f"kernel 7 launched {c3f['fused_edge_fwd']} times in config-3 flat "
                             f"serving")
    del c3f_host
    train_phase(pkg, train_config(c3), c3f_smiles, c3f_full, args.seed, work,
                tag="c3-flat-train", counters=edge_kernels,
                forbidden=binned_training + (bin_pool.bin_pool_fwd, bin_pool.bin_pool_bwd),
                steps=C3_TRAIN_STEPS, want_per_step={"fused_edge_fwd": 3, "fused_edge_bwd": 3})
    print(f"[time] config-3 flat phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for name, src, tpu in (
        ("mp_stack_fwd", "aimnet_x2d_tpu_torch/csrc/mp_stack.cu", "aimnet_x2d_tpu/ops/bin_mp.py:639"),
        ("wpool_fwd", "aimnet_x2d_tpu_torch/csrc/wpool.cu", "aimnet_x2d_tpu/ops/bin_wpool.py:83"),
        ("mp_stack_fwd_train", "aimnet_x2d_tpu_torch/csrc/mp_stack.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:639"),
        ("mp_stack_bwd", "aimnet_x2d_tpu_torch/csrc/mp_stack_bwd.cu",
         "aimnet_x2d_tpu/ops/bin_mp.py:659"),
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
    ):
        # the flagship's dtype; kernel 8 at its op's default, exact fp32
        r = res[(name, torch.float32 if name == "wseg_sum" else torch.bfloat16)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
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
