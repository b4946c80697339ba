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
   card and on the CPU (plain versions) from the same weights, all
   gradients compared;
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
8. print the ``kernels`` JSON line, the card line and, last, the result
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
          counters=None) -> dict:
    """Phase 4 (and ``[c3-serve]``): the port's CLI on cuda, counters of
    the path's kernels (default: the flagship's), output checks, CPU
    comparison of one batch, model-only throughput."""
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

    for c in counters:
        c.launches = 0
    summary = cli.main(["--inference_csv", csv_in, "--model_save_path", art,
                        "--inference_output", csv_out, "--device", "cuda"])
    launches = {c.__name__: c.launches for c in counters}
    print(f"[{tag}] launches on the main path: {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    out = pd.read_csv(csv_out)
    if summary["valid_molecules"] != len(smiles) or len(out) != len(smiles):
        raise AssertionError(f"{len(out)} rows for {len(smiles)} SMILES ({summary})")
    vals = out[cols].to_numpy(np.float64)
    if vals.shape != (len(smiles), T) or not np.isfinite(vals).all():
        raise AssertionError("predictions are not all finite or have the wrong shape")

    # one batch on the CPU, plain versions, raw (scaled) outputs
    n_cpu = 256
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


def profile_step(step, top: int = 12) -> None:
    """Device time of one train step, by kernel (torch.profiler)."""
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
        print("[train] device time not measured (no CUDA events in the trace)", flush=True)
        return
    print(f"[train] one step, device time {total / 1e3:.3f} ms summed over kernels:", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[train]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}%  x{e.count:<3d} {e.key[:90]}",
              flush=True)


def train_phase(pkg, cfg, smiles, ds, seed: int, work: str, tag: str = "train",
                counters=None, steps: int = TRAIN_STEPS) -> dict:
    """Phase 6 (and ``[c3-train]``): the CLI's training path on the card
    with the counters of the path's kernels (default: the flagship's), a
    timed train-step loop of ``steps`` steps, and one step card against
    CPU.  With partial charges the CLI also writes the test split's
    charges, which are checked."""
    import dataclasses

    import pandas as pd

    from aimnet_x2d_tpu_torch import cli
    from aimnet_x2d_tpu_torch.checkpoint import init_params, load_artifact, params_from_flax
    from aimnet_x2d_tpu_torch.data.dataset import BatchLoader, MoleculeDataset
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_mp
    from aimnet_x2d_tpu_torch.training import trainer

    T = cfg.output_dim
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

    # --- the user's entry point: the CLI, bf16, dropout 0.05 (the defaults)
    for c in counters:
        c.launches = 0
    summary = cli.main(["--data_path", csv, "--multi_target_columns", ",".join(cols),
                        "--task_type", "multitask", "--mixed_precision", "--epochs", "3",
                        "--batch_size", "2048", "--learning_rate", "1e-3",
                        "--model_save_path", art, "--seed", str(seed), *extra])
    launches = {c.__name__: c.launches for c in counters}
    print(f"[{tag}] launches on the main path (CLI, 3 epochs): {launches}", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a training kernel never launched: {launches}")
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
    want = (cfg.hidden_dim, T, "bfloat16", cfg.use_partial_charges, cfg.use_stereochemistry)
    if (mc.hidden_dim, mc.output_dim, mc.compute_dtype, mc.use_partial_charges,
            mc.use_stereochemistry) != want:
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
    loss_fn = trainer.make_loss_fn(trainer.TrainConfig(task_type="multitask"))
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
    print(f"[{tag}] step ms: {[round(x, 3) for x in ms]}", flush=True)
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    b0 = batches[0]
    profile_step(lambda: trainer.train_step(model, opt, b0, 5e-4, loss_fn, 5, gen))

    # --- one step card vs CPU, flagship widths, a small batch; the stack's
    # dropout mask is the same hash on both sides, the FFN's generator is not
    cfg1 = dataclasses.replace(cfg, ffn_dropout=0.0)
    small = MoleculeDataset.from_smiles(smiles[:96], targets[:96], cfg.num_shells)
    sb = next(iter(BatchLoader(small.with_targets(pipe.transform(small.atomic_numbers(),
                                                                 small.targets)), 96)))
    grads = {}
    for where in ("cuda", "cpu"):
        m = pkg.models.gnn.GNN(cfg1)
        m.load_state_dict(params_from_flax(init_params(cfg, seed)))
        m.to(where)
        bb = sb.to(where)
        out = m(bb, train=True, drop_seed=77)
        loss_fn(out.predictions, bb.targets, bb.graph_mask).backward()
        grads[where] = {k: p.grad.detach().float().cpu() for k, p in m.named_parameters()
                        if p.grad is not None}
    def scale(k):
        # the heads' score biases shift every score of a head alike, which
        # leaves each molecule's softmax unchanged: their exact gradient is
        # 0, so both sides hold rounding residue, held to the heads' kernels
        if k.startswith("pooling.attention_weights.") and k.endswith(".bias"):
            k = k[: -len("bias")] + "weight"
        return max(float(grads["cpu"][k].abs().max()), 1e-30)

    errs = {k: float((grads["cuda"][k] - g).abs().max()) / scale(k)
            for k, g in grads["cpu"].items()}
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    worst = top[0][1]
    print(f"[{tag}] one step card vs cpu ({int(sb.graph_mask.sum())} molecules, "
          f"{len(grads['cpu'])} gradients): worst max|d|/max|cpu| {worst:.3e} "
          f"(tol {TRAIN_TOL:g}); largest {[(k, f'{v:.2e}') for k, v in top]}", flush=True)
    if not worst <= TRAIN_TOL:
        raise AssertionError(f"card gradients differ from the CPU run: {worst:.3e}")
    return launches


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
    full = MoleculeDataset.from_smiles(smiles, np.zeros((len(smiles), 1), np.float32),
                                       cfg.num_shells)
    launches.update(train_phase(pkg, tcfg, smiles, full, args.seed, work))
    print(f"[time] flagship phases done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # --- config 3 (partial charges + stereochemistry) at the flagship width,
    # on SMILES with stereo content
    from aimnet_x2d_tpu_torch.ops import bin_attnpool, bin_inject, bin_mp, bin_wpool

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
    ):
        r = res[(name, torch.bfloat16)]  # the flagship's dtype
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
