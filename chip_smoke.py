#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aimnet_x2d_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--molecules N]

Phases, each of which fails the run when it fails:

1. print the card's name and power limit; turn TF32 off for fp32 products;
2. build the CUDA kernels from ``aimnet_x2d_tpu_torch/csrc`` (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version at the flagship
   serving shapes (a batch of 2048 molecules of the script's SMILES), in
   fp32 and bf16, and time kernel, plain version and library yardstick;
4. serve end to end: write a flagship artifact (hidden 512, bf16, random
   weights from the seed, fitted scaler), run a CSV of the script's SMILES
   through the port's CLI on ``cuda`` with the kernel launch counters reset
   just before, check every row is present and finite and both kernels ran,
   and compare one batch with the same model run on the CPU (plain
   versions);
5. print the ``kernels`` JSON line, the card line and, last, the result
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_smiles(n: int, seed: int) -> list:
    """``n`` valid QM9-like SMILES: a terminal group, one to four divalent
    chain units, a terminal group (7-40 atoms with hydrogens)."""
    rng = np.random.default_rng(seed)
    heads = ["C", "O", "N", "F", "Cl", "N#C", "FC(F)(F)", "OC(=O)", "CC", "C=C"]
    units = ["C", "CC", "O", "N", "C(C)", "C(=O)", "C=C", "C#C", "C(O)", "C(N)",
             "c1ccc(cc1)", "C1CCC(CC1)", "C1CC1", "S"]
    tails = ["C", "O", "N", "F", "Cl", "C#N", "C(F)(F)F", "C(=O)O", "CC", "C=O"]
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 5))
        parts = [heads[rng.integers(len(heads))]]
        parts += [units[rng.integers(len(units))] for _ in range(k)]
        parts.append(tails[rng.integers(len(tails))])
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


def serve(pkg, cfg, smiles, seed: int, work: str, dev_batch) -> dict:
    """Phase 4: the port's CLI on cuda, counters, output checks, CPU
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

    rng = np.random.default_rng(seed)
    T = cfg.output_dim
    scaler = StandardScaler()
    scaler.fit(rng.normal(size=(512, T)) * rng.uniform(0.5, 3.0, T) + rng.uniform(-5, 5, T))
    prep = PreprocessingPipeline(PreprocessingConfig(task_type="multitask"))
    prep.standard_scaler, prep.is_fitted = scaler, True
    cols = [f"target_{i}" for i in range(T)]
    flat = init_params(cfg, seed)
    art = os.path.join(work, "flagship.npz")
    save_artifact(art, flat, cfg, prep, extra={"target_columns": cols, "max_hops": cfg.num_shells})
    csv_in, csv_out = os.path.join(work, "mols.csv"), os.path.join(work, "preds.csv")
    pd.DataFrame({"smiles": smiles}).to_csv(csv_in, index=False)

    bin_mp.mp_stack_fwd.launches = 0
    bin_wpool.wpool_fwd.launches = 0
    summary = cli.main(["--inference_csv", csv_in, "--model_save_path", art,
                        "--inference_output", csv_out, "--device", "cuda"])
    launches = {"mp_stack_fwd": bin_mp.mp_stack_fwd.launches,
                "wpool_fwd": bin_wpool.wpool_fwd.launches}
    print(f"[serve] launches on the main path: {launches}", flush=True)
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
    print(f"[serve] card vs cpu on {n_cpu} molecules: max_abs_err={e2e_abs:.3e} "
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
    print(f"[serve] run_csv: {summary['valid_molecules']} molecules in {summary['seconds']:.3f} s "
          f"= {summary['molecules_per_second']:.1f} mol/s end to end, of which featurization "
          f"{summary['featurize_seconds']:.3f} s (host, pure-Python featurizer)", flush=True)
    print(f"[serve] model forward, batch of {n_mol} molecules (already on the card): "
          f"{step_ms:.3f} ms = {mps:.1f} mol/s", flush=True)
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

    kernels = []
    for name, src, tpu in (
        ("mp_stack_fwd", "aimnet_x2d_tpu_torch/csrc/mp_stack.cu", "aimnet_x2d_tpu/ops/bin_mp.py:639"),
        ("wpool_fwd", "aimnet_x2d_tpu_torch/csrc/wpool.cu", "aimnet_x2d_tpu/ops/bin_wpool.py:83"),
    ):
        r = res[(name, torch.bfloat16)]  # the serving path's dtype
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
