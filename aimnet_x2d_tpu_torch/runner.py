"""Experiment runner (counterpart of aimnet_x2d_tpu/runner.py).

``main_runner`` validates the arguments, creates the output directories,
checks the data paths, then serves (``inference/engine.py``) or trains.

Training loads the CSV(s), splits with the seeded two-stage split,
featurizes, fits the SAE + standard-scaling pipeline on the train split and
transforms every split, builds the binned loaders (the train loader
shuffles per epoch), initializes the model (copying the matching weights of
``--transfer_learning``'s artifact), trains (freeze masks, layer-wise LR
decay, tracker, checkpoints and resume from ``--checkpoint_dir``),
evaluates the best parameters on the test split, and saves the artifact
(flax-named ``.npz``, loadable by both packages) with the same ``extra``
fields as the JAX package and a ``.summary.json`` beside it; with
``--output_partial_charges`` (and partial charges on) it also writes the
test split's per-atom charges as ``.npz`` (``charges``, ``molecule_index``),
and with ``--experiment_config`` the resolved arguments as YAML.

With ``--num_devices N`` and/or ``--graph_shards G`` (N x G > 1) training
runs on N x G ranks, one process each, in the (data, graph) grid of
parallel/mesh.py (the JAX ``_parallel_from_args`` mesh): under ``torchrun``
this process is one rank (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
``MASTER_PORT``), otherwise the runner starts the ranks itself with
``torch.multiprocessing`` (spawn).  Rank r runs on ``cuda:{local rank %
cards}`` (or the CPU with ``--device cpu``), over NCCL when every rank has
a card of its own and gloo otherwise.  Each rank featurizes the splits,
takes its (data, graph) shard of every training step (halo-partitioned
when G > 1; config 3 too), and trains with the grid's
step; rank 0 evaluates, prints and writes the artifact; every rank leaves
the process group at the end.  Serving spreads over ranks under torchrun
only (inference/engine.py); without it the flags serve in one process.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .checkpoint import (
    TrainCheckpointer,
    init_params,
    load_artifact,
    params_from_flax,
    params_to_flax,
    save_artifact,
    transfer_params,
)
from .chem import native
from .config import save_experiment_config, setup_paths, validate_args
from .data.dataset import BatchLoader, MoleculeDataset
from .data.io import load_dataset, split_dataset
from .data.preprocessing import PreprocessingConfig, PreprocessingPipeline
from .models.gnn import GNN, GNNConfig
from .parallel import mesh, multihost
from .training.evaluator import evaluate
from .training.predictor import extract_partial_charges, predict
from .training.trainer import TrainConfig, train
from .utils.device import resolve_device
from .utils.optimization import count_parameters, train_mask
from .utils.tracking import create_tracker


def gnn_config_from_args(args: argparse.Namespace, output_dim: int) -> GNNConfig:
    return GNNConfig(
        hidden_dim=args.hidden_dim,
        output_dim=output_dim,
        num_shells=args.num_shells,
        num_message_passing_layers=args.num_message_passing_layers,
        embedding_dim=args.embedding_dim,
        ffn_hidden_dim=args.ffn_hidden_dim,
        ffn_num_layers=args.ffn_num_layers,
        ffn_dropout=args.ffn_dropout,
        pooling_type=args.pooling_type,
        task_type=args.task_type,
        activation_type=args.activation_type,
        shell_conv_num_mlp_layers=args.shell_conv_num_mlp_layers,
        shell_conv_dropout=args.shell_conv_dropout,
        attention_num_heads=args.attention_num_heads,
        attention_temperature=args.attention_temperature,
        use_partial_charges=args.use_partial_charges,
        use_stereochemistry=args.use_stereochemistry,
        loss_function=args.loss_function,
        parity_mode=not args.true_multi_hop,
        compute_dtype="bfloat16" if args.mixed_precision else "float32",
        remat=args.gradient_checkpointing,
    )


def train_config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        loss_function=args.loss_function,
        task_type=args.task_type,
        multitask_weights=args.multitask_weight_list,
        evidential_lambda=args.evidential_lambda,
        early_stopping=args.early_stopping,
        patience=args.patience,
        lr_scheduler=args.lr_scheduler,
        lr_reduce_factor=args.lr_reduce_factor,
        lr_patience=args.lr_patience,
        lr_cosine_t_max=args.lr_cosine_t_max,
        lr_step_size=args.lr_step_size,
        lr_step_gamma=args.lr_step_gamma,
        lr_exp_gamma=args.lr_exp_gamma,
        layer_wise_lr_decay=args.layer_wise_lr_decay,
        lr_decay_factor=args.lr_decay_factor,
        freeze_patterns=args.freeze_layer_list,
        # --freeze_pretrained without a list: train the output head only
        unfreeze_patterns=(args.unfreeze_layer_list
                           or (["output_layer"] if args.freeze_pretrained
                               and not args.freeze_layer_list else None)),
    )


def _load_splits(args):
    kwargs = dict(smiles_column=args.smiles_column, target_column=args.target_column,
                  multi_target_columns=args.multi_target_list)
    if args.data_path is not None:
        smiles, targets = load_dataset(args.data_path, **kwargs)
        return split_dataset(smiles, targets, args.train_split, args.val_split,
                             args.test_split, seed=args.seed)
    if not (args.train_data and args.val_data and args.test_data):
        raise ValueError("training needs --data_path, or --train_data, --val_data and --test_data")
    return tuple(load_dataset(p, **kwargs) for p in (args.train_data, args.val_data,
                                                      args.test_data))


def featurize_workers(args: argparse.Namespace) -> int:
    """Featurizer threads: ``--precompute_num_workers``, else
    ``--num_workers`` (the JAX CLI's fallback)."""
    w = args.precompute_num_workers
    return max(args.num_workers if w is None else w, 1)


def _parallel_from_args(args: argparse.Namespace) -> Tuple[int, int]:
    """(n_data, n_graph) from --num_devices / --graph_shards."""
    return args.num_devices or 1, args.graph_shards or 1


def _preprocessing_config(args: argparse.Namespace) -> PreprocessingConfig:
    return PreprocessingConfig(apply_sae=args.calculate_sae, sae_subtasks=args.sae_subtask_list,
                               apply_standard_scaling=True, task_type=args.task_type)


def _hdf5_paths(args: argparse.Namespace):
    return [args.train_hdf5, args.val_hdf5, args.test_hdf5]


def build_hdf5(args: argparse.Namespace) -> None:
    """The ``--iterable_dataset`` files: kept when all three exist, else
    built out of core from the CSV input (a chunk in memory at a time), the
    preprocessing fit on the train file and applied to all three in place."""
    from .data.hdf5 import (fit_pipeline_streaming, transform_targets_streaming,
                            write_hdf5_streaming)

    paths = _hdf5_paths(args)
    if all(os.path.exists(p) for p in paths):
        return
    (tr_s, tr_t), (va_s, va_t), (te_s, te_t) = _load_splits(args)
    cols = args.multi_target_list or [args.target_column]
    for (s, t), path in zip(((tr_s, tr_t), (va_s, va_t), (te_s, te_t)), paths):
        kept = write_hdf5_streaming(path, s, t, args.num_shells,
                                    num_workers=featurize_workers(args), target_columns=cols)
        print(f"[hdf5] wrote {kept}/{len(s)} molecules -> {path}")
    pipe = fit_pipeline_streaming(args.train_hdf5, _preprocessing_config(args))
    for path in paths:
        transform_targets_streaming(path, pipe)


def _in_memory_data(args: argparse.Namespace, grid: Optional[mesh.Grid], say) -> Dict[str, Any]:
    """Load, split, featurize and preprocess the CSV input; the loaders."""
    n_data, n_graph = (grid.n_data, grid.n_graph) if grid is not None else (1, 1)
    (tr_s, tr_t), (va_s, va_t), (te_s, te_t) = _load_splits(args)
    say(f"[data] train {len(tr_s)}  val {len(va_s)}  test {len(te_s)}  tasks {tr_t.shape[1]}")
    workers = featurize_workers(args)
    say(f"[featurize] {native.describe(workers)}")
    train_ds, val_ds, test_ds = (MoleculeDataset.from_smiles(s, t, args.num_shells, workers)
                                 for s, t in ((tr_s, tr_t), (va_s, va_t), (te_s, te_t)))
    say(f"[featurize] kept train {len(train_ds)}/{len(tr_s)}  val {len(val_ds)}/{len(va_s)}  "
        f"test {len(test_ds)}/{len(te_s)}")
    pipe = PreprocessingPipeline(_preprocessing_config(args))
    pipe.fit(train_ds.atomic_numbers(), train_ds.targets)
    train_ds, val_ds, test_ds = (
        ds.with_targets(pipe.transform(ds.atomic_numbers(), ds.targets))
        for ds in (train_ds, val_ds, test_ds)
    )
    if grid is None:
        train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed)
    else:
        # this rank's shard of every step; validation and test stay whole
        train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed,
                                   stack_devices=n_data, halo_shards=n_graph,
                                   rank=(grid.data.index, grid.graph.index))
    return {"train": train_loader, "val": BatchLoader(val_ds, args.batch_size * n_data),
            "test": BatchLoader(test_ds, args.batch_size * n_data), "pipe": pipe,
            "num_tasks": train_ds.num_tasks,
            "target_columns": args.multi_target_list or [args.target_column],
            "splits": [("train", train_ds), ("val", val_ds), ("test", test_ds)], "files": []}


def _streaming_data(args: argparse.Namespace, grid: Optional[mesh.Grid], say) -> Dict[str, Any]:
    """The ``--iterable_dataset`` files (built by :func:`build_hdf5`) and
    their streaming loaders."""
    from .data.hdf5 import HDF5BatchLoader, HDF5MoleculeDataset

    n_data, n_graph = (grid.n_data, grid.n_graph) if grid is not None else (1, 1)
    files = [HDF5MoleculeDataset(p) for p in _hdf5_paths(args)]
    train_h5, val_h5, test_h5 = files
    if train_h5.preprocessing_state is None:
        raise ValueError(f"{args.train_hdf5} lacks preprocessing metadata; rebuild it with "
                         "this framework (silent dummy-stat fallbacks are not supported)")
    say(f"[hdf5] train {len(train_h5)}  val {len(val_h5)}  test {len(test_h5)}  "
        f"tasks {train_h5.num_tasks}")
    if grid is None:
        train_loader = HDF5BatchLoader(train_h5, args.batch_size, shuffle=True, seed=args.seed)
    else:
        train_loader = HDF5BatchLoader(train_h5, args.batch_size, shuffle=True, seed=args.seed,
                                       stack_devices=n_data, halo_shards=n_graph,
                                       rank=(grid.data.index, grid.graph.index))
    return {"train": train_loader, "val": HDF5BatchLoader(val_h5, args.batch_size * n_data),
            "test": HDF5BatchLoader(test_h5, args.batch_size * n_data),
            "pipe": PreprocessingPipeline.from_state_dict(train_h5.preprocessing_state),
            "num_tasks": train_h5.num_tasks,
            "target_columns": (train_h5.target_columns or args.multi_target_list
                               or [args.target_column]),
            "splits": None, "files": files}


def run_training(args: argparse.Namespace, grid: Optional[mesh.Grid] = None) -> Dict[str, Any]:
    """Train, test and save; with ``grid``, this rank's part of a run over
    the rank grid (module docstring)."""
    t_start = time.time()
    device = grid.device if grid is not None else resolve_device(args.device)
    primary = grid is None or grid.rank == 0
    say = print if primary else (lambda *a, **k: None)
    data = (_streaming_data if args.iterable_dataset else _in_memory_data)(args, grid, say)
    pipe, num_tasks = data["pipe"], data["num_tasks"]
    train_loader, val_loader, test_loader = data["train"], data["val"], data["test"]

    cfg = gnn_config_from_args(args, num_tasks)
    model = GNN(cfg)
    flat = init_params(cfg, args.seed)
    if args.transfer_learning:
        flat, _, _ = transfer_params(load_artifact(args.transfer_learning).params, flat)
    model.load_state_dict(params_from_flax(flat))
    model.to(device)
    tc = train_config_from_args(args)
    counts = count_parameters(model, train_mask(model, tc.freeze_patterns, tc.unfreeze_patterns))
    say(f"[model] {counts['total_parameters']:,} parameters "
        f"({counts['trainable_parameters']:,} trainable) on {device}")
    tracker = create_tracker(args) if primary else None
    checkpointer = TrainCheckpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    result = train(model, train_loader, val_loader, tc, device=device, seed=args.seed,
                   pipeline=pipe, tracker=tracker, checkpointer=checkpointer,
                   checkpoint_every=args.checkpoint_every, grid=grid)

    model.eval()
    test_metrics = evaluate(model, test_loader, device, config=tc, pipeline=pipe, grid=grid)
    say(f"[test] loss {test_metrics['loss']:.5f}  mae {test_metrics['mae']:.5f}  "
        f"rmse {test_metrics['rmse']:.5f}  r2 {test_metrics['r2']:.4f}")
    summary = {
        "best_val_loss": result.best_val_loss,
        "best_epoch": result.best_epoch,
        "test_metrics": test_metrics,
        "history": result.history,
        "avg_epoch_seconds": result.avg_epoch_seconds,
    }
    if not primary:
        for h5 in data["files"]:
            h5.close()
        summary["total_seconds"] = time.time() - t_start
        return summary
    save_artifact(
        args.model_save_path, params_to_flax(result.state_dict, cfg), cfg, pipe,
        extra={
            "task_type": args.task_type,
            "target_columns": data["target_columns"],
            "best_val_loss": result.best_val_loss,
            "best_epoch": result.best_epoch,
            "test_metrics": {k: v for k, v in test_metrics.items() if not isinstance(v, dict)},
            "max_hops": args.num_shells,
        },
    )
    print(f"[artifact] saved to {args.model_save_path}")
    if args.experiment_config:
        save_experiment_config(args, args.experiment_config)
    if args.save_embeddings:
        if data["splits"] is None:
            print("[embeddings] not written: --iterable_dataset training writes none "
                  "(as the JAX runner); serve the HDF5 files with --save_embeddings")
        else:
            extract_embeddings(args, model, device, data["splits"])
    if args.output_partial_charges and args.use_partial_charges:
        charges, mol_idx = extract_partial_charges(model, test_loader, device)
        np.savez(args.output_partial_charges, charges=charges, molecule_index=mol_idx)
        print(f"[charges] saved to {args.output_partial_charges}")
    for h5 in data["files"]:
        h5.close()
    summary["total_seconds"] = time.time() - t_start
    with open(args.model_save_path + ".summary.json", "w") as f:
        json.dump(summary, f, indent=2, default=str)
    tracker.summary({"best_val_loss": result.best_val_loss,
                     **{f"test_{k}": v for k, v in test_metrics.items() if not isinstance(v, dict)}})
    tracker.finish()
    return summary


def extract_embeddings(args: argparse.Namespace, model: GNN, device: torch.device,
                       named_datasets) -> None:
    """Each split's molecule embeddings (and with
    ``--include_atom_embeddings`` its atoms' and their molecule index) and
    SMILES, one HDF5 group per split, in ``--embeddings_output_path`` (the
    JAX ``_extract_embeddings``)."""
    import h5py

    with h5py.File(args.embeddings_output_path, "w") as f:
        for name, ds in named_datasets:
            res = predict(model, BatchLoader(ds, args.batch_size), device, return_embeddings=True)
            grp = f.create_group(name)
            grp.create_dataset("mol_embeddings", data=res["mol_embeddings"])
            grp.create_dataset("smiles", data=np.array(ds.smiles,
                                                       dtype=h5py.special_dtype(vlen=str)))
            if args.include_atom_embeddings:
                grp.create_dataset("atom_embeddings", data=res["atom_embeddings"])
                grp.create_dataset("atom_mol_index", data=res["atom_mol_index"])
    print(f"[embeddings] saved to {args.embeddings_output_path}")


def check_data_consistency(args: argparse.Namespace) -> None:
    """Raise before any work starts when an input the run needs is missing."""
    if args.is_inference:
        for p, what in ((args.inference_csv, "inference CSV"),
                        (args.inference_hdf5, "inference HDF5")):
            if p and not os.path.exists(p):
                raise ValueError(f"{what} not found: {p}")
        # save_artifact appends .npz to a path without it
        if not (os.path.exists(args.model_save_path)
                or os.path.exists(args.model_save_path + ".npz")):
            raise ValueError(f"model artifact not found: {args.model_save_path}")
        return
    if args.data_path:
        if args.train_data or args.val_data or args.test_data:
            raise ValueError("--data_path and individual --train_data/--val_data/--test_data "
                             "are mutually exclusive")
        if not os.path.exists(args.data_path):
            raise ValueError(f"data file not found: {args.data_path}")
        return
    for p, name in zip((args.train_data, args.val_data, args.test_data), ("train", "val", "test")):
        if not os.path.exists(p):
            raise ValueError(f"{name} data file not found: {p}")


def print_final_summary(summary: Dict[str, Any], args: argparse.Namespace) -> None:
    """Human-readable end-of-experiment report."""
    nan = float("nan")
    tm = summary.get("test_metrics", {})
    lines = [
        "=" * 70,
        "experiment complete",
        f"  best val loss   {summary.get('best_val_loss', nan):.6f} "
        f"(epoch {summary.get('best_epoch')})",
        f"  test            loss {tm.get('loss', nan):.6f}  mae {tm.get('mae', nan):.6f}  "
        f"rmse {tm.get('rmse', nan):.6f}  r2 {tm.get('r2', nan):.4f}",
        f"  wall time       {summary.get('total_seconds', 0.0):.1f}s "
        f"({summary.get('avg_epoch_seconds', 0.0):.1f}s/epoch)",
        f"  artifact        {args.model_save_path}",
    ]
    per = tm.get("per_task")
    cols = args.multi_target_list
    if per and cols:
        lines.append("  per-task:")
        for i, col in enumerate(cols[: len(per["mae"])]):
            lines.append(f"    {col:>16s}  mae {per['mae'][i]:.6f}  "
                         f"rmse {per['rmse'][i]:.6f}  r2 {per['r2'][i]:.4f}")
    lines.append("=" * 70)
    print("\n".join(lines))


def _rank_main(rank: int, args: argparse.Namespace, address: str, world: int,
               out_dir: Optional[str]) -> Dict[str, Any]:
    """One rank of a run over the rank grid: join the process group, build
    the grid, train; rank 0 leaves its summary in ``out_dir`` when given."""
    n_data, n_graph = _parallel_from_args(args)
    resolve_device(args.device)
    device = mesh.local_rank_device(rank, args.device)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = mesh.choose_backend(device, local_world)
    per_card = math.ceil(local_world / torch.cuda.device_count()) if device.type == "cuda" else 0
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_world))
    multihost.initialize(address, world, rank, backend, device)
    try:
        if args.iterable_dataset and out_dir is None:
            # under torchrun every rank runs the CLI: rank 0 builds the files
            if rank == 0:
                build_hdf5(args)
            multihost.sync()
        grid = mesh.make_grid(n_data, n_graph, device, backend)
        if rank == 0:
            where = f"{per_card} rank(s) per card" if per_card else "on the CPU"
            print(f"[parallel] grid {n_data} x {n_graph} (data x graph), {world} ranks, "
                  f"backend {backend}, {where}", flush=True)
        summary = run_training(args, grid)
        if rank == 0 and out_dir is not None:
            with open(os.path.join(out_dir, "summary.pkl"), "wb") as f:
                pickle.dump(summary, f)
        multihost.sync()
    finally:
        multihost.shutdown()
    return summary


def _launch_ranks(args: argparse.Namespace, world: int) -> Dict[str, Any]:
    """Run the rank grid: as one rank under torchrun, else start every rank
    here (torch.multiprocessing, spawn) and return rank 0's summary.  The
    spawned ranks meet at a ``file://`` rendezvous in their temporary
    directory: a free TCP port read here and bound later by rank 0 could be
    taken by another process in between."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        address = f"{os.environ.get('MASTER_ADDR', 'localhost')}:{os.environ['MASTER_PORT']}"
        return _rank_main(int(os.environ["RANK"]), args, address, world, None)
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="aimnet-ranks-")
    try:
        rendezvous = f"file://{os.path.join(out_dir, 'rendezvous')}"
        mp.spawn(_rank_main, args=(args, rendezvous, world, out_dir), nprocs=world, join=True)
        with open(os.path.join(out_dir, "summary.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main_runner(args: argparse.Namespace) -> Dict[str, Any]:
    """Serve or train, as ``args`` (``cli.parse_arguments``) says."""
    primary = int(os.environ.get("RANK", 0)) == 0
    for w in validate_args(args):
        if primary:
            print(f"[warning] {w}")
    setup_paths(args)
    check_data_consistency(args)
    if args.is_inference:
        from .inference.engine import inference_main

        return inference_main(args)
    n_data, n_graph = _parallel_from_args(args)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.iterable_dataset and not (torchrun and n_data * n_graph > 1):
        build_hdf5(args)  # before the ranks start (under torchrun: _rank_main)
    if n_data * n_graph > 1:
        summary = _launch_ranks(args, n_data * n_graph)
    else:
        summary = run_training(args)
    if primary:
        print_final_summary(summary, args)
    return summary


def main(args: argparse.Namespace) -> Dict[str, Any]:
    """The command line's run (the JAX ``runner.main``): a hyperparameter
    search with ``--hyperparameter_file`` and ``--num_trials`` > 1, else
    :func:`main_runner`."""
    if args.hyperparameter_file and args.num_trials > 1:
        from .hyperopt import run_hyperparameter_optimization

        return run_hyperparameter_optimization(args)
    return main_runner(args)
