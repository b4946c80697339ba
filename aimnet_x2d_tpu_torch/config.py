"""Argument validation, output directories and the experiment record
(counterpart of aimnet_x2d_tpu/config.py).  The rank checks of
``--num_devices`` / ``--graph_shards``: JAX counts ``jax.devices()``; here
each rank is a process, so for training under ``torchrun`` the world size
must be ``num_devices x graph_shards`` (1 without the flags: torchrun with
several ranks and no grid would run the single-rank trainer in each, all
writing the same artifact), and otherwise the CLI starts that many ranks
itself (several may share one card).  Serving takes its ranks from
torchrun whatever the flags say (inference/engine.py)."""

from __future__ import annotations

import argparse
import datetime
import os
from typing import List


class ValidationError(ValueError):
    pass


def validate_args(args: argparse.Namespace) -> List[str]:
    """Cross-field checks; raises ValidationError on fatal problems and
    returns a list of warnings."""
    errors: List[str] = []
    warnings: List[str] = []

    if not args.is_inference:
        has_single = args.data_path is not None
        has_splits = all(x is not None for x in (args.train_data, args.val_data, args.test_data))
        if not has_single and not has_splits:
            errors.append("Provide --data_path or all of --train_data/--val_data/--test_data")
        if has_single and abs(args.train_split + args.val_split + args.test_split - 1.0) > 1e-6:
            errors.append("train/val/test splits must sum to 1.0")

    if args.task_type == "multitask":
        if args.multi_target_list is None or len(args.multi_target_list) < 2:
            errors.append("multitask requires --multi_target_columns with ≥2 columns")
        if args.multitask_weight_list is not None and args.multi_target_list is not None:
            if len(args.multitask_weight_list) != len(args.multi_target_list):
                errors.append("--multitask_weights length must match target columns")
        if args.sae_subtask_list is not None and args.multi_target_list is not None:
            bad = [s for s in args.sae_subtask_list if s < 0 or s >= len(args.multi_target_list)]
            if bad:
                errors.append(f"--sae_subtasks out of range: {bad}")
    elif args.sae_subtask_list is not None:
        warnings.append("--sae_subtasks ignored for single-task regression")

    if args.iterable_dataset and not args.is_inference:
        if not (args.train_hdf5 and args.val_hdf5 and args.test_hdf5):
            errors.append("--iterable_dataset requires train/val/test HDF5 paths")

    for name in ("learning_rate", "lr_reduce_factor", "lr_step_gamma", "lr_exp_gamma"):
        v = getattr(args, name)
        if not (0 < v <= (1.0 if name != "learning_rate" else 10.0)):
            errors.append(f"--{name} must be in (0, 1] (got {v})")
    for name in ("epochs", "batch_size", "num_shells", "num_message_passing_layers",
                 "hidden_dim", "embedding_dim"):
        if getattr(args, name) <= 0:
            errors.append(f"--{name} must be positive")

    if args.inference_mode == "mc_dropout" and args.mc_samples <= 0:
        errors.append("--inference_mode mc_dropout requires --mc_samples > 0")
    if args.mc_samples > 0 and args.mc_samples < 2:
        warnings.append("--mc_samples < 2 gives no spread estimate")

    if args.use_partial_charges and int(0.3 * args.hidden_dim) < 2:
        errors.append("--use_partial_charges needs hidden_dim ≥ 7 (x_other ≥ 2)")

    g_shards = 1 if args.graph_shards is None else args.graph_shards
    if g_shards < 1:
        errors.append("--graph_shards must be ≥ 1")
    if args.num_devices is not None and args.num_devices < 1:
        errors.append("--num_devices must be ≥ 1")
    if g_shards > 1 and args.true_multi_hop:
        errors.append("--graph_shards is only implemented for the reference's hop-collapse "
                      "semantics (drop --true_multi_hop)")
    world = os.environ.get("WORLD_SIZE")
    need = (args.num_devices or 1) * max(g_shards, 1)
    if (not args.is_inference and world is not None and "RANK" in os.environ
            and int(world) != need):
        errors.append(f"--num_devices {args.num_devices or 1} x --graph_shards {g_shards} needs "
                      f"{need} ranks, torchrun started {world}")

    if errors:
        raise ValidationError("; ".join(errors))
    return warnings


def setup_paths(args: argparse.Namespace) -> None:
    """Create the directory of every output location."""
    paths = [args.model_save_path, args.inference_output, args.output_partial_charges]
    if args.save_embeddings:
        paths.append(args.embeddings_output_path)
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
    if args.train_hdf5:
        paths += [args.train_hdf5, args.val_hdf5, args.test_hdf5]
    for p in paths:
        if p:
            os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)


def save_experiment_config(args: argparse.Namespace, path: str) -> None:
    """The resolved arguments, with metadata, as YAML."""
    import yaml

    payload = {
        "metadata": {
            "created": datetime.datetime.now().isoformat(),
            "framework": "aimnet_x2d_tpu_torch",
        },
        "config": {k: v for k, v in sorted(vars(args).items()) if not k.startswith("_")},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(payload, f, default_flow_style=False)
