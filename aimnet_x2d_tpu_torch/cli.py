"""Command line of the port: train a model, or serve a saved one over a
CSV of SMILES.

    # train (featurize, split, fit preprocessing, train, test, save)
    python -m aimnet_x2d_tpu_torch.cli --data_path train.csv \\
        --multi_target_columns a,b,c --task_type multitask --mixed_precision \\
        --epochs 50 --batch_size 2048 --model_save_path model.npz
    # serve
    python -m aimnet_x2d_tpu_torch.cli --inference_csv mols.csv \\
        --model_save_path model.npz --inference_output preds.csv

The flags are those of the JAX package's CLI that the port supports, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions of
the kernels).  Flags of features that are later slices of the port
(transfer learning, freezing, layer-wise LR decay, checkpoints, HDF5
streaming, several devices, trackers, embedding output, MC-dropout and
evidential serving) are accepted and raise NotImplementedError when set.
Partial charges and stereochemistry (``--use_partial_charges``,
``--use_stereochemistry``, ``--output_partial_charges``) are supported.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Sequence

# flag -> value that means "not used"; any other value raises
_LATER = {
    "transfer_learning": None, "freeze_pretrained": False, "freeze_layers": None,
    "unfreeze_layers": None, "layer_wise_lr_decay": False, "checkpoint_dir": None,
    "iterable_dataset": False, "num_devices": None, "graph_shards": 1, "enable_wandb": False,
    "save_embeddings": False, "hyperparameter_file": None, "true_multi_hop": False,
    "mc_samples": 0, "inference_hdf5": None,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    g = p.add_argument_group("Data")
    g.add_argument("--data_path", type=str, default=None)
    g.add_argument("--train_data", type=str, default=None)
    g.add_argument("--val_data", type=str, default=None)
    g.add_argument("--test_data", type=str, default=None)
    g.add_argument("--train_split", type=float, default=0.8)
    g.add_argument("--val_split", type=float, default=0.1)
    g.add_argument("--test_split", type=float, default=0.1)
    g.add_argument("--smiles_column", type=str, default="smiles")
    g.add_argument("--target_column", type=str, default="target")
    g.add_argument("--multi_target_columns", type=str, default=None,
                   help="comma-separated target column names for multitask")
    g.add_argument("--iterable_dataset", action="store_true")

    g = p.add_argument_group("Model")
    g.add_argument("--hidden_dim", type=int, default=512)
    g.add_argument("--num_shells", type=int, default=3)
    g.add_argument("--num_message_passing_layers", type=int, default=3)
    g.add_argument("--embedding_dim", type=int, default=64)
    g.add_argument("--ffn_hidden_dim", type=int, default=None)
    g.add_argument("--ffn_num_layers", type=int, default=3)
    g.add_argument("--ffn_dropout", type=float, default=0.05)
    g.add_argument("--pooling_type", type=str, default="attention",
                   choices=["attention", "mean", "max", "sum"])
    g.add_argument("--attention_num_heads", type=int, default=4)
    g.add_argument("--attention_temperature", type=float, default=1.0)
    g.add_argument("--shell_conv_num_mlp_layers", type=int, default=2)
    g.add_argument("--shell_conv_dropout", type=float, default=0.05)
    g.add_argument("--activation_type", type=str, default="silu",
                   choices=["relu", "leakyrelu", "elu", "gelu", "silu"])
    g.add_argument("--use_partial_charges", action="store_true")
    g.add_argument("--use_stereochemistry", action="store_true")
    g.add_argument("--true_multi_hop", action="store_true")

    g = p.add_argument_group("Training")
    g.add_argument("--learning_rate", type=float, default=0.00025)
    g.add_argument("--epochs", type=int, default=50)
    g.add_argument("--batch_size", type=int, default=64)
    g.add_argument("--early_stopping", action="store_true")
    g.add_argument("--patience", type=int, default=25)
    g.add_argument("--task_type", type=str, default="regression",
                   choices=["regression", "multitask"])
    g.add_argument("--loss_function", type=str, default="l1", choices=["l1", "mse", "evidential"])
    g.add_argument("--multitask_weights", type=str, default=None)
    g.add_argument("--evidential_lambda", type=float, default=1.0)
    g.add_argument("--lr_scheduler", type=str, default="ReduceLROnPlateau",
                   choices=["ReduceLROnPlateau", "CosineAnnealingLR", "StepLR", "ExponentialLR"])
    g.add_argument("--lr_reduce_factor", type=float, default=0.5)
    g.add_argument("--lr_patience", type=int, default=10)
    g.add_argument("--lr_cosine_t_max", type=int, default=10)
    g.add_argument("--lr_step_size", type=int, default=10)
    g.add_argument("--lr_step_gamma", type=float, default=0.1)
    g.add_argument("--lr_exp_gamma", type=float, default=0.95)
    g.add_argument("--calculate_sae", action="store_true")
    g.add_argument("--sae_subtasks", type=str, default=None)
    g.add_argument("--mixed_precision", action="store_true", help="bf16 compute, fp32 weights")
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--model_save_path", type=str, default="gnn_model.npz")
    for flag in ("transfer_learning", "freeze_layers", "unfreeze_layers", "checkpoint_dir",
                 "hyperparameter_file", "output_partial_charges"):
        g.add_argument(f"--{flag}", type=str, default=None)
    for flag in ("freeze_pretrained", "layer_wise_lr_decay", "enable_wandb", "save_embeddings"):
        g.add_argument(f"--{flag}", action="store_true")
    g.add_argument("--num_devices", type=int, default=None)
    g.add_argument("--graph_shards", type=int, default=1)

    g = p.add_argument_group("Inference")
    g.add_argument("--inference_csv", type=str, default=None)
    g.add_argument("--inference_hdf5", type=str, default=None)
    g.add_argument("--inference_output", type=str, default="predictions.csv")
    g.add_argument("--inference_mode", type=str, default="deterministic",
                   choices=["deterministic", "mc_dropout", "evidential"])
    g.add_argument("--mc_samples", type=int, default=0)
    g.add_argument("--stream_chunk_size", type=int, default=1000)
    g.add_argument("--stream_batch_size", type=int, default=None,
                   help="molecules per batch (default: 2048 on cuda, 64 on cpu)")

    g = p.add_argument_group("System")
    g.add_argument("--device", type=str, default="cuda")
    g.add_argument("--precompute_num_workers", type=int, default=None)
    g.add_argument("--num_workers", type=int, default=4)
    return p


def _csv_list(value: Optional[str], cast) -> Optional[List]:
    if value is None:
        return None
    return [cast(x) for x in value.split(",") if x.strip() != ""]


def parse_arguments(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    for flag, unused in _LATER.items():
        if getattr(args, flag) != unused:
            raise NotImplementedError(f"--{flag} is not ported yet")
    if args.inference_mode != "deterministic":
        raise NotImplementedError(f"--inference_mode {args.inference_mode} is not ported yet")
    args.multi_target_list = _csv_list(args.multi_target_columns, str)
    args.sae_subtask_list = _csv_list(args.sae_subtasks, int)
    args.multitask_weight_list = _csv_list(args.multitask_weights, float)
    if args.ffn_hidden_dim is None:
        args.ffn_hidden_dim = args.hidden_dim
    args.is_inference = args.inference_csv is not None
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_arguments(argv)
    if args.is_inference:
        from .inference.engine import inference_main

        return inference_main(args)
    from .runner import run_training

    return run_training(args)


if __name__ == "__main__":
    main()
    sys.exit(0)
