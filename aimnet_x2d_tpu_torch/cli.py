"""Command line of the port: train a model, or serve a saved one over a
CSV of SMILES.

    # train (featurize, split, fit preprocessing, train, test, save)
    python -m aimnet_x2d_tpu_torch.cli --data_path train.csv \\
        --multi_target_columns a,b,c --task_type multitask --mixed_precision \\
        --epochs 50 --batch_size 2048 --model_save_path model.npz
    # serve (add --inference_mode mc_dropout --mc_samples 8, or
    # --inference_mode evidential for a model trained with --loss_function
    # evidential, for uncertainty columns)
    python -m aimnet_x2d_tpu_torch.cli --inference_csv mols.csv \\
        --model_save_path model.npz --inference_output preds.csv
    # fine-tune a trained model: new 12-target head, everything else frozen,
    # checkpoints every epoch (a rerun of the same command resumes)
    python -m aimnet_x2d_tpu_torch.cli --data_path tasks.csv ... \\
        --transfer_learning model.npz --freeze_pretrained \\
        --layer_wise_lr_decay --checkpoint_dir ckpt --checkpoint_every 1
    # several ranks: 2 data shards x 2 halo graph shards per step; the CLI
    # starts the 4 rank processes itself (or run it under torchrun with 4)
    python -m aimnet_x2d_tpu_torch.cli --data_path train.csv ... \\
        --num_devices 2 --graph_shards 2
    # serve over 2 ranks (each a contiguous part of the CSV; rank 0 merges)
    python -m torch.distributed.run --nproc_per_node 2 -m aimnet_x2d_tpu_torch.cli \\
        --inference_csv mols.csv --model_save_path model.npz --inference_output preds.csv
    # stream training from columnar HDF5 files (built from the CSV when
    # missing, preprocessing fit on train), then serve from an HDF5 file
    python -m aimnet_x2d_tpu_torch.cli --data_path train.csv ... --iterable_dataset \\
        --train_hdf5 tr.h5 --val_hdf5 va.h5 --test_hdf5 te.h5
    python -m aimnet_x2d_tpu_torch.cli --inference_hdf5 te.h5 --model_save_path model.npz
    # molecule (and atom) embeddings beside the predictions, or per split
    # after training: --save_embeddings [--include_atom_embeddings]
    #     --embeddings_output_path emb.h5
    # random search over a YAML space, 8 trials, best artifact kept
    python -m aimnet_x2d_tpu_torch.cli --data_path train.csv ... \\
        --hyperparameter_file example_hyperparams.yaml --num_trials 8

The flags are those of the JAX package's CLI, every one of them, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions of
the kernels): every pooling type, partial charges and stereochemistry
(``--output_partial_charges``), true per-hop aggregation
(``--true_multi_hop``), transfer learning, freeze and unfreeze patterns,
layer-wise LR decay, checkpoint/resume, wandb tracking and
``--experiment_config``, training over several ranks: ``--num_devices``
data shards per step, each split into ``--graph_shards`` halo graph shards
(runner.py starts the ranks; config 3 included), and
serving in every ``--inference_mode`` (deterministic, MC-dropout with
``--mc_samples``, evidential), over the ranks of ``torchrun`` when it runs
under it, HDF5 streaming (``--iterable_dataset``, ``--inference_hdf5``),
embedding output (``--save_embeddings``), hyperparameter search
(``--hyperparameter_file`` with ``--num_trials``) and
``--gradient_checkpointing``.  The HDF5 and embedding flags need ``h5py``,
which only they import; ``--shuffle_buffer_size`` is accepted and read
nowhere, as in the JAX package (its HDF5 loader shuffles blocks).
``--num_workers`` (and ``--precompute_num_workers`` for training) set the
native featurizer's threads.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Sequence

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
    g.add_argument("--iterable_dataset", action="store_true",
                   help="stream batches from columnar HDF5 files instead of memory")
    g.add_argument("--shuffle_buffer_size", type=int, default=1000)
    g.add_argument("--train_hdf5", type=str, default=None)
    g.add_argument("--val_hdf5", type=str, default=None)
    g.add_argument("--test_hdf5", type=str, default="test.h5")

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
    g.add_argument("--transfer_learning", type=str, default=None,
                   help="path to a pretrained artifact")
    g.add_argument("--freeze_pretrained", action="store_true")
    g.add_argument("--freeze_layers", type=str, default=None)
    g.add_argument("--unfreeze_layers", type=str, default=None)
    g.add_argument("--layer_wise_lr_decay", action="store_true")
    g.add_argument("--lr_decay_factor", type=float, default=0.8)
    g.add_argument("--checkpoint_dir", type=str, default=None,
                   help="periodic training checkpoints; a run resumes from the newest")
    g.add_argument("--checkpoint_every", type=int, default=10)
    g.add_argument("--output_partial_charges", type=str, default=None)
    g.add_argument("--num_devices", type=int, default=None)
    g.add_argument("--graph_shards", type=int, default=1)

    g = p.add_argument_group("Inference")
    g.add_argument("--inference_csv", type=str, default=None)
    g.add_argument("--inference_hdf5", type=str, default=None)
    g.add_argument("--inference_output", type=str, default="predictions.csv")
    g.add_argument("--inference_mode", type=str, default=None,
                   choices=["deterministic", "mc_dropout", "evidential"],
                   help="default: mc_dropout when --mc_samples > 0, else deterministic")
    g.add_argument("--mc_samples", type=int, default=0)
    g.add_argument("--stream_chunk_size", type=int, default=1000)
    g.add_argument("--stream_batch_size", type=int, default=None,
                   help="molecules per batch (default: 2048 on cuda, 64 on cpu)")
    g.add_argument("--save_embeddings", action="store_true")
    g.add_argument("--embeddings_output_path", type=str, default="embeddings.h5")
    g.add_argument("--include_atom_embeddings", action="store_true")

    g = p.add_argument_group("System")
    g.add_argument("--device", type=str, default="cuda")
    g.add_argument("--precompute_num_workers", type=int, default=None)
    g.add_argument("--num_workers", type=int, default=4)
    g.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute the message-passing layers in the backward pass")

    g = p.add_argument_group("Hyperparameter Optimization")
    g.add_argument("--hyperparameter_file", type=str, default=None,
                   help="YAML search space (with --num_trials > 1)")
    g.add_argument("--num_trials", type=int, default=1)

    g = p.add_argument_group("Logging & Tracking")
    g.add_argument("--enable_wandb", action="store_true")
    g.add_argument("--wandb_project", type=str, default="aimnet-x2d-tpu")
    g.add_argument("--wandb_entity", type=str, default=None)
    g.add_argument("--wandb_tags", type=str, default=None)
    g.add_argument("--experiment_config", type=str, default=None,
                   help="save the resolved configuration to this YAML path")
    return p


def _csv_list(value: Optional[str], cast) -> Optional[List]:
    if value is None:
        return None
    return [cast(x) for x in value.split(",") if x.strip() != ""]


def postprocess_arguments(args: argparse.Namespace) -> argparse.Namespace:
    """The derived fields (the JAX ``postprocess_arguments``): the list
    forms of the comma-separated flags, ``ffn_hidden_dim`` and
    ``precompute_num_workers`` from their sources when unset, and, when
    serving (``--inference_csv`` or ``--inference_hdf5``), the inference
    mode: MC-dropout with ``--mc_samples`` > 0, else deterministic.  A
    hyperparameter trial calls it again on its sampled arguments."""
    args.multi_target_list = _csv_list(args.multi_target_columns, str)
    args.sae_subtask_list = _csv_list(args.sae_subtasks, int)
    args.multitask_weight_list = _csv_list(args.multitask_weights, float)
    args.freeze_layer_list = _csv_list(args.freeze_layers, str)
    args.unfreeze_layer_list = _csv_list(args.unfreeze_layers, str)
    args.wandb_tag_list = _csv_list(args.wandb_tags, str)
    if args.ffn_hidden_dim is None:
        args.ffn_hidden_dim = args.hidden_dim
    if args.precompute_num_workers is None:
        args.precompute_num_workers = args.num_workers
    args.is_inference = args.inference_csv is not None or args.inference_hdf5 is not None
    if args.is_inference and args.inference_mode is None:
        args.inference_mode = "mc_dropout" if args.mc_samples > 0 else "deterministic"
    return args


def parse_arguments(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return postprocess_arguments(build_parser().parse_args(argv))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the command line: a hyperparameter search with
    ``--hyperparameter_file`` and ``--num_trials`` > 1 (hyperopt.py), else
    one run (runner.main_runner); returns its summary."""
    from .runner import main

    return main(parse_arguments(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
