"""Training driver (counterpart of aimnet_x2d_tpu/runner.py::_run_training).

Loads the CSV(s), splits with the seeded two-stage split, featurizes, fits
the SAE + standard-scaling pipeline on the train split and transforms every
split, builds the binned loaders (the train loader shuffles per epoch),
trains, evaluates the best parameters on the test split, and saves the
artifact (flax-named ``.npz``, loadable by both packages) with the same
``extra`` fields as the JAX package and a ``.summary.json`` beside it; with
``--output_partial_charges`` (and partial charges on) it also writes the
test split's per-atom charges as ``.npz`` (``charges``, ``molecule_index``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict

import numpy as np

from .checkpoint import init_params, params_from_flax, params_to_flax, save_artifact
from .data.dataset import BatchLoader, MoleculeDataset
from .data.io import load_dataset, split_dataset
from .data.preprocessing import PreprocessingConfig, PreprocessingPipeline
from .models.gnn import GNN, GNNConfig
from .training.evaluator import evaluate
from .training.predictor import extract_partial_charges
from .training.trainer import TrainConfig, train
from .utils.device import resolve_device


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
        compute_dtype="bfloat16" if args.mixed_precision else "float32",
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


def run_training(args: argparse.Namespace) -> Dict[str, Any]:
    t_start = time.time()
    device = resolve_device(args.device)
    (tr_s, tr_t), (va_s, va_t), (te_s, te_t) = _load_splits(args)
    num_tasks = tr_t.shape[1]
    print(f"[data] train {len(tr_s)}  val {len(va_s)}  test {len(te_s)}  tasks {num_tasks}")
    train_ds = MoleculeDataset.from_smiles(tr_s, tr_t, args.num_shells)
    val_ds = MoleculeDataset.from_smiles(va_s, va_t, args.num_shells)
    test_ds = MoleculeDataset.from_smiles(te_s, te_t, args.num_shells)
    print(f"[featurize] kept train {len(train_ds)}/{len(tr_s)}  val {len(val_ds)}/{len(va_s)}  "
          f"test {len(test_ds)}/{len(te_s)}")

    pipe = PreprocessingPipeline(PreprocessingConfig(
        apply_sae=args.calculate_sae, sae_subtasks=args.sae_subtask_list,
        apply_standard_scaling=True, task_type=args.task_type,
    ))
    pipe.fit(train_ds.atomic_numbers(), train_ds.targets)
    train_ds, val_ds, test_ds = (
        ds.with_targets(pipe.transform(ds.atomic_numbers(), ds.targets))
        for ds in (train_ds, val_ds, test_ds)
    )
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True, seed=args.seed)
    val_loader = BatchLoader(val_ds, args.batch_size)
    test_loader = BatchLoader(test_ds, args.batch_size)

    cfg = gnn_config_from_args(args, num_tasks)
    model = GNN(cfg)
    model.load_state_dict(params_from_flax(init_params(cfg, args.seed)))
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] {n_params:,} parameters on {device}")
    tc = train_config_from_args(args)
    result = train(model, train_loader, val_loader, tc, device=device, seed=args.seed,
                   pipeline=pipe)

    model.eval()
    test_metrics = evaluate(model, test_loader, device, config=tc, pipeline=pipe)
    print(f"[test] loss {test_metrics['loss']:.5f}  mae {test_metrics['mae']:.5f}  "
          f"rmse {test_metrics['rmse']:.5f}  r2 {test_metrics['r2']:.4f}")
    save_artifact(
        args.model_save_path, params_to_flax(result.state_dict, cfg), cfg, pipe,
        extra={
            "task_type": args.task_type,
            "target_columns": args.multi_target_list or [args.target_column],
            "best_val_loss": result.best_val_loss,
            "best_epoch": result.best_epoch,
            "test_metrics": {k: v for k, v in test_metrics.items() if not isinstance(v, dict)},
            "max_hops": args.num_shells,
        },
    )
    print(f"[artifact] saved to {args.model_save_path}")
    if args.output_partial_charges and args.use_partial_charges:
        charges, mol_idx = extract_partial_charges(model, test_loader, device)
        np.savez(args.output_partial_charges, charges=charges, molecule_index=mol_idx)
        print(f"[charges] saved to {args.output_partial_charges}")
    summary = {
        "best_val_loss": result.best_val_loss,
        "best_epoch": result.best_epoch,
        "test_metrics": test_metrics,
        "history": result.history,
        "avg_epoch_seconds": result.avg_epoch_seconds,
        "total_seconds": time.time() - t_start,
    }
    with open(args.model_save_path + ".summary.json", "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary
