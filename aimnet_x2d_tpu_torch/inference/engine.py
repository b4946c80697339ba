"""Inference dispatch (counterpart of aimnet_x2d_tpu/inference/engine.py)."""

from __future__ import annotations

import argparse
from typing import Any, Dict

from ..utils.device import resolve_device
from .pipeline import StreamingInferencePipeline


def inference_main(args: argparse.Namespace) -> Dict[str, Any]:
    device = resolve_device(args.device)
    batch = args.stream_batch_size
    chunk = args.stream_chunk_size
    if batch is None:
        if device.type == "cuda":
            # big batches fill the binned layout and amortize launches;
            # chunks hold a few batches so featurization stays ahead
            batch = 2048
            chunk = max(chunk, 4 * batch)
        else:
            batch = 64
    pipeline = StreamingInferencePipeline(
        artifact_path=args.model_save_path,
        chunk_size=chunk,
        batch_size=batch,
        device=device,
        inference_mode=args.inference_mode or "deterministic",
        mc_samples=args.mc_samples,
        num_workers=args.num_workers,
    )
    return pipeline.run_csv(
        args.inference_csv, args.inference_output, smiles_column=args.smiles_column
    )
