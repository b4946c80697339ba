"""Inference dispatch (counterpart of aimnet_x2d_tpu/inference/engine.py).

Under ``torchrun`` / ``python -m torch.distributed.run`` with several ranks
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) each rank
joins the process group (gloo: serving exchanges only host objects), takes
its card (``cuda:{local rank % cards}``, so ranks share a card when there
are fewer cards than ranks) and serves its line range of the CSV
(``StreamingInferencePipeline.run_csv``, or ``run_hdf5`` for
``--inference_hdf5``: its range of the file's molecules); rank 0 merges.
Otherwise serving runs in this one process: ``--num_devices`` and
``--graph_shards`` are accepted, as the JAX CLI serves before it builds a
mesh, with a note that serving spreads over ranks only under torchrun.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

from ..parallel import mesh, multihost
from ..utils.device import resolve_device
from .pipeline import StreamingInferencePipeline


def _torchrun_world() -> int:
    """The rank count torchrun started (1 outside torchrun)."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return 1


def inference_main(args: argparse.Namespace) -> Dict[str, Any]:
    device = resolve_device(args.device)
    world = _torchrun_world()
    joined = False
    if world > 1:
        rank = int(os.environ["RANK"])
        device = mesh.local_rank_device(rank, args.device)
        address = f"{os.environ.get('MASTER_ADDR', 'localhost')}:{os.environ['MASTER_PORT']}"
        multihost.initialize(address, world, rank, "gloo", device)
        joined = True
    elif (args.num_devices or 1) * (args.graph_shards or 1) > 1:
        print("[parallel] serving in one process: --num_devices / --graph_shards spread "
              "serving over ranks only under torchrun (python -m torch.distributed.run "
              "--nproc_per_node N -m aimnet_x2d_tpu_torch.cli ...)", flush=True)
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
    try:
        pipeline = StreamingInferencePipeline(
            artifact_path=args.model_save_path,
            chunk_size=chunk,
            batch_size=batch,
            device=device,
            inference_mode=args.inference_mode or "deterministic",
            mc_samples=args.mc_samples,
            num_workers=args.num_workers,
            save_embeddings=args.save_embeddings,
            embeddings_output_path=args.embeddings_output_path,
            include_atom_embeddings=args.include_atom_embeddings,
        )
        if args.inference_csv:
            return pipeline.run_csv(
                args.inference_csv, args.inference_output, smiles_column=args.smiles_column
            )
        if args.inference_hdf5:
            return pipeline.run_hdf5(args.inference_hdf5, args.inference_output)
        raise ValueError("inference requires --inference_csv or --inference_hdf5")
    finally:
        if joined:
            multihost.shutdown()
