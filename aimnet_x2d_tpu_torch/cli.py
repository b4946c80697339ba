"""Command line of the port: serve a saved model over a CSV of SMILES.

    python -m aimnet_x2d_tpu_torch.cli --inference_csv mols.csv \\
        --model_save_path model.npz --inference_output preds.csv

The flags are the inference flags of the JAX package's CLI, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions of
the kernels).  Training flags come with the training slice.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional, Sequence


def parse_arguments(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--inference_csv", type=str, required=True)
    p.add_argument("--model_save_path", type=str, required=True)
    p.add_argument("--inference_output", type=str, default="predictions.csv")
    p.add_argument("--smiles_column", type=str, default="smiles")
    p.add_argument("--stream_chunk_size", type=int, default=1000)
    p.add_argument("--stream_batch_size", type=int, default=None,
                   help="molecules per batch (default: 2048 on cuda, 64 on cpu)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from .inference.engine import inference_main

    return inference_main(parse_arguments(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
