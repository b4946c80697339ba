"""Seeding (counterpart of aimnet_x2d_tpu/utils/random.py).

Seeds Python's and numpy's global generators for host-side code that reads
them, and returns a ``torch.Generator`` seeded alike on the resolved device
in place of JAX's root PRNG key.  The port's own code does not read the
global generators: it seeds each of its generators explicitly.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .device import resolve_device


def set_seed(seed: int = 42, device: "str | torch.device" = "cuda") -> torch.Generator:
    """Seed ``random`` and ``np.random`` with ``seed`` and return a
    generator on ``device`` seeded with it; raises, seeding nothing, when
    CUDA is asked for and there is no card (``resolve_device``)."""
    dev = resolve_device(device)
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=dev).manual_seed(seed)
