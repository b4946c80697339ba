"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    Entry points default to ``cuda``.  When CUDA is asked for and this
    process has no usable card, raise: the port never carries on quietly
    on the CPU.  Pass ``device="cpu"`` to run the plain PyTorch versions
    of every kernel on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev
