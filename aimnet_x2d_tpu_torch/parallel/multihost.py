"""Process-group utilities (counterpart of aimnet_x2d_tpu/parallel/multihost.py).

One process per rank.  ``initialize`` joins the default process group at a
``tcp://`` address, or a ``file://`` rendezvous, with the world size and
rank given (nothing on the machine announces a cluster); the helpers below
work on that group with host objects:

- ``process_index`` / ``process_count`` / ``is_primary``;
- ``allgather_numpy``: every rank's array, concatenated on axis 0, on every
  rank;
- ``broadcast_pyobj``: a picklable object from ``root`` to every rank;
- ``sync``: a barrier.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: str = "gloo", device: Optional[torch.device] = None) -> None:
    """Join the default process group: ``coordinator_address`` is
    ``host:port`` (``localhost:<free port>`` on one machine), or a rendezvous
    URL such as ``file://<path>`` (ranks of one machine; no port to claim).
    Under NCCL the rank's card becomes the current device first, as its
    object collectives need."""
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def allgather_numpy(x: np.ndarray) -> np.ndarray:
    """Every rank's ``x``, concatenated on axis 0 in rank order."""
    if not is_initialized():
        return np.asarray(x)
    parts: list = [None] * process_count()
    dist.all_gather_object(parts, np.asarray(x))
    return np.concatenate(parts, axis=0)


def broadcast_pyobj(obj: Any, root: int = 0) -> Any:
    """``obj`` of rank ``root`` on every rank."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def sync() -> None:
    """Barrier across ranks."""
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group (every rank, at the end of its run)."""
    if is_initialized():
        dist.destroy_process_group()
