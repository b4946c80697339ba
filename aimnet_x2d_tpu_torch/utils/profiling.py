"""Profiling and throughput instrumentation (counterpart of
aimnet_x2d_tpu/utils/profiling.py).

A ``torch.profiler`` trace context manager, a step timer that waits for the
device before it reads the clock, and the edges/s meter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (the host, and the card
    when there is one) and write its trace into ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json``, viewable in TensorBoard or
    Perfetto (JAX: ``jax.profiler`` start/stop_trace)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _devices(result, out: set) -> set:
    """The CUDA devices of every tensor in ``result`` (tensors, sequences,
    mappings and dataclasses of them, as ``jax.block_until_ready`` takes a
    pytree)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            out.add(result.device)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _devices(v, out)
    elif isinstance(result, dict):
        for v in result.values():
            _devices(v, out)
    elif dataclasses.is_dataclass(result) and not isinstance(result, type):
        for f in dataclasses.fields(result):
            _devices(getattr(result, f.name), out)
    return out


class StepTimer:
    """Accumulates device-synchronized step timings and real edge counts."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._times: list = []
        self._edges: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None, num_real_edges: int = 0) -> float:
        """Stop timing, first waiting until the card has finished all its
        work when ``result`` holds a CUDA tensor (``torch.cuda.synchronize``
        of its device, JAX's ``block_until_ready``; CPU work is done when it
        returns); returns the step's seconds."""
        for dev in _devices(result, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        self._edges.append(num_real_edges)
        return dt

    @property
    def steps(self) -> int:
        return len(self._times)

    def summary(self, skip_warmup: int = 1) -> dict:
        t = np.array(self._times[skip_warmup:] or self._times)
        e = np.array(self._edges[skip_warmup:] or self._edges)
        total_t = float(t.sum()) if len(t) else 0.0
        return {
            "steps": int(len(t)),
            "mean_step_ms": float(t.mean() * 1e3) if len(t) else 0.0,
            "p50_step_ms": float(np.percentile(t, 50) * 1e3) if len(t) else 0.0,
            "edges_per_sec": float(e.sum() / total_t) if total_t > 0 else 0.0,
        }
