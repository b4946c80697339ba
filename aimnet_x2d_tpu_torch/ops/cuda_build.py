"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``.  Builds happen on
first use, into ``build/kernels/`` at the repository root, one ``nvcc``
process per source, all started together.  A library's file name carries
a hash of its source and flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {
    "mp_stack": "mp_stack.cu",
    "mp_stack_bwd": "mp_stack_bwd.cu",
    "attnpool": "attnpool.cu",
    "wpool": "wpool.cu",
    "inject": "inject.cu",
    "fused_edge": "fused_edge.cu",
    "bin_pool": "bin_pool.cu",
    "mp_ext": "mp_ext.cu",
}
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    # the source and every shared header it may include
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None, verbose: bool = False) -> Dict[str, Path]:
    """Compile every named kernel library that is not built yet, in
    parallel; return the library paths.  ``verbose`` passes ``-Xptxas -v``
    and prints the compiler's report (registers, shared memory, spills)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists() and not verbose:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out_b, err_b = proc.communicate()
        if verbose:
            print(f"[build] {n}:\n{out_b.decode()}{err_b.decode()}", flush=True)
        if proc.returncode != 0:
            errors.append(f"{SOURCES[n]}: nvcc exit {proc.returncode}\n{err_b.decode()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, targets[n])
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        return lib


def check_cuda(what: str, dev, *named) -> None:
    """Raise unless each ``(name, tensor, align)`` lies on CUDA device
    ``dev``, is contiguous and starts on an ``align``-byte boundary."""
    for name, t, align in named:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: {name} must be on {dev}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{what}: {name} must be contiguous and {align}-byte aligned")


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
