"""The native C++ featurizer and batch builder, built and bound with ctypes
(counterpart of aimnet_x2d_tpu/chem/native.py).

The library is compiled from the repository's ``native/featurizer.cpp``
and ``native/batch_builder.cpp`` (unchanged, shared with the JAX package)
by ``g++`` with the flags of ``native/Makefile``, into ``build/native/`` at
the repository root, on first use and never at import.  Its file name
carries a hash of both sources and the flags, so an edited source is
rebuilt; a build writes a temporary file and renames it, under a file
lock, so processes that start together never load a half-written library.
Nothing is built into or loaded from ``native/``.

``compute_features_native`` has the signature and the output of the
pure-Python ``chem.featurize.compute_features`` (array for array, in the
same order, with the same processed SMILES); ``compute_features_batch``
featurizes a list in one call on C++ threads.  ctypes releases the GIL
during a call, so featurization overlaps other Python threads.

There is no silent fallback: a missing compiler or a failed build raises
with the compiler's error output.  The pure-Python featurizer runs only
when ``AIMNET_NO_NATIVE`` is set (the JAX package's switch), see
:func:`native_enabled`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..data.batching import MolFeatures

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
SOURCES = ("featurizer.cpp", "batch_builder.cpp")
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def native_enabled() -> bool:
    """False when ``AIMNET_NO_NATIVE`` is set: then the loaders featurize
    and collate with the pure-Python code."""
    return not os.environ.get("AIMNET_NO_NATIVE")


def describe(num_threads: int) -> str:
    """The featurizer a dataset build with ``num_threads`` runs, as the
    runner and the serving summary print it."""
    if native_enabled():
        return f"native C++ ({max(num_threads, 1)} threads)"
    return "pure-Python (AIMNET_NO_NATIVE set)"


def _target() -> Path:
    src = b"".join((NATIVE_DIR / s).read_bytes() for s in SOURCES)
    digest = hashlib.sha1(src + " ".join([CXX, *CXX_FLAGS]).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libaimnet_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; return its path.  Raises
    RuntimeError when the compiler is missing or fails."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build at a time across processes
        if out.exists():
            return out
        cxx = shutil.which(CXX)
        if cxx is None:
            raise RuntimeError(f"native library build failed: compiler {CXX!r} not found")
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native library build failed ({' '.join(cmd)}, exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _type_featurizer(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.aimnet_featurize.restype = ctypes.c_void_p
    lib.aimnet_featurize.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.aimnet_free.argtypes = [ctypes.c_void_p]
    for name in ("aimnet_num_atoms", "aimnet_total_charge", "aimnet_num_tet",
                 "aimnet_num_cis", "aimnet_num_trans"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    for name in ("aimnet_atom_features", "aimnet_atomic_numbers", "aimnet_tet",
                 "aimnet_cis", "aimnet_trans"):
        fn = getattr(lib, name)
        fn.restype = i32p
        fn.argtypes = [ctypes.c_void_p]
    lib.aimnet_num_edges.restype = ctypes.c_int
    lib.aimnet_num_edges.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.aimnet_edges.restype = i32p
    lib.aimnet_edges.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.aimnet_smiles.restype = ctypes.c_char_p
    lib.aimnet_smiles.argtypes = [ctypes.c_void_p]
    lib.aimnet_batch_smiles.restype = ctypes.c_char_p
    lib.aimnet_batch_smiles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.aimnet_featurize_batch.restype = ctypes.c_void_p
    lib.aimnet_featurize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.aimnet_batch_free.argtypes = [ctypes.c_void_p]
    for name, res in (
        ("aimnet_batch_valid", ctypes.POINTER(ctypes.c_uint8)),
        ("aimnet_batch_atom_offsets", i64p),
        ("aimnet_batch_atom_features", i32p),
        ("aimnet_batch_atomic_numbers", i32p),
        ("aimnet_batch_edge_offsets", i64p),
        ("aimnet_batch_edge_dst", i32p),
        ("aimnet_batch_edge_src", i32p),
        ("aimnet_batch_edge_hop", ctypes.POINTER(ctypes.c_int8)),
        ("aimnet_batch_tet_offsets", i64p),
        ("aimnet_batch_tet", i32p),
        ("aimnet_batch_cis_offsets", i64p),
        ("aimnet_batch_cis", i32p),
        ("aimnet_batch_trans_offsets", i64p),
        ("aimnet_batch_trans", i32p),
        ("aimnet_batch_total_charge", i32p),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p]


def _type_builder(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.aimnet_bin_plan.restype = ctypes.c_int
    lib.aimnet_bin_plan.argtypes = [
        i64p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i64p, i32p, i32p,
    ]
    lib.aimnet_bin_fill.restype = ctypes.c_int64
    lib.aimnet_bin_fill.argtypes = (
        [i32p] * 4 + [i64p] + [i32p] * 3 + [i64p]          # columnar cache
        + [i32p, ctypes.c_int64, i32p, i32p, i64p]          # selection + plan
        + [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]  # nbins, ab, mb
        + [i32p] * 5 + [u8p] + [i32p] * 3 + [u8p] + [i8p, i8p]
        + [ctypes.c_int64, ctypes.c_int32]                  # e_slots, clear
    )


def load_library() -> ctypes.CDLL:
    """The loaded library (featurizer and batch builder), built first if
    needed.  Raises when it cannot be built."""
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            _type_featurizer(lib)
            _type_builder(lib)
            _LIB = lib
        return _LIB


def _as_array(ptr, n: int, dtype=np.int32) -> np.ndarray:
    if n == 0 or not ptr:
        return np.zeros(n, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).copy()


def compute_features_native(smiles: str, max_hops: int) -> Optional[MolFeatures]:
    """One molecule's features, or None for a SMILES that does not parse."""
    lib = load_library()
    h = lib.aimnet_featurize(smiles.encode("utf-8"), max_hops)
    if not h:
        return None
    try:
        n = lib.aimnet_num_atoms(h)
        feats = _as_array(lib.aimnet_atom_features(h), n * 4).reshape(n, 4)
        atomic = _as_array(lib.aimnet_atomic_numbers(h), n)
        edge_hops = []
        for hop in range(max_hops):
            e = lib.aimnet_num_edges(h, hop)
            edge_hops.append(_as_array(lib.aimnet_edges(h, hop), 2 * e).reshape(2, e))
        n_tet = lib.aimnet_num_tet(h)
        tet = _as_array(lib.aimnet_tet(h), n_tet * 4).reshape(n_tet, 4)
        n_cis = lib.aimnet_num_cis(h)
        cis = _as_array(lib.aimnet_cis(h), n_cis * 2).reshape(n_cis, 2)
        n_trans = lib.aimnet_num_trans(h)
        trans = _as_array(lib.aimnet_trans(h), n_trans * 2).reshape(n_trans, 2)
        charge = float(lib.aimnet_total_charge(h))
        processed = lib.aimnet_smiles(h).decode("utf-8")
    finally:
        lib.aimnet_free(h)
    return MolFeatures(
        edge_hops=edge_hops,
        atom_type=feats[:, 0].copy(),
        hydrogen_count=feats[:, 1].copy(),
        degree=feats[:, 2].copy(),
        hybridization=feats[:, 3].copy(),
        tet_nbrs=tet,
        cis_pairs=cis,
        trans_pairs=trans,
        total_charge=charge,
        atomic_numbers=atomic,
        smiles=processed,
    )


def featurize_columns(smiles: Sequence[str], max_hops: int, num_threads: int = 0) -> dict:
    """One native batch call over ``smiles`` on ``num_threads`` C++
    threads (0: every core): the library's columnar buffers copied out,
    with per-molecule offsets (an invalid SMILES has empty ranges).  Keys:
    ``valid`` (B,) bool, ``atom_off``, ``edge_off``, ``tet_off``,
    ``cis_off``, ``trans_off`` (B+1,) int64, ``afeat`` (ΣN, 4), ``anum``,
    ``edst``, ``esrc`` (ΣE,) int32 local indices, hop-major per molecule
    (``ehop`` int8), ``tet`` (ΣC, 4), ``cis``, ``trans`` (ΣP, 2),
    ``charge`` (B,) int32 and ``processed`` (the processed SMILES)."""
    lib = load_library()
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    n = len(smiles)
    arr = (ctypes.c_char_p * n)(*[s.encode("utf-8") for s in smiles])
    h = lib.aimnet_featurize_batch(arr, n, max_hops, num_threads)
    try:
        out = {"valid": _as_array(lib.aimnet_batch_valid(h), n, np.uint8).astype(bool)}
        for key, fn in (("atom_off", lib.aimnet_batch_atom_offsets),
                        ("edge_off", lib.aimnet_batch_edge_offsets),
                        ("tet_off", lib.aimnet_batch_tet_offsets),
                        ("cis_off", lib.aimnet_batch_cis_offsets),
                        ("trans_off", lib.aimnet_batch_trans_offsets)):
            out[key] = _as_array(fn(h), n + 1, np.int64)
        ta, te = int(out["atom_off"][-1]), int(out["edge_off"][-1])
        out["afeat"] = _as_array(lib.aimnet_batch_atom_features(h), ta * 4).reshape(-1, 4)
        out["anum"] = _as_array(lib.aimnet_batch_atomic_numbers(h), ta)
        out["edst"] = _as_array(lib.aimnet_batch_edge_dst(h), te)
        out["esrc"] = _as_array(lib.aimnet_batch_edge_src(h), te)
        out["ehop"] = _as_array(lib.aimnet_batch_edge_hop(h), te, np.int8)
        out["tet"] = _as_array(lib.aimnet_batch_tet(h), int(out["tet_off"][-1]) * 4).reshape(-1, 4)
        out["cis"] = _as_array(lib.aimnet_batch_cis(h), int(out["cis_off"][-1]) * 2).reshape(-1, 2)
        out["trans"] = _as_array(lib.aimnet_batch_trans(h),
                                 int(out["trans_off"][-1]) * 2).reshape(-1, 2)
        out["charge"] = _as_array(lib.aimnet_batch_total_charge(h), n)
        out["processed"] = [lib.aimnet_batch_smiles(h, i).decode("utf-8") for i in range(n)]
    finally:
        lib.aimnet_batch_free(h)
    return out


def compute_features_batch(smiles: Sequence[str], max_hops: int,
                           num_threads: int = 0) -> List[Optional[MolFeatures]]:
    """Featurize ``smiles`` in one native call on ``num_threads`` C++
    threads (0: every core); a list aligned with the input, None for a
    SMILES that does not parse."""
    if not len(smiles):
        return []
    c = featurize_columns(smiles, max_hops, num_threads)
    out: List[Optional[MolFeatures]] = []
    for i in range(len(smiles)):
        if not c["valid"][i]:
            out.append(None)
            continue
        a0, a1 = c["atom_off"][i], c["atom_off"][i + 1]
        e0, e1 = c["edge_off"][i], c["edge_off"][i + 1]
        hop = c["ehop"][e0:e1]
        hops = [np.stack([c["edst"][e0:e1][hop == k], c["esrc"][e0:e1][hop == k]])
                for k in range(1, max_hops + 1)]
        afeat = c["afeat"]
        out.append(MolFeatures(
            edge_hops=hops,
            atom_type=afeat[a0:a1, 0],
            hydrogen_count=afeat[a0:a1, 1],
            degree=afeat[a0:a1, 2],
            hybridization=afeat[a0:a1, 3],
            tet_nbrs=c["tet"][c["tet_off"][i]:c["tet_off"][i + 1]],
            cis_pairs=c["cis"][c["cis_off"][i]:c["cis_off"][i + 1]],
            trans_pairs=c["trans"][c["trans_off"][i]:c["trans_off"][i + 1]],
            total_charge=float(c["charge"][i]),
            atomic_numbers=c["anum"][a0:a1],
            smiles=c["processed"][i],
        ))
    return out
