"""The C++ PER trees (``native/per_trees.cpp``) through ctypes.

Counterpart of ``d4pg_tpu/replay/native.py``. ``NativePerTrees`` holds a
sum tree and a min tree behind one object (PER writes the same
priorities to both) with the operations of the numpy pair in
``replay/prioritized.py``.

Build: ``g++`` with the flags of ``native/Makefile`` compiles the tracked
source into ``_build/`` beside this file (listed in ``.gitignore``) at
the first use, never when the module is imported. The library's name
hashes the source, the flags and the host's CPU (``-march=native`` ties
the code to the CPU it was built on), so an edited source or another
machine gets its own build; an existing one is reused. The port builds
and loads only its own library: never the JAX package's
``d4pg_tpu/replay/_native/``, and never through ``make``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "per_trees.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# native/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-Wextra"]


def _host_identity() -> str:
    """The CPU the build targets: the machine, and the first processor's
    model name and flags where ``/proc/cpuinfo`` has them."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and line not in ident:
                    ident.append(line)
                if line.strip() == "":
                    break
    except OSError:
        pass
    return "".join(ident)


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(_host_identity().encode())
    h.update(source.read_bytes())
    return build_dir / f"libper_trees_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` unless its library exists; returns its path.
    Raises ``RuntimeError`` when the source or ``g++`` is missing or the
    compile fails."""
    if not source.is_file():
        raise RuntimeError(f"native PER source {source} not found")
    lib = library_path(source, build_dir)
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native PER trees are built "
                           "from source at first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        tmp_lib = Path(tmp) / lib.name
        out = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp_lib),
                              str(source)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if out.returncode:
            raise RuntimeError(f"g++ failed on {source.name}:\n{out.stdout}")
        os.replace(tmp_lib, lib)  # atomic: concurrent builds agree
    return lib


_P = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "pt_new": ([ctypes.c_int64], _P),
    "pt_free": ([_P], None),
    "pt_capacity": ([_P], ctypes.c_int64),
    "pt_set": ([_P, _I64P, _F64P, ctypes.c_int64], None),
    "pt_total": ([_P], ctypes.c_double),
    "pt_min": ([_P], ctypes.c_double),
    "pt_get": ([_P, _I64P, _F64P, ctypes.c_int64], None),
    "pt_find_prefix": ([_P, _F64P, _I64P, ctypes.c_int64], None),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built on the first call. Raises
    ``RuntimeError`` (or ``OSError`` from the loader) on failure; a
    failure is not cached, so the next call tries again."""
    cdll = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = argtypes, restype
    return cdll


def _i64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _f64(a: np.ndarray):
    return a.ctypes.data_as(_F64P)


class NativePerTrees:
    """Sum and min segment trees in the C++ library."""

    backend = "native"

    def __init__(self, capacity: int):
        self._lib = library()
        self._h = _P(self._lib.pt_new(int(capacity)))
        self.capacity = int(self._lib.pt_capacity(self._h))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.pt_free(h)

    def set(self, idx: np.ndarray, values: np.ndarray) -> None:
        # ravel: [K, B] chunk indices are K * B writes (the C side takes
        # an element count); flat order keeps numpy's last-wins on
        # duplicate indices
        idx = np.ascontiguousarray(np.asarray(idx, np.int64).ravel())
        values = np.ascontiguousarray(
            np.asarray(values, np.float64).ravel())
        if idx.size != values.size:
            raise ValueError(f"{idx.size} indices, {values.size} values")
        if idx.size and (idx.min() < 0 or idx.max() >= self.capacity):
            raise IndexError(f"leaf index out of [0, {self.capacity})")
        self._lib.pt_set(self._h, _i64(idx), _f64(values), idx.size)

    def sum(self) -> float:
        return float(self._lib.pt_total(self._h))

    def min(self) -> float:
        return float(self._lib.pt_min(self._h))

    def get(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        flat = np.ascontiguousarray(idx.ravel())
        if flat.size and (flat.min() < 0 or flat.max() >= self.capacity):
            raise IndexError(f"leaf index out of [0, {self.capacity})")
        out = np.empty(flat.size, np.float64)
        self._lib.pt_get(self._h, _i64(flat), _f64(out), flat.size)
        return out.reshape(idx.shape)

    def find_prefixsum(self, prefix: np.ndarray) -> np.ndarray:
        prefix = np.asarray(prefix, np.float64)
        flat = np.ascontiguousarray(prefix.ravel())
        out = np.empty(flat.size, np.int64)
        self._lib.pt_find_prefix(self._h, _f64(flat), _i64(out), flat.size)
        return out.reshape(prefix.shape)
