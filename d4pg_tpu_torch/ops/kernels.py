"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together), the objects are linked into
one shared library with a plain C interface, and the library is loaded
with ``ctypes``. The build runs at the first CUDA use of a kernel, into
``_build/`` beside this file (listed in ``.gitignore``), from the sources
in the checkout only; a library whose name carries the hash of the
current sources (``*.cu`` and the ``*.cuh`` headers they include) and
flags is reused. Nothing is built when the module is imported, and there
is no fallback: a failed build raises. A real build and the library's
load each report to ``io/profiling.record_build`` (the port's
``RecompileSentinel`` counts them); a reuse reports nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (argtypes, restype). Pointers and the stream are
# c_void_p, so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    "d4pg_projection": ([_P, _P, _P, _P, _I, _I, _F, _F, _F, _P], _I),
    "d4pg_projection_ce_fwd": ([_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P],
                               _I),
    "d4pg_projection_ce_bwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F,
                                _P], _I),
    "d4pg_descend": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "d4pg_descent_levels_per_round": ([], _I),
    "d4pg_error_string": ([_I], ctypes.c_char_p),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    build_log: str  # nvcc's output (ptxas resource usage), "" when reused

    def check(self, code: int, kernel: str) -> None:
        """Raise if a launch returned a CUDA error code."""
        if code:
            msg = self.cdll.d4pg_error_string(code).decode()
            raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({code})")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from source at first use")


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(csrc: Path = CSRC) -> Path:
    """Where the library of ``csrc``'s current sources lives: its name
    hashes every ``*.cu`` and every ``*.cuh`` header, so an edit to a
    shared header rebuilds the library too."""
    sources = sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")])
    return BUILD_DIR / f"libd4pg_kernels_{_digest(sources)}.so"


def build() -> tuple[Path, float, str]:
    """Compile and link the kernels if this source set has no library yet.
    Returns ``(path, seconds spent building, nvcc output)``. Only the
    ``*.cu`` files are compiled; the headers reach nvcc through them."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = library_path()
    if lib.exists():
        return lib, 0.0, ""
    from d4pg_tpu_torch.io.profiling import record_build

    nvcc = _nvcc()
    record_build(f"kernels.build {lib.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "\n".join(logs)
        failed = [s.name for s, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)  # atomic: concurrent builders agree
    return lib, time.perf_counter() - t0, log + link.stdout


@functools.cache
def library() -> KernelLibrary:
    """The loaded kernel library, built on first call."""
    from d4pg_tpu_torch.io.profiling import record_build

    path, seconds, log = build()
    record_build(f"kernels.library {path.name}")
    cdll = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = argtypes, restype
    return KernelLibrary(cdll, path, seconds, log)
