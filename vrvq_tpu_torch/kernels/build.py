"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` goes into ONE shared library through ONE ``nvcc`` call.
The sources have a plain C interface and include no PyTorch header, so the
build takes seconds (a PyTorch extension build takes minutes). The library
lands in ``_build/`` (git-ignored), named by a hash of the sources, the flags
and the compiler, and is built on first use: nothing is compiled when this
module is imported.

No ``--use_fast_math``: it would turn ``sinf`` into ``__sinf`` and the
divisions into approximations, and the kernels must agree with their plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import counter

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches by kernel name, the "launches" group of the counters of
# ``utils``. Each wrapper adds one (``count("launches.<kernel>")``) where it
# launches its kernel and nowhere else, so a run can show which kernels its
# path went through (clear it before the run, read it after).
LAUNCHES = counter("launches")

_P = ctypes.c_void_p
_SIGNATURES = {
    "vrvq_snake_forward": (
        [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "vrvq_snake_forward_cl": (
        [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "vrvq_snake_backward": (
        [_P] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_int, _P],
        ctypes.c_int,
    ),
    "vrvq_snake_backward_tiles": ([ctypes.c_longlong], ctypes.c_longlong),
    "vrvq_rvq_forward": (
        [_P] * 5 + [ctypes.c_int] * 7 + [_P],
        ctypes.c_int,
    ),
    "vrvq_rvq_stage_floats": ([ctypes.c_int] * 4, ctypes.c_int),
    "vrvq_rvq_smem_bytes": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "vrvq_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def find_nvcc() -> str:
    """``nvcc`` from PATH, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in filter(None, homes):
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.is_file() and os.access(candidate, os.X_OK):
            return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
        "kernels in vrvq_tpu_torch/kernels/csrc"
    )


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path(nvcc: str) -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"libvrvq_kernels_{h.hexdigest()[:16]}.so"


def build(nvcc: str, out: Path) -> str:
    """Compile every source into ``out`` with one ``nvcc`` call; returns the
    compiler's output (ptxas register and shared-memory report)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    return log


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    nvcc = find_nvcc()
    path = library_path(nvcc)
    if not path.exists():
        build(nvcc, path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().vrvq_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err}: {msg}")
