"""The port's host-side C++ libraries, built with ``g++`` at first use.

``io.py`` binds ``libvrvqio`` (``wavio.cc``, ``flacio.cc``, ``rangecoder.cc``:
the wav and flac readers, the BS.1770 meter and the range coder), and
``data/ffdecode.py`` binds the FFmpeg shim (``ffdecode.cc``). ``build``
compiles a library into ``kernels/_build/`` (git-ignored), named by a hash of
its sources, flags and compiler, through a temporary name, so processes that
build at once each see a whole file; nothing is compiled at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

from ..kernels.build import BUILD_DIR

SOURCE_DIR = Path(__file__).resolve().parent
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def find_cxx() -> str:
    """The C++ compiler (``$CXX``, else ``g++``) on PATH; raises
    RuntimeError where there is none."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    return cxx


def library_path(name: str, sources: Sequence[Path], libs: Sequence[str],
                 cxx: str) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS + tuple(libs)).encode())
    h.update(cxx.encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path], libs: Sequence[str] = ()) -> Path:
    """The library ``name`` of ``sources`` (linked against ``libs``),
    compiled unless a build of these sources, flags and compiler exists.
    Raises RuntimeError with the compiler's last lines where it fails."""
    cxx = find_cxx()
    out = library_path(name, sources, libs, cxx)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, sources), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        tail = "\n".join((proc.stdout + proc.stderr).strip().splitlines()[-8:])
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{tail}")
    os.replace(tmp, out)
    return out
