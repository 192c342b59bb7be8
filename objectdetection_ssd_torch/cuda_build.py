"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, cached under ``_build/`` by
the hash of its source and flags, and loaded with ``ctypes``.  The
compiler's output, with ``-Xptxas=-v``'s register and shared-memory report,
is kept beside each library as ``<name>.log``.

Every library exports ``int ssd_cuda_error_string(int)`` beside its launch
functions, which return ``cudaGetLastError()``; `check` turns a nonzero code
into an exception.  ``-fmad=false`` keeps every separate multiply and add
unfused (the NMS kernel's IoU must round as the plain version's does); a
kernel that wants a fused multiply-add says so with ``__fmaf_rn``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600

_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    """nvcc from PATH, else from the toolkit PyTorch's builder finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    """Where the library for ``source`` and this flag set is (to be) built."""
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def compile_sources(sources: Iterable[Path]) -> None:
    """Compile every source whose library is missing, all ``nvcc`` processes
    started together; raise if any of them fails."""
    pending = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(source)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((Path(source), out, tmp, proc))
    failed = []
    for source, out, tmp, proc in pending:
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source.name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, compiled first if need be."""
    source = Path(source)
    if source not in _loaded:
        compile_sources([source])
        lib = ctypes.CDLL(str(library_path(source)))
        lib.ssd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ssd_cuda_error_string.restype = ctypes.c_char_p
        _loaded[source] = lib
    return _loaded[source]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.ssd_cuda_error_string(err).decode())
