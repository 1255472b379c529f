"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"`` launcher
(no PyTorch headers, so ``nvcc`` takes seconds).  On first use the source
is compiled for Hopper (``sm_90a``) into ``build/repro_torch/`` at the root
of the checkout, under a file name keyed by a hash of the source and the
flags, so an edited source never loads a stale library.  There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build",
           "load_library"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/_build.py → the checkout root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CUDA_ROOT = "/usr/local/cuda"      # the toolkit's default install prefix


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``CUDA_ROOT``.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), CUDA_ROOT):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built from source on first use")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    return the library's path.  ``-Xptxas -v`` output (registers, shared
    memory, spills) is kept beside it as ``<library>.log``."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: processes building at the
    # same time (test workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of kernel ``name``, once per
    process."""
    return ctypes.CDLL(str(build(name)))
