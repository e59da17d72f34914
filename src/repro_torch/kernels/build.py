"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a library with a
plain C interface, loaded with ``ctypes``.  Libraries go to ``_build/``
beside this file (listed in ``.gitignore``), named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


class CudaLibrary:
    """One ``csrc/<name>.cu`` source and the library built from it."""

    def __init__(self, name: str):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.ptxas_log = ""   # nvcc's -Xptxas -v report of the last build
        self._lib = None

    def target(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this library; returns the process, or None when
        the library is already built or loaded."""
        if self._lib is not None or self.target().exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.target().with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc) -> None:
        out, _ = proc.communicate()
        self.ptxas_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.target())

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            proc = self.start_build()
            if proc is not None:
                self.finish_build(proc)
            self._lib = ctypes.CDLL(str(self.target()))
        return self._lib


def load_all(libraries) -> None:
    """Build every library at once (one nvcc each, all started together),
    then load them."""
    procs = [(lib, lib.start_build()) for lib in libraries]
    for lib, proc in procs:
        if proc is not None:
            lib.finish_build(proc)
    for lib in libraries:
        lib.load()
