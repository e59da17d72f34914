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


class Kernel:
    """One launcher of a built library and a count of the launches made
    through it.

    The library exports ``int <name>_launch(...)``, which returns a
    cudaError_t (0 on success) or -1 for a configuration the source does
    not instantiate, and ``const char* <library>_error_string(int)``.  By
    default the library is ``csrc/<name>.cu``; several kernels of one
    source share one ``CudaLibrary`` and each counts its own launches.
    """

    def __init__(self, name: str, argtypes, library: CudaLibrary | None = None):
        self.name = name
        self.library = CudaLibrary(name) if library is None else library
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._error_string = None

    def fn(self):
        """The launcher, building and loading the library at first use."""
        if self._fn is None:
            lib = self.library.load()
            fn = getattr(lib, f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.library.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._error_string = fn, err
        return self._fn

    def launch(self, *args, config: str) -> None:
        """Launch once; raises if the launch was refused, else counts it.
        ``config`` names the instantiation asked for, for the error."""
        err = self.fn()(*args)
        if err == -1:
            raise ValueError(f"{self.name}: no kernel built for {config} "
                             f"(see csrc/{self.library.name}.cu)")
        if err:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{self._error_string(err).decode()}")
        self.launches += 1


def load_all(libraries) -> None:
    """Build every library at once (one nvcc each, all started together),
    then load them.  A library named more than once is built once."""
    libraries = list(dict.fromkeys(libraries))
    procs = [(lib, lib.start_build()) for lib in libraries]
    for lib, proc in procs:
        if proc is not None:
            lib.finish_build(proc)
    for lib in libraries:
        lib.load()
