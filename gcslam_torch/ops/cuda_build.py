"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/*.cu` file with a plain C interface. nvcc compiles
it for `sm_90a` into a shared library under `csrc/build/` (named by a hash
of the source and the flags, so a changed source builds anew), which is
loaded with ctypes on first use. Nothing here runs at import: building
needs nvcc and the card, and the CPU paths need neither.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

from gcslam_torch.utils.profiling import COUNTERS

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class LaunchCounter:
    """Count of kernel launches (incremented only where the kernel runs),
    and the problem shapes launched since the last reset where the wrapper
    records them."""

    def __init__(self):
        self.launches = 0
        self.shapes = set()

    def reset(self) -> None:
        self.launches = 0
        self.shapes = set()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


class KernelLibrary:
    """One CUDA source built into one ctypes library.

    `functions` maps each exported C function to its argument types; every
    function returns the cudaError_t of its launch as an int."""

    def __init__(self, source: str, stem: str, functions: Dict[str, Sequence], extra_flags: List[str] = ()):
        self.source = CSRC / source
        self.stem = stem
        self.functions = dict(functions)
        self.flags = NVCC_FLAGS + list(extra_flags)
        self.build_log = ""  # nvcc's output of the build made by this process
        self._handle = None

    def path(self) -> Path:
        """The library's path: named by a hash of the source and the flags."""
        digest = hashlib.sha256(self.source.read_bytes() + " ".join(self.flags).encode()).hexdigest()[:12]
        return BUILD / f"lib{self.stem}_{digest}.so"

    def build(self) -> Path:
        """Compile the source unless its library exists; returns its path."""
        lib_path = self.path()
        if lib_path.exists():
            return lib_path
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc(), *self.flags, "-o", tmp, str(self.source)],
                                  capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, lib_path)
            COUNTERS.count_build()
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return lib_path

    def lib(self) -> ctypes.CDLL:
        """The loaded library (built first if needed)."""
        if self._handle is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._handle = lib
        return self._handle
