"""Building the port's CUDA kernels: one helper shared by every kernel.

Each kernel source in `csrc/` has a plain C entry point. On first use it is
compiled with nvcc for `sm_90a` into the checkout's gitignored
`build/kernels/` (once per source version: the library's name carries a
hash of the source and the flags) and loaded with ctypes. Nothing here
runs when a module is imported, so the CPU tests import every kernel
module without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Sequence

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


class CudaLibrary:
    """One kernel source of `csrc/`, compiled and loaded on first use.

    `entry` names its plain C launch function and `argtypes` its ctypes
    signature (`ctypes.c_void_p` for every pointer and the stream).
    `log` holds the compiler's report (ptxas registers, shared memory,
    spills) of a build made by this process, or "" if the library was
    already built."""

    def __init__(self, source: str, entry: str, argtypes: Sequence):
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.log = ""
        self._dll = None
        self._fn = None
        self._others = {}
        self._lock = threading.Lock()

    def load(self):
        """The launch function, building the library first if needed."""
        with self._lock:
            if self._fn is not None:
                return self._fn
            src = self.source.read_bytes()
            tag = hashlib.sha256(src + repr(NVCC_FLAGS).encode()).hexdigest()
            so = BUILD_DIR / f"{self.source.stem}-{tag[:16]}.so"
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True)
                self.log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed to build "
                                       f"{self.source.name}:\n{self.log}")
                os.replace(tmp, so)
            self._dll = ctypes.CDLL(str(so))
            fn = getattr(self._dll, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
            return fn

    def function(self, name: str, argtypes: Sequence, restype):
        """Another C function of the same library, building it first if
        needed (typed once, then cached)."""
        self.load()
        with self._lock:
            fn = self._others.get(name)
            if fn is None:
                fn = getattr(self._dll, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
                self._others[name] = fn
            return fn
