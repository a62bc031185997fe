"""Build and load the port's CUDA kernels: one helper for every library.

Each kernel is a CUDA C++ source under ``repro_torch/csrc/`` with a plain
C interface.  :class:`KernelLibrary` compiles it at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root, keyed by a digest of the
source, the ``csrc/`` headers it includes and the flags, loads it with
``ctypes`` and declares its entry points.  No PyTorch header is compiled,
so a build takes seconds, not minutes.

Nothing here runs at import: a machine without a GPU has no ``nvcc``,
and only a CUDA tensor ever asks for a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: nvcc seconds of the last build of each library, by library name (absent
#: or 0.0 when the library came from the cache).
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           "the port's CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class KernelLibrary:
    """One CUDA source built into one shared library.

    ``entry_points`` maps each exported C function to its ``argtypes``;
    every entry point returns ``int`` (the launch's ``cudaGetLastError``,
    0 on success).
    """

    def __init__(self, name: str, source: str,
                 entry_points: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC / source
        self.entry_points = dict(entry_points)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def headers(self) -> list:
        """The ``csrc/`` headers the source includes by quoted name
        (``#include "x.cuh"``), and theirs, in order of first inclusion."""
        found: list = []
        todo = [self.source]
        while todo:
            text = todo.pop(0).read_text()
            for name in _LOCAL_INCLUDE.findall(text):
                header = CSRC / name
                if header not in found:
                    found.append(header)
                    todo.append(header)
        return found

    def path(self) -> Path:
        """The build's path, keyed by the bytes of the source, of every
        header it includes from ``csrc/`` and of the flags, so that a
        changed shared header rebuilds each library that includes it."""
        sha = hashlib.sha1(self.source.read_bytes())
        for header in self.headers():
            sha.update(header.read_bytes())
        sha.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}_{sha.hexdigest()[:16]}.so"

    def build(self, verbose: bool = False) -> Path:
        """Compile the library if this source has no cached build; returns
        its path.  Writes to a temporary file and renames it, so a
        concurrent build never loads a half-written library."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS[self.name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        if verbose:
            print(f"[nvcc {self.source.name}]\n{proc.stdout}{proc.stderr}",
                  end="", flush=True)
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library with its entry points declared (built on
        first use)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fname, argtypes in self.entry_points.items():
                    fn = getattr(lib, fname)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


def build_all(libraries: Sequence[KernelLibrary],
              verbose: bool = False) -> list:
    """Build several libraries at once, one ``nvcc`` process each, all
    started together; returns their paths in order."""
    with ThreadPoolExecutor(max(len(libraries), 1)) as pool:
        return list(pool.map(lambda lib: lib.build(verbose), libraries))


#: Where a kernel without a backward (RMSNorm's) gets one (ROADMAP.md).
BACKWARD_ITEM = "ROADMAP Queue 1, item 23 (backward kernels)"


def require_no_grad(name: str, *tensors) -> None:
    """Raise where grad mode is on and an input requires grad: a kernel
    with no backward writes its output through a raw pointer, so autograd
    would see a leaf and drop every gradient through it without a word."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward yet ({BACKWARD_ITEM}): "
            f"call it under torch.no_grad() or on inputs that do not "
            f"require grad")


def check_launch(name: str, err: int) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
