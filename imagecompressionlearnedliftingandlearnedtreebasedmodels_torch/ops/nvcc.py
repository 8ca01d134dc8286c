"""Building a CUDA source of this package into a shared library at first use.

Each hand-written kernel lives in ``csrc/<name>.cu`` behind a plain C
interface. :class:`Library` compiles it with ``nvcc`` for ``sm_90a`` into
this package's ``build/`` directory, under a name keyed by the hash of the
source and the flags (an edited source builds anew; an unchanged one is
loaded as it is), loads it with ``ctypes`` and declares its functions'
argument types. Nothing is built when a module is imported: the first
launch builds. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this machine")
    return path


class Library:
    """One ``csrc/*.cu`` source, built and loaded once per process.

    ``declare(lib)`` sets ``argtypes``/``restype`` of the library's C
    functions. ``build_log`` holds nvcc's output (ptxas registers and spills)
    when this process built the library, and is empty when it found the
    build already there.
    """

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = source
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()
        self.build_log = ""

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self._build())
                self._declare(lib)
                self._lib = lib
            return self._lib

    def _build(self) -> str:
        with open(self.source, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                                    ).hexdigest()[:12]
        stem = os.path.splitext(os.path.basename(self.source))[0]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
        if os.path.exists(so):
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                                 capture_output=True, text=True)
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {self.source}:\n{self.build_log}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return so
