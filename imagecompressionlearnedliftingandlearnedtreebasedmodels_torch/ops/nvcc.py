"""Building a CUDA source of this package into a shared library at first use.

Each hand-written kernel lives in ``csrc/<name>.cu`` behind a plain C
interface. :class:`Library` compiles it with ``nvcc`` for ``sm_90a`` into
this package's ``build/`` directory, under a name keyed by the hash of the
source, of every local header it includes (``#include "..."``, followed
through headers that include others) and of the flags (an edited source or
header builds anew; an unchanged one is loaded as it is), loads it with
``ctypes`` and declares its functions' argument types. Nothing is built
when a module is imported: the first launch builds. A failed build raises;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_headers(source: str) -> list:
    """Every header ``source`` includes with quotes, found beside the file
    that includes it, and the headers those include, each once, in the
    order first met. System headers (``<...>``) are not followed."""
    seen, todo = [], [source]
    while todo:
        path = todo.pop(0)
        with open(path, "rb") as fh:
            names = _LOCAL_INCLUDE.findall(fh.read())
        for name in names:
            dep = os.path.join(os.path.dirname(path), name.decode())
            if os.path.exists(dep) and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this machine")
    return path


class Library:
    """One ``csrc/*.cu`` source, built and loaded once per process.

    ``declare(lib)`` sets ``argtypes``/``restype`` of the library's C
    functions; ``flags`` are added to ``NVCC_FLAGS`` (an include directory,
    a macro) and keyed like them. ``build_log`` holds nvcc's output (ptxas
    registers and spills) when this process built the library, and is empty
    when it found the build already there.
    """

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None],
                 flags=()):
        self.source = source
        self.flags = (*NVCC_FLAGS, *flags)
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

    def digest(self) -> str:
        """The build's key: the source, its local headers and the flags."""
        sha = hashlib.sha256()
        for path in (self.source, *local_headers(self.source)):
            with open(path, "rb") as fh:
                sha.update(os.path.basename(path).encode() + b"\0"
                           + fh.read() + b"\0")
        sha.update(" ".join(self.flags).encode())
        return sha.hexdigest()[:12]

    def _build(self) -> str:
        digest = self.digest()
        stem = os.path.splitext(os.path.basename(self.source))[0]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
        if os.path.exists(so):
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([_nvcc(), *self.flags, "-o", tmp, self.source],
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
