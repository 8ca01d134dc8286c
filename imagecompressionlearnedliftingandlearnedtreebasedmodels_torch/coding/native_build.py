"""Building the host C++ coding libraries at first use.

The port compiles its own byte-for-byte copies of the JAX package's coding
sources (``csrc/rans_core.h``, ``csrc/rans.cpp``, ``csrc/wavefront_ctx.cpp``)
with ``g++`` into this package's ``build/`` directory, under a name keyed by
the hash of the sources and the asked flags (an edited source builds anew,
an unchanged one is loaded as it is). The flags are the JAX package's
(``coding/rans.py``, ``coding/native_ctx.py``): the same flags on one host
give the same context arithmetic, so the same ``ctx_fingerprint`` and the
same bytes. Where the compiler refuses an optional flag of the context
walker (``-mprefer-vector-width=512``, ``-fopenmp``), the flag it complained
about is dropped first, then the other, then both, as there; the flags a
library was built with are kept beside it (``flags_used``). A failed build
raises. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Callable, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")


class HostLibrary:
    """One C++ source (and the headers it includes), built and loaded once
    per process. ``optional`` are flags that may be dropped, in the JAX
    package's order, when the compiler refuses them; ``declare(lib)`` sets
    the C functions' ``argtypes``/``restype`` where the bindings need it."""

    def __init__(self, source: str, headers: Sequence[str],
                 flags: Sequence[str], optional: Tuple[str, ...] = (),
                 declare: Optional[Callable[[ctypes.CDLL], None]] = None):
        self.source = os.path.join(CSRC, source)
        self.headers = [os.path.join(CSRC, h) for h in headers]
        self.flags = list(flags)
        self.optional = tuple(optional)
        self.flags_used = None
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self._build())
                if self._declare is not None:
                    self._declare(lib)
                self._lib = lib
            return self._lib

    def _path(self) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for path in [self.source, *self.headers]:
            with open(path, "rb") as fh:
                h.update(fh.read())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:12]}.so")

    def _build(self) -> str:
        so = self._path()
        if os.path.exists(so):
            with open(so + ".flags") as fh:
                self.flags_used = fh.read().split()
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            used = self._compile(tmp)
            with open(tmp + ".flags", "w") as fh:
                fh.write(" ".join(used))
            os.replace(tmp + ".flags", so + ".flags")
            os.replace(tmp, so)
        finally:
            for path in (tmp, tmp + ".flags"):
                if os.path.exists(path):
                    os.remove(path)
        self.flags_used = used
        return so

    def _compile(self, out: str):
        def run(flags):
            subprocess.run(["g++", *flags, "-o", out, self.source],
                           check=True, capture_output=True)
            return list(flags)

        try:
            return run(self.flags)
        except subprocess.CalledProcessError as e:
            if not self.optional:
                raise RuntimeError(f"g++ failed to build {self.source}:\n"
                                   f"{e.stderr.decode('utf-8', 'replace')}")
            stderr = (e.stderr or b"").decode("utf-8", "replace")
            opts = sorted(self.optional, key=lambda f: f not in stderr)
            attempts = [[f for f in self.flags if f != opts[0]],
                        [f for f in self.flags if f != opts[-1]],
                        [f for f in self.flags if f not in opts]]
            last = e
            for flags in attempts:
                try:
                    return run(flags)
                except subprocess.CalledProcessError as err:
                    last = err
            raise RuntimeError(
                f"g++ failed to build {self.source}:\n"
                f"{last.stderr.decode('utf-8', 'replace')}") from last


def _declare_rans(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.rans_encode_with_indexes.argtypes = [p, p, i64, p, i32, p, p, p, i64]
    lib.rans_encode_with_indexes.restype = i64
    lib.rans_decode_with_indexes.argtypes = [p, i64, p, i64, p, i32, p, p, p]
    lib.rans_decode_with_indexes.restype = i64
    lib.rans_decoder_new.argtypes = [p, i64]
    lib.rans_decoder_new.restype = p
    lib.rans_decoder_free.argtypes = [p]
    lib.rans_decoder_free.restype = None
    lib.rans_decoder_decode.argtypes = [p, p, i64, p, i32, p, p, p]
    lib.rans_decoder_decode.restype = i64
    lib.pmf_to_quantized_cdf.argtypes = [p, i32, i32, p]
    lib.pmf_to_quantized_cdf.restype = i32


# coding/rans.py:35-38 of the JAX package
RANS = HostLibrary("rans.cpp", ["rans_core.h"],
                   ["-O3", "-shared", "-fPIC", "-std=c++17"],
                   declare=_declare_rans)
# coding/native_ctx.py:48-74 of the JAX package: no -ffast-math, so the
# context arithmetic is IEEE up to the FMA contraction and vector width that
# -march=native allows, which ctx_fingerprint() covers
WAVEFRONT_CTX = HostLibrary(
    "wavefront_ctx.cpp", ["rans_core.h"],
    ["-O3", "-march=native", "-mprefer-vector-width=512", "-funroll-loops",
     "-shared", "-fPIC", "-std=c++17", "-fopenmp"],
    optional=("-mprefer-vector-width=512", "-fopenmp"))
