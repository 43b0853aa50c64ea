"""ctypes bindings of the native host oracle, ``tools/native/oracle.cpp``.

Port of binius_ntt_tpu/utils/native_oracle.py with the same five names and
the same numpy-in, numpy-out signatures: ``available``, ``mt19937_fill``,
``tower_mul128``, ``additive_ntt32`` and ``additive_ntt128``.  The oracle is
a separate C++ implementation of std::mt19937, the GF(2^128) tower product
and both additive NTTs.  It makes golden vectors at sizes the Python oracle
cannot reach, and makes mt19937 inputs about ten times faster than the
numpy generator (utils/mt19937.py, kept as the pure-Python path).

The library is built with g++ at first use (never at import), from the
source in ``tools/native/`` (read, never written), into the package's
``_build/`` directory beside the CUDA library.  Its name is a digest of the
source, the flags and the host's instruction set: ``-march=native`` code
built on one CPU may not run on another, so a build directory copied to
another machine never loads a library made for a different CPU.  The build
writes a temporary file and renames it into place, so processes that build
at once (test workers) each see a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "mt19937_fill", "tower_mul128", "additive_ntt32",
           "additive_ntt128", "library_path"]

SOURCE = Path(__file__).resolve().parents[2] / "tools" / "native" / "oracle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None


def _host_isa() -> str:
    """The host's machine and CPU feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return f"{platform.machine()} {line.split(':', 1)[1]}"
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def library_path() -> Path:
    """Where this host's build of the oracle lives (built or not)."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(_host_isa().encode())
    return BUILD_DIR / f"liboracle_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native oracle is built from "
                           f"{SOURCE} at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.mt19937_fill.argtypes = [ctypes.c_uint32, u32p, ctypes.c_size_t]
        lib.tower_mul128.argtypes = [u32p, u32p, u32p, ctypes.c_size_t]
        lib.additive_ntt32.argtypes = [u32p, ctypes.c_int, ctypes.c_int, u32p]
        lib.additive_ntt128.argtypes = [u32p, ctypes.c_int, ctypes.c_int,
                                        u32p]
        for fn in (lib.mt19937_fill, lib.tower_mul128, lib.additive_ntt32,
                   lib.additive_ntt128):
            fn.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """True when the oracle builds (or is built) and loads; False where g++
    or the build is missing."""
    try:
        _load()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _words(a, name: str) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype not in (np.uint32, np.int32):
        raise ValueError(f"{name}: expected uint32 words, got {a.dtype}")
    return np.ascontiguousarray(a.view(np.uint32).reshape(-1))


def mt19937_fill(seed: int, n: int) -> np.ndarray:
    """The first ``n`` outputs of std::mt19937(seed), as uint32."""
    if n < 0:
        raise ValueError(f"mt19937_fill: n={n} < 0")
    out = np.empty(n, dtype=np.uint32)
    _load().mt19937_fill(seed & 0xFFFFFFFF, _ptr(out), n)
    return out


def tower_mul128(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Element-wise GF(2^128) tower products of compact words (4 a value,
    little-endian)."""
    a, b = _words(a, "tower_mul128"), _words(b, "tower_mul128")
    if a.size != b.size or a.size % 4:
        raise ValueError(f"tower_mul128: operands of {a.size} and {b.size} "
                         f"words; both need the same multiple of 4")
    out = np.empty_like(a)
    _load().tower_mul128(_ptr(a), _ptr(b), _ptr(out), a.size // 4)
    return out


def additive_ntt32(x: np.ndarray, log_h: int, log_rate: int) -> np.ndarray:
    """The GF(2^32) additive NTT of 2^log_h words at rate 2^-log_rate."""
    x = _words(x, "additive_ntt32")
    if x.size != 1 << log_h:
        raise ValueError(f"additive_ntt32: {x.size} words != 2^{log_h}")
    out = np.empty(1 << (log_h + log_rate), dtype=np.uint32)
    _load().additive_ntt32(_ptr(x), log_h, log_rate, _ptr(out))
    return out


def additive_ntt128(x_words: np.ndarray, log_h: int,
                    log_rate: int) -> np.ndarray:
    """The GF(2^128) additive NTT; x_words: (2^log_h * 4,) little-endian
    element-major words."""
    x = _words(x_words, "additive_ntt128")
    if x.size != (1 << log_h) * 4:
        raise ValueError(f"additive_ntt128: {x.size} words != 2^{log_h} * 4")
    out = np.empty((1 << (log_h + log_rate)) * 4, dtype=np.uint32)
    _load().additive_ntt128(_ptr(x), log_h, log_rate, _ptr(out))
    return out
