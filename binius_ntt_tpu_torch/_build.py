"""Build the CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all of them at once, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes).  The library lands in ``_build/`` beside this file (listed in
.gitignore), named by a digest of the sources and flags, so a changed
source rebuilds and an unchanged one loads the existing file (and the
compiler's report, kept beside it).

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises if that is not 0.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .utils.timing import span

__all__ = ["library", "check", "build_info", "kernel_usage"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U = ctypes.c_uint32
_SIGNATURES = {
    # name: argtypes (pointers and the stream as c_void_p)
    "bntt_mul_tiles": (_P, _P, _P, _L, _P),
    "bntt_stage_group": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "bntt_sumcheck_round": (_P, _P, _I, _L, _L, _I, _P, _P),
    "bntt_sumcheck_fold": (_P, _I, _L, _L, _I, _U, _U, _U, _U, _P),
    "bntt_bitslice_lane_groups": (_P, _P, _L, _P),
    "bntt_stage_group32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P),
    "bntt_stage_group_r2": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "bntt_prime_round": (_P, _P, _L, _L, _P),
    "bntt_prime_fold": (_P, _L, _L, _U, _U, _U, _U, _P),
    "bntt_butterfly_high": (_P, _P, _L, _I, _I, _P),
    "bntt_butterfly_low": (_P, _P, _P, _L, _I, _I, _P),
    "bntt_mul_compact": (_P, _P, _P, _L, _I, _P),
    "bntt_bitslice128_transpose": (_P, _P, _L, _P),
    "bntt_bitslice128_untranspose": (_P, _P, _L, _P),
}

_lib = None
# filled by the build: seconds spent in nvcc (0.0 if the library was
# already on disk) and the compiler's -Xptxas -v report
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; return their output, raise if any
    failed (after all of them have ended)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def _compile() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"libbntt_{digest.hexdigest()[:16]}.so"
    saved_log = out.with_suffix(".log")
    if out.exists():
        build_info.update(seconds=0.0, log=(saved_log.read_text()
                                            if saved_log.exists()
                                            else "(cached)"))
        return out
    work = BUILD_DIR / f"objects.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objects = [work / f"{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objects)])
        log += _run([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                      *map(str, objects)]])
        saved_log.write_text(log)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(work, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, log=log)
    return out


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call (a
    ``setup.build`` span, utils/timing.py: the build or the load of the
    library already on disk)."""
    global _lib
    if _lib is None:
        with span("setup.build"):
            lib = ctypes.CDLL(str(_compile()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_usage(name: str, log: str | None = None) -> str:
    """What ptxas reported for the first entry function whose mangled name
    holds ``name`` in the build log (``build_info["log"]`` unless given):
    its stack frame and spill line, then its registers line; "" when the
    log does not have it (a library cached without its report).  A
    template instantiation is named by the start of its mangled arguments,
    as in ``"sumcheck_fold_kernelILb1E"`` for
    ``sumcheck_fold_kernel<true>``."""
    lines = [ln.strip() for ln in
             (build_info.get("log", "") if log is None else log).splitlines()]
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and name in ln:
            found = []
            for want in ("stack frame", "Used"):
                found += [x.split(": ", 1)[-1] for x in lines[i + 1:]
                          if want in x][:1]
            return " | ".join(found)
    return ""


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {rc}")
