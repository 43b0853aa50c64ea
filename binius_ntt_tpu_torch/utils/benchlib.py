"""Device timing with CUDA events.

Torch returns before the device finishes, so a host clock around a launch
measures the enqueue.  ``device_time`` records CUDA events around each call
on the current stream, after warm-up calls, and returns the median.  It
refuses to run without a CUDA device: a CPU time is never reported under a
device metric.

The reference's ``setup_compile_cache`` (binius_ntt_tpu/utils/benchlib.py,
the XLA compilation cache) has nothing to port: the kernels are built once
into a library named by a digest of their sources and flags, kept in the
package's ``_build/`` directory (``_build.py``), which plays that role.

``md5_words`` and ``md5_untransposed`` digest an output the size of the
card's memory without a host copy of it whole: the golden tables' MD5 over
little-endian words, fed a chunk at a time.
"""

from __future__ import annotations

import hashlib
import statistics

import torch

from ..layout.bitslicing import bitslice_untranspose
from .bits import to_numpy

__all__ = ["device_time", "md5_words", "md5_untransposed"]

HASH_CHUNK_WORDS = 1 << 26      # 256 MiB of words a host copy


def device_time(fn, *args, warmup: int = 2, reps: int = 7) -> float:
    """Median seconds per call of ``fn(*args)`` on the current CUDA stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA device")
    if reps < 1:
        raise ValueError("reps must be >= 1")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def md5_words(t: torch.Tensor, chunk_words: int = HASH_CHUNK_WORDS) -> str:
    """MD5 of an int32 tensor's words, little-endian, on any device, fed a
    host copy of ``chunk_words`` words at a time."""
    flat, h = t.reshape(-1), hashlib.md5()
    for i in range(0, flat.numel(), chunk_words):
        h.update(memoryview(to_numpy(flat[i:i + chunk_words])))
    return h.hexdigest()


def md5_untransposed(sliced: torch.Tensor,
                     chunk_rows: int = HASH_CHUNK_WORDS // 128) -> str:
    """MD5 of ``bitslice_untranspose(sliced)``'s words for a bit-sliced
    (rows, W) int32 tensor, without making it: ``chunk_rows`` rows at a
    time are untransposed on the tensor's device and copied to the host."""
    h = hashlib.md5()
    for i in range(0, sliced.shape[0], chunk_rows):
        h.update(memoryview(to_numpy(
            bitslice_untranspose(sliced[i:i + chunk_rows]))))
    return h.hexdigest()
