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
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["device_time"]


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
