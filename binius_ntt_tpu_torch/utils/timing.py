"""Phase timers and trace capture.

Port of binius_ntt_tpu/utils/timing.py (``PhaseTimer``, ``trace_to``).  The
upstream prover splits its time into memcpy / transpose / compute phases
with host timestamps behind a benchmarking flag; here a context manager
accumulates host seconds (``time.perf_counter``) under a phase's name, and
waits for the card before it stops the clock when it is given the phase's
results (``block_on``), so that a phase ending in kernel launches measures
their device work and not only their enqueue.  ``trace_to`` records a
``torch.profiler`` trace (CPU, plus CUDA where the profiler has it) as a
Chrome trace file.

Nothing on a hot path calls these: they are tools for the caller.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections.abc import Mapping

import torch

__all__ = ["PhaseTimer", "trace_to"]


def _tensors(obj):
    """The tensors in ``obj``: a tensor, or a sequence or dict of them."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, Mapping):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _synchronize(block_on) -> None:
    """Wait for every CUDA device that holds a tensor of ``block_on``."""
    devices = {t.device for t in _tensors(block_on) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates named phase durations (host seconds)."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the body under ``name``.  ``block_on``: a tensor, or a
        sequence or dict of tensors, read when the body has run (so a list
        the body appends its results to works); the clock stops after every
        CUDA device among them has finished its work."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k}: {v * 1e3:.3f} ms" for k, v in self.phases.items()]
        lines.append(f"total: {total * 1e3:.3f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Record a torch.profiler trace of the body into ``log_dir`` as a
    Chrome trace (``trace.<pid>.json``; chrome://tracing or Perfetto reads
    it).  Activities: the CPU, and CUDA where the CUDA profiler is
    available.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace.{os.getpid()}.json"))
