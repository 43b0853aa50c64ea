"""Phase timers, program spans and trace capture.

Port of binius_ntt_tpu/utils/timing.py (``PhaseTimer``, ``trace_to``).  The
upstream prover splits its time into memcpy / transpose / compute phases
with host timestamps behind a benchmarking flag; here a context manager
accumulates host seconds (``time.perf_counter``) under a phase's name, and
waits for the card before it stops the clock when it is given the phase's
results (``block_on``), so that a phase ending in kernel launches measures
their device work and not only their enqueue.  ``trace_to`` records a
``torch.profiler`` trace (CPU, plus CUDA where the profiler has it) as a
Chrome trace file, with the program's spans in it.

Program spans: ``span(name, device, **attrs)`` marks a layer boundary
inside the package (the prover's host loop, the layout transforms, the
stage groups, the sharded exchange, the set-up).  Spans are off by
default, and then ``span`` returns one shared context that does nothing:
a hot path pays one test of a module global.  ``enable_spans(True)``
turns them on: each span records its name, an id, its parent (the span
open around it), the current request (``set_request``), ``time.time_ns()``
at entry and exit and its attributes; while a profiler records, it
opens a ``torch.profiler.record_function`` of its name over its body (so
the profiler's trace shows it, on the same clock: the Chrome trace's
``ts * 1e3 + baseTimeNanoseconds`` of the range lies inside the span's
stamps); and, given a CUDA device, it records a timing event pair on the
current stream.  The yielded span's ``add(key, n)`` accumulates a count on it.
Spans are kept in memory until ``span_records()`` hands them over.

``PhaseTimer`` and ``trace_to`` are tools for the caller; the spans are
the only part of this module the package calls itself.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from collections.abc import Mapping

import torch

__all__ = ["PhaseTimer", "trace_to", "span", "enable_spans",
           "spans_enabled", "set_request", "span_records"]


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


# ---- program spans ----------------------------------------------------------

_on = False
_request = None
_records: list = []
_open: list = []                 # ids of the spans open, innermost last
_ids = itertools.count()


class _NullSpan:
    """What ``span`` returns while spans are off: enters, exits and counts
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, key: str, n=1) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One recorded span (see the module docstring)."""

    __slots__ = ("name", "id", "parent", "request", "attrs", "counts",
                 "t0_ns", "t1_ns", "_device", "_events", "_range")

    def __init__(self, name: str, device, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.counts = None
        self._device = device
        self._events = None
        self._range = None

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _open[-1] if _open else None
        self.request = _request
        _open.append(self.id)
        self.t0_ns = time.time_ns()
        # a range costs microseconds, and only a recording profiler sees it
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        device = self._device
        if device is not None and torch.device(device).type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(device))
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        if self._range is not None:
            self._range.__exit__(*exc)
        self.t1_ns = time.time_ns()
        _open.pop()
        _records.append(self)
        return False

    def add(self, key: str, n=1) -> None:
        if self.counts is None:
            self.counts = {}
        self.counts[key] = self.counts.get(key, 0) + n

    def record(self) -> dict:
        host_ms = (self.t1_ns - self.t0_ns) * 1e-6
        if self._events is not None:
            device_ms, clock = self._events[0].elapsed_time(
                self._events[1]), "cuda_event"
        elif self._device is not None:
            device_ms, clock = host_ms, "host"      # off the card
        else:
            device_ms, clock = None, None
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "t0_ns": self.t0_ns,
                "t1_ns": self.t1_ns, "host_ms": host_ms,
                "device_ms": device_ms, "host_clock": "time_ns",
                "device_clock": clock, "attrs": dict(self.attrs),
                "counts": dict(self.counts or {})}


def span(name: str, device=None, **attrs):
    """Context manager marking one layer boundary of the package.  Off:
    the shared null span.  On: a recorded span; ``device``, where its work
    runs, gives a span on a CUDA device an event pair on the current
    stream (elsewhere its device time is its host time); None makes a
    host-only span.  ``attrs``: values kept with the span."""
    if not _on:
        return _NULL_SPAN
    return _Span(name, device, attrs)


def enable_spans(on: bool = True) -> None:
    """Turn the program's spans on or off (off by default)."""
    global _on
    _on = bool(on)


def spans_enabled() -> bool:
    return _on


def set_request(request) -> None:
    """The request (a call's index, a name, or None) the spans opened from
    now on belong to."""
    global _request
    _request = request


def span_records() -> list[dict]:
    """The spans closed so far, in the order they closed, as dicts (name,
    id, parent, request, t0_ns, t1_ns, host_ms, device_ms, host_clock,
    device_clock, attrs, counts); the record is cleared.  device_ms is
    None for a host-only span and the event pair's time on a CUDA device:
    call after a synchronise of that device."""
    out = [s.record() for s in _records]
    _records.clear()
    return out


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Record a torch.profiler trace of the body into ``log_dir`` as a
    Chrome trace (``trace.<pid>.json``; chrome://tracing or Perfetto reads
    it).  Activities: the CPU, and CUDA where the CUDA profiler is
    available.  The program's spans are on over the body: each shows in
    the trace as a range of its name, and where this call turned them on,
    their records (span_records()) go into the file's
    ``"programSpans"``.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    mine = not _on
    enable_spans(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        if mine:
            enable_spans(False)
    path = os.path.join(log_dir, f"trace.{os.getpid()}.json")
    prof.export_chrome_trace(path)
    if mine:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with open(path) as f:
            trace = json.load(f)
        trace["programSpans"] = span_records()
        with open(path, "w") as f:
            json.dump(trace, f)
