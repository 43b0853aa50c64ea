"""Spans and the device trace of a traced run (``--trace 1``).

Spans: the benchmark wraps functions of the program, named by per-layer
metric files as ``"module:attribute.path"``, and records a pair of CUDA
events on the current stream around each call made in the window (host
clock readings on the CPU, where the tests run).  The program is not
edited: the wrappers are set on the module or class attribute, inside the
traced process only, and taken off again.

Device trace: ``torch.profiler`` over a short part of the window, its
chrome trace read for the device's kernels, copies and sets: the time the
device was busy, the seconds of each operation by name, the operations
that took most time, and the idle gaps labelled by the innermost host
range open at the gap's middle.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import re
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


class HostEvent:
    """A stand-in for a CUDA event on the CPU: the host clock."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def event_factory(device: torch.device):
    if device.type == "cuda":
        return functools.partial(torch.cuda.Event, enable_timing=True)
    return HostEvent


class Spans:
    """Event pairs around wrapped calls, by name and window iteration."""

    def __init__(self, device: torch.device):
        self.event = event_factory(device)
        self.iteration = None          # None: outside the window, no record
        self.records = []
        self._patched = []

    def wrap(self, target: str) -> None:
        if any(t == target for t, *_ in self._patched):
            return
        module, path = target.split(":")
        owner = importlib.import_module(module)
        *parents, attr = path.split(".")
        for p in parents:
            owner = getattr(owner, p)
        original = owner.__dict__[attr] if isinstance(owner, type) \
            else getattr(owner, attr)
        spans = self

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            if spans.iteration is None:
                return original(*args, **kwargs)
            start, end = spans.event(), spans.event()
            start.record()
            with torch.profiler.record_function(path):
                out = original(*args, **kwargs)
            end.record()
            spans.records.append((target, spans.iteration, start, end))
            return out

        setattr(owner, attr, wrapper)
        self._patched.append((target, owner, attr, original))

    def restore(self) -> None:
        for _, owner, attr, original in reversed(self._patched):
            setattr(owner, attr, original)
        self._patched.clear()

    def durations(self) -> dict:
        """{target: {iteration: total ms}} (call after a synchronise)."""
        out = defaultdict(lambda: defaultdict(float))
        for target, it, start, end in self.records:
            out[target][it] += start.elapsed_time(end)
        return out


def _union(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class DeviceTrace:
    """torch.profiler over part of the window; ``summary`` after stop."""

    def __init__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.window_s = 0.0
        self.summary = None

    def start(self) -> None:
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        self.summary = summarize(events, self.window_s)


def short_name(name: str) -> str:
    """A kernel's name without its argument list and namespaces; an
    elementwise kernel of at::native by the functor it runs."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    found = re.findall(r"\w+Functor|\w+_kernel_cuda|CatArrayBatchedCopy\w*",
                       name)
    if name.startswith("void at::native::") and found:
        return "at::native::" + found[-1]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def summarize(events, window_s: float) -> dict:
    """Busy seconds, every device operation's seconds by short name, the
    top ones and labelled idle gaps from chrome-trace events (ts and dur
    in microseconds)."""
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        item = (s, s + float(ev["dur"]), ev.get("name", "?"))
        if ev.get("cat") in DEVICE_CATS:
            dev.append(item)
        elif ev.get("cat") in HOST_CATS:
            host.append(item)
    if not dev:
        return {"busy_s": 0.0, "window_s": window_s, "op_s": {},
                "device_ops": [], "idle_gaps": []}
    busy = _union((s, e) for s, e, _ in dev) * 1e-6
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[short_name(name)] += (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = defaultdict(float)
    dev.sort()
    hs = np.array([h[0] for h in host] or [0.0])
    he = np.array([h[1] for h in host] or [-1.0])
    reach = dev[0][1]
    for s, e, _ in dev[1:]:
        if s > reach:
            mid = (reach + s) / 2
            open_ = np.nonzero((hs <= mid) & (he >= mid))[0]
            label = (host[min(open_, key=lambda i: he[i] - hs[i])][2]
                     if len(open_) else "no host range")
            gaps[label] += (s - reach) * 1e-6
        reach = max(reach, e)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": window_s, "op_s": dict(by_name),
            "device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}


def idle_pct(summary) -> float | None:
    """100 (1 - busy / window) of a DeviceTrace summary; None where the
    trace holds no device record."""
    if not summary or summary["busy_s"] <= 0 or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
