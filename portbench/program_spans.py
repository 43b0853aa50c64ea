"""The program's own spans and counts in a traced run, for the per-layer
metrics that read them (``source`` program_span or program_counter, and
``prover_idle_ms``).

The program (binius_ntt_tpu_torch.utils.timing) marks its layer
boundaries with spans that are off by default.  A traced run turns them
on before the program is built, so its set-up spans (``setup.tables``,
``setup.build``) are kept under the request ``"setup"``, with those of
the warm calls (``Program.warm`` and calls of a negative index); each
window call of the driver's ``Program.call`` runs under its iteration as
the request;
after the window a reader takes the records (``records``), which turns
the spans off again.  A run with ``--trace 0`` touches none of this, and
a program without spans (no ``span_records`` in its timing module) gives
every reader here nothing to read.

The harness calls a reader only after the window and names no hook
before the set-up, so the readers that need spans call :func:`arm` when
they are loaded, which the harness does while it builds the cell in
``run.run``: :func:`arm` finds that call on the stack and reads its
``traced`` argument.  For ``prover_idle_ms`` it also keeps the Chrome
trace events of the window's device trace (``trace.summarize`` is wrapped
for the run; its result is unchanged).  Everything patched is restored
when the records are taken.
"""

from __future__ import annotations

import functools
import importlib
import sys

import torch

from portbench import trace

_state: dict = {"armed": False, "warming": False, "win": None,
                "records": None, "events": None, "patches": []}


def _timing():
    """The program's span API, or None where the program has none."""
    try:
        mod = importlib.import_module("binius_ntt_tpu_torch.utils.timing")
    except ImportError:
        return None
    return mod if hasattr(mod, "span_records") else None


def _cell_being_built():
    """(the Cell that run.run is building, its ``traced``), or (None,
    False) when no run is building one."""
    f = sys._getframe(2)
    cell = None
    while f is not None:
        here = f.f_locals
        if f.f_code.co_name == "__init__" and \
                type(here.get("self")).__name__ == "Cell":
            cell = here["self"]
        elif cell is not None and f.f_code.co_name == "run" \
                and "traced" in here:
            return cell, bool(here["traced"])
        f = f.f_back
    return None, False


def _patch(owner, attr, new) -> None:
    _state["patches"].append((owner, attr, owner.__dict__[attr]
                              if isinstance(owner, type)
                              else getattr(owner, attr)))
    setattr(owner, attr, new)


def disarm() -> None:
    """Spans off and every patch restored (an armed run that ended before
    its readers ran leaves nothing behind for the next)."""
    for owner, attr, original in reversed(_state["patches"]):
        setattr(owner, attr, original)
    _state["patches"].clear()
    if _state["armed"]:
        timing = _timing()
        timing.enable_spans(False)
        timing.set_request(None)
    _state["armed"] = False


def arm() -> None:
    """Turn the program's spans on for the traced run whose cell is being
    built (see the module docstring); nothing elsewhere."""
    cell, traced = _cell_being_built()
    if cell is None or not traced or _state.get("cell") is cell:
        return
    timing = _timing()
    if timing is None:
        return
    disarm()
    timing.span_records()                   # nothing of an earlier run
    _state.update(cell=cell, armed=True, win=None, records=None,
                  events=None)
    timing.enable_spans(True)
    timing.set_request("setup")

    program = cell.driver.Program
    call = program.__dict__["call"]

    @functools.wraps(call)
    def window_call(self, inputs, i):
        if i < 0 or _state["warming"]:      # a warm call: set-up
            return call(self, inputs, i)
        timing.set_request(i)
        try:
            return call(self, inputs, i)
        finally:
            timing.set_request(None)

    if "warm" in program.__dict__:
        warm = program.__dict__["warm"]

        @functools.wraps(warm)
        def warm_up(self, inputs):
            _state["warming"] = True
            try:
                return warm(self, inputs)
            finally:
                _state["warming"] = False

        _patch(program, "warm", warm_up)

    summarize = trace.summarize

    @functools.wraps(summarize)
    def keep_events(events, window_s):
        _state["events"] = events
        return summarize(events, window_s)

    _patch(program, "call", window_call)
    _patch(trace, "summarize", keep_events)


def records(win) -> list[dict] | None:
    """The run's span records (the program's span_records()), taken once
    after the window; None where the run had no program spans."""
    if _state["win"] is win:
        return _state["records"]
    if not _state["armed"]:
        return None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    recs = _timing().span_records()
    disarm()
    _state.update(win=win, records=recs, cell=None)
    _report(win, recs)
    return recs


def _ms(r: dict) -> float:
    return r["device_ms"] if r["device_ms"] is not None else r["host_ms"]


def _per_call(win, recs, name, value, where=None) -> float | None:
    """Mean over the window's unprofiled calls of ``value(record)`` summed
    over the call's spans named ``name`` (and ``where(attrs)``); None
    where no such span ran in those calls."""
    its = set(win.span_iterations())
    if recs is None or not its:
        return None
    total, seen = 0.0, False
    for r in recs:
        if r["name"] == name and r["request"] in its \
                and (where is None or where(r["attrs"])):
            total += value(r)
            seen = True
    return total / len(its) if seen else None


def program_ms(win, name: str, where=None) -> float | None:
    """Mean ms a window call (outside the profiled part) of the spans
    named ``name``: their device time where they have a device clock (CUDA
    events on the card, the host clock on the CPU), else their host
    time."""
    return _per_call(win, records(win), name, _ms, where)


def program_host_ms(win, name: str) -> float | None:
    """As :func:`program_ms`, on the host clock alone."""
    return _per_call(win, records(win), name, lambda r: r["host_ms"])


def program_count(win, name: str, key: str) -> float | None:
    """Mean a window call of the count ``key`` added on spans ``name``."""
    return _per_call(win, records(win), name,
                     lambda r: r["counts"].get(key, 0))


def program_setup_s(win, name: str) -> float | None:
    """Host seconds of the set-up's spans named ``name`` (0 where the
    program ran none, as ``setup.build`` on the CPU)."""
    recs = records(win)
    if recs is None:
        return None
    return sum(r["host_ms"] for r in recs
               if r["name"] == name and r["request"] == "setup") * 1e-3


def _union(intervals) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_spans_ms(win) -> tuple[float, float] | None:
    """(device-idle ms a profiled call inside the program's spans, all the
    device-idle ms a profiled call) from the window's device trace: the
    device's busy intervals (kernels, copies, sets) against the ranges the
    spans opened on the profiler's clock.  None without device records
    or spans."""
    recs = records(win)
    events = _state["events"]
    if not recs or not events or not win.profiled or not win.summary:
        return None
    names = {r["name"] for r in recs}
    busy, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        if ev.get("cat") in trace.DEVICE_CATS:
            busy.append((s, s + float(ev["dur"])))
        elif ev.get("cat") == "user_annotation" and ev.get("name") in names:
            spans.append((s, s + float(ev["dur"])))
    if not busy or not spans:
        return None
    spans = _union(spans)
    inside = sum(e - s for s, e in spans) - _overlap(spans, _union(busy))
    n = len(win.profiled)
    idle_ms = (win.summary["window_s"] - win.summary["busy_s"]) * 1e3 / n
    return inside * 1e-3 / n, idle_ms


def _report(win, recs) -> None:
    """One line a span name on standard error: its mean ms a window call
    (device, host) and its counts, beside the mean call."""
    names = sorted({r["name"] for r in recs})
    print(f"program_spans: {len(recs)} spans; mean window call "
          f"{win.mean_entry_ms()} ms", file=sys.stderr)
    for name in names:
        if name.startswith("setup."):
            print(f"program_spans: {name} set-up s "
                  f"{program_setup_s(win, name)}", file=sys.stderr)
            continue
        keys = sorted({k for r in recs if r["name"] == name
                       for k in r["counts"]})
        counts = {k: _per_call(win, recs, name,
                               lambda r, k=k: r["counts"].get(k, 0))
                  for k in keys}
        print(f"program_spans: {name} ms a call "
              f"{_per_call(win, recs, name, _ms)} (host "
              f"{_per_call(win, recs, name, lambda r: r['host_ms'])})"
              + (f"; counts a call {counts}" if counts else ""),
              file=sys.stderr)
    got = idle_in_spans_ms(win)
    if got:
        print(f"program_spans: device idle a profiled call {got[1]} ms, "
              f"{got[0]} of it inside program spans", file=sys.stderr)
