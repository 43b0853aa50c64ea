"""The benchmark of binius_ntt_tpu_torch: one cell, one run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout.  The cell is found by name in
BENCHMARK.json: its configuration file (portbench/configs/<config>.json,
whose ``kind`` names the driver portbench/drivers/<kind>.py), its traffic
file (portbench/traffic/<traffic>.json) and, with ``--trace 1``, a reader
portbench/metrics/<metric>.py for each per-layer metric the cell reports.

A run: set-up (the program's objects, inputs made on the card from the
seed, every shape of the cell called first), then a closed loop for
``--seconds`` (one caller, each call waited for), then the check of what
the window produced against the plain reference (portbench/reference/),
then one JSON line on standard output.  With ``--trace 0`` its metrics
are the cell's end-to-end metrics; with ``--trace 1`` the per-layer ones,
read from the event pairs around the window's calls, CUDA-event spans
around the program's functions, and a ``torch.profiler`` trace of the
window's first part (its kernel records by name and its device
timeline).

Exits 2 without a result when there is no CUDA device or fewer than the
cell asks for, and 3 when jax, jaxlib, flax or binius_ntt_tpu is loaded
once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "binius_ntt_tpu")
CACHE = ROOT / ".portbench-cache"
PROFILE_SECONDS = 2.0           # of the traced window, at most a quarter


def _env() -> None:
    """Build caches inside the checkout at fixed paths; transformers, if
    anything loads it, without flax."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ["USE_FLAX"] = "0"


_env()
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from portbench import trace  # noqa: E402


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A metric reader by file (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its files."""

    def __init__(self, workload: str, root: Path = ROOT, overrides=None):
        bench = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"run.py: no workload {workload!r} in "
                             f"BENCHMARK.json ({sorted(cells)})")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.workload["config"]]
                                ["file"])
        self.config.update(overrides or {})
        here = root / "portbench"
        self.traffic = load_json(here / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.driver = importlib.import_module(
            f"portbench.drivers.{self.config['kind']}")

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
        self.readers = {m["name"]: load_module(
            here / "metrics" / f"{m['name']}.py", m["name"])
            for m in self.per_layer}


class Window:
    """What the window and the traced part of it recorded, for readers."""

    def __init__(self, cell: Cell, calls: int, entry_ms: dict, spans: dict,
                 profiled: set, summary):
        self.config = cell.config
        self.calls = calls
        self.entry_ms = entry_ms          # {iteration: ms of the call}
        self.spans = spans                # {target: {iteration: ms}}
        self.profiled = profiled          # iterations under the profiler
        self.summary = summary            # DeviceTrace.summary or None

    def span_iterations(self) -> list[int]:
        """Window iterations outside the profiled part."""
        return [i for i in sorted(self.entry_ms) if i not in self.profiled]

    def mean_entry_ms(self) -> float | None:
        """Mean ms of a window call outside the profiled part."""
        its = self.span_iterations()
        if not its:
            return None
        return sum(self.entry_ms[i] for i in its) / len(its)

    def profiled_kernel_ms(self, prefixes: tuple) -> float | None:
        """Device ms a profiled call spent in the kernels whose names (as
        trace.short_name gives them) start with one of ``prefixes``, from
        the profiler's kernel records; None where it recorded none."""
        if not self.summary or not self.profiled:
            return None
        s = sum(v for name, v in self.summary["op_s"].items()
                if name.startswith(prefixes))
        return s * 1e3 / len(self.profiled) if s > 0 else None

    def mean_span_ms(self, target: str) -> float | None:
        """Mean over the unprofiled iterations of a span's ms in each."""
        its = self.span_iterations()
        got = self.spans.get(target, {})
        if not its or not got:
            return None
        return sum(got.get(i, 0.0) for i in its) / len(its)


def p95(values) -> float:
    """95th percentile, nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, traced: bool,
        device=None, t0: float | None = None, root: Path = ROOT,
        overrides=None) -> dict | None:
    """One run of a cell; returns the result line as a dict (with
    "checks" last), on rank 0 of a process group and None on the others.
    ``device``: the card by default (``cuda:<rank>`` under a group); the
    in-process tests pass the CPU and ``overrides`` of configuration
    keys."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(workload, root, overrides)
    rank, world = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device(device or f"cuda:{rank}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    drv = cell.driver
    torch.set_num_threads(4)

    # ---- set-up ------------------------------------------------------------
    inputs = drv.make_inputs(cell.config, cell.traffic, seed, device,
                             rank=rank, world=world)
    program = drv.Program(cell.config, cell.traffic, device, seed)
    if hasattr(program, "warm"):
        program.warm(inputs)
    for k in range(cell.traffic["warm_calls"]):
        program.call(inputs, -1 - k)
    synchronize(device)
    spans = trace.Spans(device)
    if traced:
        for reader in cell.readers.values():
            for target in getattr(reader, "SPANS", ()):
                spans.wrap(target)
        # a wrapped call under the profiler once outside the window, so
        # nothing of the wrappers' or the profiler's first use lands in it
        spans.iteration = -1
        first = trace.DeviceTrace()
        first.start()
        program.call(inputs, -1)
        first.stop()
        spans.iteration = None
        spans.records.clear()
    event = trace.event_factory(device)
    sampler = drv.Sampler(cell.traffic, seed)
    if world > 1:
        # the ranks agree on the window's end over the host (gloo), so no
        # collective of the harness runs on the cards in the window
        flags = dist.new_group(backend="gloo")
        pending = None
    synchronize(device)
    setup_s = time.perf_counter() - t0

    # ---- window ------------------------------------------------------------
    device_trace = trace.DeviceTrace() if traced else None
    profile_s = min(PROFILE_SECONDS, seconds / 4)
    profiled = set()
    marks = []
    i = 0
    if device_trace:
        device_trace.start()
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    start = time.perf_counter()
    while True:
        now = time.perf_counter() - start
        if world > 1:
            # every rank makes as many calls, and the first rank past the
            # window ends it for all, a call late: each rank posts its
            # flag before a call and reads the ranks' flags of the call
            # before, so no rank's call waits on the other hosts
            if pending is not None:
                pending.wait()
                if stop[0]:
                    break
            stop = torch.tensor([int(now >= seconds)], dtype=torch.int32)
            pending = dist.all_reduce(stop, op=dist.ReduceOp.MAX,
                                      group=flags, async_op=True)
        elif now >= seconds:
            break
        if device_trace and device_trace.summary is None:
            if now < profile_s:
                profiled.add(i)
            else:
                device_trace.stop()
        spans.iteration = i
        s, e = event(), event()
        s.record()
        answer = program.call(inputs, i)
        e.record()
        synchronize(device)
        marks.append((s, e))
        sampler.offer(i, answer)
        del answer
        i += 1
    window_s = time.perf_counter() - start
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    spans.iteration = None
    if device_trace and device_trace.summary is None:
        device_trace.stop()
    synchronize(device)
    entry_ms = {k: s.elapsed_time(e) for k, (s, e) in enumerate(marks)}
    span_ms = spans.durations()
    spans.restore()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # ---- check -------------------------------------------------------------
    program.release()
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, compared, failed = drv.check(cell.config, cell.traffic, inputs,
                                         sampler.answers(), seed)
    print(f"run.py: rank {rank}: set-up {setup_s:.3f} s, window "
          f"{window_s:.3f} s ({i} calls), check "
          f"{time.perf_counter() - t_check:.3f} s ({compared} answers)",
          file=sys.stderr)
    thirds = [[entry_ms[k] for k in range(i) if 3 * k // i == t]
              for t in range(3)] if i >= 3 else []
    cpu_s = (use1.ru_utime + use1.ru_stime) - (use0.ru_utime
                                               + use0.ru_stime)
    print(f"run.py: rank {rank}: ms a call by window third "
          + " / ".join(f"{sum(t) / len(t):.3f}" for t in thirds)
          + f"; the process's CPU {cpu_s:.3f} s in the window, "
          f"{use1.ru_nivcsw - use0.ru_nivcsw} involuntary context "
          f"switches", file=sys.stderr)

    # ---- metrics -----------------------------------------------------------
    win = Window(cell, i, entry_ms, span_ms, profiled,
                 device_trace.summary if device_trace else None)
    layer = {}
    if traced:
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(win)
            if value is not None:
                layer[m["name"]] = value
    mine = {"calls": i, "window_s": window_s, "setup_s": setup_s,
            "entry_ms": [entry_ms[k] for k in range(i)], "layer": layer,
            "summary": win.summary, "peak": peak, "checks": checks,
            "failed": failed}
    if world > 1:
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        if rank != 0:
            return None
    else:
        ranks = [mine]
    return combine(cell, drv, ranks, traced, device)


def combine(cell: Cell, drv, ranks: list, traced: bool, device) -> dict:
    """The result line from every rank's readings: the rate over rank 0's
    window (the ranks call in step), each call's time on the slowest rank,
    the per-layer metrics of the slowest rank (the most ms a call), the
    device's busy time averaged over the ranks, the fullest card's peak,
    the checks summed."""
    first = ranks[0]
    calls = first["calls"]
    metrics = {}
    if traced:
        slowest = max(ranks, key=lambda r: sum(r["entry_ms"])
                      / max(1, len(r["entry_ms"])))
        for m in cell.per_layer:
            if m["name"] in slowest["layer"]:
                metrics[m["name"]] = {"value": slowest["layer"][m["name"]],
                                      "unit": m["unit"]}
    else:
        per_call = [max(r["entry_ms"][k] for r in ranks)
                    for k in range(calls)]
        values = {"setup_s": max(r["setup_s"] for r in ranks),
                  drv.RATE[0]: drv.rate(cell.config, calls,
                                        first["window_s"]),
                  drv.LATENCY[0]: p95(per_call) if per_call else None}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    checks = {}
    for name, (_, op, lim) in first["checks"].items():
        checks[name] = (sum(r["checks"][name][0] for r in ranks), op, lim)
    correct = calls > 0 and all(v <= lim if op == "<=" else v >= lim
                                for v, op, lim in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": len(ranks),
           "memory_peak_bytes": max(r["peak"] for r in ranks)}
    result = {"correct": correct, "attempted": calls,
              "failed": sum(r["failed"] for r in ranks),
              "metrics": metrics, "device": dev}
    if traced:
        summ = [r["summary"] for r in ranks]
        dev["busy_s"] = sum(x["busy_s"] for x in summ) / len(summ)
        dev["window_s"] = sum(x["window_s"] for x in summ) / len(summ)
        result["breakdown"] = {"device_ops": summ[0]["device_ops"],
                               "idle_gaps": summ[0]["idle_gaps"]}
    result["checks"] = {k: {"value": v, "holds": op, "limit": lim}
                        for k, (v, op, lim) in checks.items()}
    return result


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def launch(argv: list, world: int) -> int:
    """Start ``world`` ranks of this command, one a card, joined by a
    process group on a local port; relay rank 0's result line.  A rank
    that fails ends the others."""
    init = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryFile(mode="w+") as out:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), *argv,
             "--rank", str(r), "--world", str(world), "--init", init],
            stdout=out if r == 0 else subprocess.DEVNULL)
            for r in range(world)]
        rc = 0
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    rc = next(p.returncode for p in procs
                              if p.poll() not in (None, 0))
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
        if rc:
            print(f"run.py: a rank exited with {rc}; no result",
                  file=sys.stderr)
            return rc
        out.seek(0)
        lines = out.read().strip().splitlines()
    found = forbidden_modules()
    if found or not lines:
        print(f"run.py: the launcher loaded {found}; no result" if found
              else "run.py: rank 0 printed no result", file=sys.stderr)
        return 3
    print(lines[-1], flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank started by the launcher, and the CPU rehearsal of a run
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else argv
    args = ap.parse_args(argv)
    need = Cell(args.workload).workload["chips"]
    if not args.cpu_rehearsal and (not torch.cuda.is_available()
                                   or torch.cuda.device_count() < need):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell needs {need} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    if need > 1 and args.rank is None:
        return launch(argv, need)
    if args.rank is not None:
        dist.init_process_group(
            backend="gloo" if args.cpu_rehearsal else "nccl",
            init_method=args.init, world_size=args.world, rank=args.rank)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t0=T0,
                     device="cpu" if args.cpu_rehearsal else None)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    found = forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found}; no result",
              file=sys.stderr)
        return 3
    if result is None:          # a rank other than 0
        return 0
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['holds']} {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
