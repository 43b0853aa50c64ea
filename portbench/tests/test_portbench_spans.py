"""The readers of the program's own spans and counts
(portbench/program_spans.py) on the CPU: the four-rank cell's metrics in
a traced rehearsal, the exchange count against the shard's shape, a
program without spans and an untraced run left alone, and the device
idle inside the spans from a device trace's events."""

import json

import pytest

from portbench import program_spans, run
from portbench.tests.test_portbench_harness import SEED, SMALL, cpu_run
from portbench.tests.test_portbench_sharded import (  # noqa: F401
    CELL, LOG_H, checkout, rehearse)

ROOT = run.ROOT


def _program_metrics(workload):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["source"] in ("program_span", "program_counter")}


def test_four_ranks_read_every_program_metric(checkout):  # noqa: F811
    """Each program_span and program_counter metric of the four-rank cell
    reads a value, and the bytes a rank sends a transform are those of
    the shapes: one whole shard a cross-device stage."""
    base, co, env = checkout
    p = rehearse(co, env, 1)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert _program_metrics(CELL) <= set(r["metrics"])
    config = json.loads((co / "portbench/configs/ntt128-2e28-r2-x4.json")
                        .read_text())
    world = config["devices"]
    stages = world.bit_length() - 1
    shard_bytes = (1 << config["log_rate"]) * ((1 << LOG_H) // 32
                                               // world) * 128 * 4
    assert r["metrics"]["exchange_mb_per_call"]["value"] == \
        stages * shard_bytes / 1e6
    for name in ("exchange_wait_ms", "cross_mul_ms"):
        assert r["metrics"][name]["value"] > 0
    assert r["metrics"]["exchange_wait_ms"]["value"] \
        + r["metrics"]["cross_mul_ms"]["value"] \
        <= r["metrics"]["cross_stages_ms"]["value"]


def test_a_program_without_spans_gives_nothing(monkeypatch):
    """A program whose timing module has no spans (as before they were
    added): a traced run is correct and reads none of the new metrics."""
    monkeypatch.setattr(program_spans, "_timing", lambda: None)
    wl = "sumcheck128-28v-c2.prove"
    r = cpu_run(wl, traced=True)
    assert r["correct"]
    assert not _program_metrics(wl) & set(r["metrics"])


@pytest.mark.parametrize("workload", ["ntt128-2e24-r2.compact",
                                      "sumcheck128-28v-c2.prove"])
def test_an_untraced_run_turns_no_span_on(monkeypatch, workload):
    from binius_ntt_tpu_torch.utils import timing

    def refuse(*a, **k):
        raise AssertionError("the span API was called")
    for name in ("enable_spans", "set_request", "span_records"):
        monkeypatch.setattr(timing, name, refuse)
    r = cpu_run(workload, traced=False)
    assert r["correct"] and not timing.spans_enabled()


def test_spans_are_off_after_a_traced_run():
    from binius_ntt_tpu_torch.utils import timing
    r = cpu_run("ntt128-2e24-r2.sliced", traced=True)
    assert r["correct"] and "ntt_bottom_group_ms" in r["metrics"]
    assert not timing.spans_enabled() and timing.span_records() == []


def test_idle_inside_spans_from_the_device_trace(monkeypatch):
    """Busy 0-10 and 20-30 us, a program span 5-25 us, a 50 us profiled
    window of one call: 30 us idle, 10 of it inside the span."""
    cell = run.Cell("sumcheck128-28v-c2.prove")
    summary = {"busy_s": 20e-6, "window_s": 50e-6, "op_s": {},
               "device_ops": [], "idle_gaps": []}
    win = run.Window(cell, 2, {0: 1.0, 1: 1.0}, {}, {0}, summary)
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 20.0, "dur": 10.0},
        {"ph": "X", "cat": "user_annotation", "name": "sumcheck.readback",
         "ts": 5.0, "dur": 20.0},
        {"ph": "X", "cat": "user_annotation", "name": "caller",
         "ts": 30.0, "dur": 15.0}]
    recs = [{"name": "sumcheck.readback", "request": 0, "host_ms": 0.02,
             "device_ms": None, "attrs": {}, "counts": {}}]
    monkeypatch.setitem(program_spans._state, "win", win)
    monkeypatch.setitem(program_spans._state, "records", recs)
    monkeypatch.setitem(program_spans._state, "events", events)
    inside, idle = program_spans.idle_in_spans_ms(win)
    assert inside == pytest.approx(0.010)
    assert idle == pytest.approx(0.030)
    reader = run.load_module(ROOT / "portbench/metrics/prover_idle_ms.py",
                             "prover_idle_ms")
    assert reader.read(win) == pytest.approx(0.010)


def test_setup_spans_are_read_from_the_set_up():
    """The set-up's spans, the warm calls' among them (the compact cell
    warms every column by its index), are the request "setup"; the
    window's calls are their iterations."""
    r = cpu_run("ntt128-2e24-r2.compact", traced=True, seed=SEED + 1)
    assert r["metrics"]["setup_tables_s"]["value"] > 0
    assert r["metrics"]["setup_build_s"]["value"] == 0.0    # no card
    requests = [x["request"] for x in program_spans._state["records"]
                if x["name"] == "ntt.apply"]
    columns = SMALL["ntt128-2e24-r2.compact"]["columns"]
    window = [q for q in requests if q != "setup"]
    assert requests.count("setup") >= columns
    assert window == list(range(r["attempted"]))
