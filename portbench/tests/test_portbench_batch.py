"""The batched rate-0 cell (ntt128-2e24-r0.sliced, driver
drivers/ntt128_batch.py) on the CPU at a small size: the run is correct,
the GF(2^32) control and the timed path's faults are caught, the batched
reference is the per-column one, and the two readers of the program's
spans read a fabricated window."""

import pytest
import torch

from portbench import program_spans, roofline, run
from portbench.reference import ntt128, ntt128_batch, tower
from portbench.tests.test_portbench_harness import (FAULTS, SEED,
                                                    expected_metrics,
                                                    ntt_faults)

ROOT = run.ROOT
CELL = "ntt128-2e24-r0.sliced"
SMALL = {"log_h": 8, "columns": 8, "batch": 4}


def cpu_run(traced=False, seed=SEED):
    return run.run(CELL, seed, 0.3, traced, device="cpu", overrides=SMALL)


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_and_is_correct(traced):
    r = cpu_run(traced)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["wrong_words"]["value"] == 0
    names = set(r["metrics"])
    if traced:
        assert names == expected_metrics(CELL, "per_layer",
                                         {"program_span", "program_counter"})
        assert names == {"ntt_batch_roofline", "ntt_copy_ms"}
    else:
        assert names == {"ntt_gbfly_per_s", "ntt_p95_ms", "setup_s"}


def test_inputs_are_whole_batches_from_the_seed():
    cell = run.Cell(CELL, overrides=SMALL)
    drv = cell.driver
    a = drv.make_inputs(cell.config, cell.traffic, SEED, "cpu")
    b = drv.make_inputs(cell.config, cell.traffic, SEED, "cpu")
    assert len(a) == SMALL["columns"] // SMALL["batch"]
    assert all(x.shape == (SMALL["batch"], (1 << SMALL["log_h"]) // 32, 128)
               for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="whole batches"):
        drv.batches({"columns": 6, "batch": 4})
    # the rate counts every column of a call
    assert drv.rate(cell.config, 10, 2.0) == pytest.approx(
        10 * 4 * (1 << 7) * 8 / 2.0 * 1e-9)


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 2 ** 32 + 13])
def test_control_fails(seed):
    """The reference in the program's place, its products cut to
    GF(2^32), comes out not correct in every batch."""
    cell = run.Cell(CELL, overrides=SMALL)
    drv = cell.driver
    inputs = drv.make_inputs(cell.config, cell.traffic, seed, "cpu")
    answers = drv.control_answers(cell.config, cell.traffic, inputs, seed)
    checks, compared, failed = drv.check(cell.config, cell.traffic, inputs,
                                         answers, seed)
    assert failed == compared == len(inputs)
    assert checks["wrong_words"][0] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught(monkeypatch, fault):
    ntt_faults(monkeypatch, fault)
    r = cpu_run()
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("log_h,log_rate", [(5, 1), (7, 0), (8, 2)])
def test_batched_reference_is_the_per_column_one(log_h, log_rate):
    g = torch.Generator().manual_seed(log_h * 8 + log_rate)
    x = torch.randint(-2 ** 31, 2 ** 31, (3, (1 << log_h) // 32, 128),
                      dtype=torch.int32, generator=g)
    before = x.clone()
    out = ntt128_batch.ntt_sliced_batch(x, log_h, log_rate)
    assert out.shape == (3, (1 << (log_h + log_rate)) // 32, 128)
    assert torch.equal(x, before)
    for b in range(3):
        assert torch.equal(out[b], ntt128.ntt_sliced(x[b], log_h, log_rate))
    cut = ntt128_batch.ntt_sliced_batch(x, log_h, log_rate,
                                        mul=tower.mul_planes_gf32)
    assert not torch.equal(cut, out)
    with pytest.raises(ValueError, match="B, nb, 128"):
        ntt128_batch.ntt_sliced_batch(x[0], log_h, log_rate)


def _record(name, request, device_ms, counts=None):
    return {"name": name, "request": request, "host_ms": device_ms + 0.5,
            "device_ms": device_ms, "attrs": {}, "counts": counts or {}}


def test_readers_of_a_fabricated_window(monkeypatch):
    """Calls 0-2, call 0 profiled: the readers take calls 1 and 2 (a
    chain of 4 columns in 14 ms and 16 ms, copies of 0.6 and 0.8 ms)."""
    cell = run.Cell(CELL)
    win = run.Window(cell, 3, {0: 20.0, 1: 15.0, 2: 17.0}, {}, {0}, None)
    recs = [_record("ntt.coset_copy", 0, 9.0),
            _record("ntt.chain", 0, 99.0, {"columns": 4}),
            _record("ntt.coset_copy", 1, 0.6),
            _record("ntt.chain", 1, 14.0, {"columns": 4}),
            _record("ntt.coset_copy", 2, 0.8),
            _record("ntt.chain", 2, 16.0, {"columns": 4}),
            _record("ntt.chain", "setup", 50.0, {"columns": 4})]
    monkeypatch.setitem(program_spans._state, "win", win)
    monkeypatch.setitem(program_spans._state, "records", recs)
    copy = run.load_module(ROOT / "portbench/metrics/ntt_copy_ms.py",
                           "ntt_copy_ms")
    share = run.load_module(ROOT / "portbench/metrics/ntt_batch_roofline.py",
                            "ntt_batch_roofline")
    assert copy.read(win) == pytest.approx(0.7)
    assert share.read(win) == pytest.approx(
        100 * 4 * roofline.ntt128_bound_ms(24, 0) / 15.0)
    # a program whose chain counts no columns, and one with no copy span
    monkeypatch.setitem(program_spans._state, "records", [
        {**r, "counts": {}} for r in recs if r["name"] == "ntt.chain"])
    assert share.read(win) is None and copy.read(win) is None
