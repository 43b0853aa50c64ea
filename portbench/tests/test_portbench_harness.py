"""The harness on the CPU at small sizes: every cell runs and is correct;
a cell, configuration, traffic mix or metric is added by files and
entries alone; the check fails the control and every fault of the timed
path; a run without a card gives no result."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 77
SMALL = {"ntt128-2e24-r2.compact": {"log_h": 8, "columns": 3},
         "ntt128-2e24-r2.sliced": {"log_h": 8, "columns": 3},
         "sumcheck128-28v-c2.prove": {"num_vars": 8}}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cpu_run(workload, traced=False, seconds=0.3, seed=SEED, root=ROOT,
            overrides=None):
    return run.run(workload, seed, seconds, traced, device="cpu", root=root,
                   overrides=SMALL.get(workload) if overrides is None
                   else overrides)


def expected_metrics(workload, key, sources=None):
    return {m["name"] for m in bench()[key]
            if ("workloads" not in m or workload in m["workloads"])
            and (sources is None or m["source"] in sources)}


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_and_is_correct(workload, traced):
    r = cpu_run(workload, traced)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    names = set(r["metrics"])
    if traced:
        # the readers of the device trace find nothing to read on the CPU
        assert names == expected_metrics(workload, "per_layer",
                                         {"program_span", "program_counter"})
        assert r["device"]["busy_s"] == 0.0
    else:
        assert names == expected_metrics(workload, "end_to_end")
        assert all(v["value"] > 0 for v in r["metrics"].values())


def test_every_cell_reports_setup_and_more():
    b = bench()
    for w in b["workloads"]:
        e2e = expected_metrics(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert expected_metrics(w["name"], "per_layer")
    moved = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        for w in m["workloads"]:
            assert w in moved[m["moves"]].get("workloads", [w])


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_need_no_edit(tmp_path):
    """A configuration, traffic mix and metric placed beside the others,
    with their entries in BENCHMARK.json, run with no other change."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    before = _digests(tmp_path / "portbench")
    (tmp_path / "portbench/configs/ntt128-2e9-r1.json").write_text(
        json.dumps({"kind": "ntt128", "log_h": 9, "log_rate": 1,
                    "columns": 2}))
    (tmp_path / "portbench/traffic/sliced-pool2.json").write_text(
        json.dumps({"entry": "apply_sliced", "sample": 2, "warm_calls": 3,
                    "loop": "closed", "clients": 1}))
    (tmp_path / "portbench/metrics/calls_in_window.py").write_text(
        "def read(win):\n    return float(win.calls)\n")
    name = "ntt128-2e9-r1.sliced-pool2"
    b["configs"].append({"name": "ntt128-2e9-r1", "source": "test",
                         "file": "portbench/configs/ntt128-2e9-r1.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": name, "config": "ntt128-2e9-r1",
                           "traffic": "sliced-pool2", "chips": 1,
                           "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "ntt_gbfly_per_s":
            m["workloads"].append(name)
    b["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry", "moves": "ntt_gbfly_per_s",
                           "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    plain = cpu_run(name, root=tmp_path, overrides={})
    traced = cpu_run(name, traced=True, root=tmp_path, overrides={})
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"ntt_gbfly_per_s", "setup_s"}
    assert traced["metrics"]["calls_in_window"]["value"] >= 1
    after = _digests(tmp_path / "portbench")
    assert all(after[p] == d for p, d in before.items())


# ---- the control and the faults ---------------------------------------------

@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 2 ** 32 + 13])
def test_control_fails(workload, seed):
    """The reference in the program's place, its products cut to
    GF(2^32), comes out not correct."""
    cell = run.Cell(workload, overrides=SMALL[workload])
    drv = cell.driver
    inputs = drv.make_inputs(cell.config, cell.traffic, seed, "cpu")
    answers = drv.control_answers(cell.config, cell.traffic, inputs, seed)
    if "sample" in cell.traffic:
        cell.traffic["sample"] = len(answers)
    checks, compared, failed = drv.check(cell.config, cell.traffic, inputs,
                                         answers, seed)
    assert failed == compared > 0
    assert checks["wrong_words"][0] > 0


def _flip(t: torch.Tensor) -> torch.Tensor:
    t.view(-1)[t.numel() // 3] ^= 1 << 7
    return t


def ntt_faults(monkeypatch, fault):
    from binius_ntt_tpu_torch.ntt import cuda_fused
    apply_fused = cuda_fused.apply_fused
    if fault == "state_unchanged":
        monkeypatch.setattr(cuda_fused, "stage_group",
                            lambda x, *a, **k: x)
    elif fault == "answer_altered":
        monkeypatch.setattr(cuda_fused, "apply_fused",
                            lambda *a, **k: _flip(apply_fused(*a, **k)))
    elif fault == "half_left_out":
        def half(*a, **k):
            out = apply_fused(*a, **k)
            out[out.shape[0] // 2:] = 0
            return out
        monkeypatch.setattr(cuda_fused, "apply_fused", half)


def sumcheck_faults(monkeypatch, fault):
    from binius_ntt_tpu_torch.sumcheck import cuda_round
    round_kernel = cuda_round.round_kernel
    if fault == "state_unchanged":
        monkeypatch.setattr(cuda_round, "fold_kernel",
                            lambda evals, *a, **k: evals)
    elif fault == "answer_altered":
        monkeypatch.setattr(cuda_round, "round_kernel",
                            lambda *a, **k: _flip(round_kernel(*a, **k)))
    elif fault == "half_left_out":
        def half(evals, rows, *a, **k):
            if rows >= 4:
                rows //= 2
            return round_kernel(evals, rows, *a, **k)
        monkeypatch.setattr(cuda_round, "round_kernel", half)


FAULTS = ("state_unchanged", "answer_altered", "half_left_out")


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught(monkeypatch, workload, fault):
    """The run with the timed path broken underneath (the look for a
    card skipped) comes out not correct."""
    if workload.startswith("ntt"):
        ntt_faults(monkeypatch, fault)
    else:
        sumcheck_faults(monkeypatch, fault)
    r = cpu_run(workload)
    assert not r["correct"] and r["failed"] > 0


# ---- the readers of the device trace -----------------------------------------

def _window(summary, profiled, entry_ms):
    cell = run.Cell("sumcheck128-28v-c2.prove")
    return run.Window(cell, len(entry_ms), entry_ms, {}, profiled, summary)


def test_sumcheck_readers_take_the_profilers_kernel_records():
    """Kernel ms a protocol: the named kernels' seconds over the profiled
    protocols; the host's ms: an unprofiled protocol's ms less that."""
    summary = {"busy_s": 1.0, "window_s": 2.0, "device_ops": [],
               "idle_gaps": [],
               "op_s": {"sumcheck_round_kernel": 0.8,
                        "sumcheck_fold_kernel<false>": 0.3,
                        "sumcheck_fold_kernel<true>": 0.1,
                        "Memcpy DtoD (Device -> Device)": 0.5}}
    win = _window(summary, {0, 1, 2, 3}, {0: 400.0, 1: 400.0, 2: 400.0,
                                          3: 400.0, 4: 330.0, 5: 350.0})
    kernel_ms = 1.2e3 / 4
    bound = run.load_module(
        ROOT / "portbench/metrics/sumcheck_kernels_roofline.py", "r")
    host = run.load_module(ROOT / "portbench/metrics/prover_host_ms.py",
                           "h")
    from portbench import roofline
    assert bound.read(win) == pytest.approx(
        100 * roofline.sumcheck_protocol_bound_ms(2, 28) / kernel_ms)
    assert host.read(win) == pytest.approx(340.0 - kernel_ms)


def test_sumcheck_readers_read_nothing_without_kernel_records():
    summary = {"busy_s": 0.5, "window_s": 2.0, "device_ops": [],
               "idle_gaps": [], "op_s": {"Memcpy DtoD": 0.5}}
    for s in (summary, None):
        win = _window(s, {0}, {0: 90.0, 1: 80.0})
        for name in ("sumcheck_kernels_roofline", "prover_host_ms"):
            reader = run.load_module(
                ROOT / f"portbench/metrics/{name}.py", name)
            assert reader.read(win) is None


# ---- the process ----------------------------------------------------------

def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "binius_ntt_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ntt128-2e24-r2.sliced", "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert p.returncode == 2 and p.stdout == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ has no
    program: the run exits with an error and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ntt128-2e24-r2.sliced", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_control_fails_on_the_card_at_size():
    """The control at the sliced cell's own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = run.Cell("ntt128-2e24-r2.sliced")
    drv = cell.driver
    cell.config["columns"] = 1
    inputs = drv.make_inputs(cell.config, cell.traffic, SEED, "cuda")
    answers = drv.control_answers(cell.config, cell.traffic, inputs, SEED)
    checks, compared, failed = drv.check(cell.config, cell.traffic, inputs,
                                         answers, SEED)
    assert failed == compared == 1 and checks["wrong_words"][0] > 0
