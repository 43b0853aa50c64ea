"""The port's phase timer and trace capture (utils/timing.py), on the CPU,
against the JAX package's PhaseTimer format."""

import json
import time

import jax.numpy as jnp
import pytest
import torch

from binius_ntt_tpu.utils.timing import PhaseTimer as JaxPhaseTimer
from binius_ntt_tpu_torch.utils import timing
from binius_ntt_tpu_torch.utils.timing import PhaseTimer, trace_to


def test_phases_accumulate():
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("a"):
            time.sleep(0.01)
    with t.phase("b"):
        pass
    assert list(t.phases) == ["a", "b"]
    assert t.phases["a"] >= 0.03 and t.phases["b"] >= 0.0
    assert t.phases["a"] > t.phases["b"]


def test_phase_records_its_time_when_the_body_raises():
    t = PhaseTimer()
    with pytest.raises(RuntimeError):
        with t.phase("fails"):
            raise RuntimeError("body")
    assert "fails" in t.phases


def test_report_has_the_reference_format():
    ours, ref = PhaseTimer(), JaxPhaseTimer()
    with ref.phase("upload", block_on=jnp.arange(4)):
        pass
    with ours.phase("upload", block_on=torch.arange(4)):
        pass
    assert list(ours.phases) == list(ref.phases)
    phases = {"upload": 0.001234, "transform": 0.5, "download": 4e-6}
    ours.phases, ref.phases = dict(phases), dict(phases)
    assert ours.report() == ref.report()
    assert ours.report().splitlines() == [
        "upload: 1.234 ms", "transform: 500.000 ms", "download: 0.004 ms",
        "total: 501.238 ms"]


def test_empty_report():
    assert PhaseTimer().report() == JaxPhaseTimer().report() == \
        "total: 0.000 ms"


@pytest.mark.parametrize("block_on", [
    torch.zeros(3),
    [torch.zeros(2), torch.ones(2, dtype=torch.int32)],
    (torch.zeros(1),),
    {"lo": torch.zeros(2), "hi": [torch.ones(1)]},
    [],
])
def test_block_on_takes_a_tensor_a_sequence_and_a_dict(block_on):
    t = PhaseTimer()
    with t.phase("x", block_on=block_on):
        pass
    assert t.phases["x"] >= 0.0


def test_block_on_is_read_after_the_body(monkeypatch):
    """A list the body appends its results to is what the timer waits on;
    every CUDA tensor's device is synchronised once."""
    seen = []
    monkeypatch.setattr(timing.torch.cuda, "synchronize", seen.append)

    class OnCard:
        is_cuda = True
        device = "cuda:0"

    monkeypatch.setattr(timing, "_tensors", lambda obj: iter(obj))
    out = []
    t = PhaseTimer()
    with t.phase("apply", block_on=out):
        out.extend([OnCard(), OnCard()])
    assert seen == ["cuda:0"]


def test_cpu_tensors_need_no_synchronize(monkeypatch):
    monkeypatch.setattr(timing.torch.cuda, "synchronize",
                        lambda *a: pytest.fail("synchronized a CPU tensor"))
    with PhaseTimer().phase("x", block_on={"a": torch.zeros(2)}):
        pass


def test_trace_to_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace_to(str(log_dir)) as prof:
        x = torch.arange(1 << 12, dtype=torch.int32)
        (x ^ (x << 3)).sum()
    assert prof is not None
    files = list(log_dir.glob("trace.*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]
