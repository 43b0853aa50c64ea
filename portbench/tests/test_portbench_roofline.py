"""portbench/roofline.py reproduces the recorded bounds from shapes alone,
and its count reads nothing of the program."""

import builtins
import importlib
import sys

import pytest

from portbench import roofline


def test_mul_ops():
    assert roofline.MUL128_OPS == 10326
    assert roofline.MUL32_OPS == 1059


def test_ntt_bounds():
    assert roofline.ntt128_bound_ms(24, 2) == pytest.approx(6.383, abs=5e-4)
    assert roofline.ntt128_bound_ms(24, 0) == pytest.approx(1.529, abs=5e-4)


def test_sumcheck_bounds():
    rnd, fold = roofline.sumcheck_round_bounds_ms(2, 1 << 24)
    assert rnd == pytest.approx(0.486, abs=5e-4)
    assert fold == pytest.approx(0.324, abs=5e-4)
    # the 28-variable protocol: about twice its first round and fold
    first = sum(roofline.sumcheck_round_bounds_ms(2, 1 << 28))
    total = roofline.sumcheck_protocol_bound_ms(2, 28)
    assert 1.99 * first < total < 2.0 * first


def test_count_reads_nothing_of_the_program(monkeypatch):
    """With binius_ntt_tpu_torch unimportable (its tables, routes and
    counters out of reach) the counts are the same."""
    want = (roofline.ntt128_bound_ms(12, 2),
            roofline.sumcheck_protocol_bound_ms(3, 20))
    real_import = builtins.__import__

    def guarded(name, *args, **kwargs):
        if name.split(".")[0] == "binius_ntt_tpu_torch":
            raise ImportError("the count must not read the program")
        return real_import(name, *args, **kwargs)

    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("binius_ntt_tpu_torch", "portbench")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(builtins, "__import__", guarded)
    fresh = importlib.import_module("portbench.roofline")
    assert (fresh.ntt128_bound_ms(12, 2),
            fresh.sumcheck_protocol_bound_ms(3, 20)) == want


def test_count_ignores_replaced_tables(monkeypatch):
    """Replacing the program's table builder and route tests changes no
    count."""
    from binius_ntt_tpu_torch.ntt import additive_bitsliced, cuda_fused
    want = roofline.ntt128_bound_ms(16, 2)

    def poisoned(*args, **kwargs):
        raise AssertionError("the count read the program's tables")

    monkeypatch.setattr(cuda_fused, "build_tables", poisoned)
    monkeypatch.setattr(cuda_fused, "subfield_tables", poisoned)
    monkeypatch.setattr(additive_bitsliced, "routes", poisoned)
    assert roofline.ntt128_bound_ms(16, 2) == want
