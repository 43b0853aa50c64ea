"""Host foundations of the torch port vs the JAX package.

mt19937 streams, the scalar tower oracle, the twiddle rows, the word
storage helpers' neighbours (capabilities gate, CUDA timing) — every
comparison exact.
"""

import numpy as np
import pytest
import torch

from binius_ntt_tpu.fields import tower_scalar as ts_jax
from binius_ntt_tpu.ntt import additive as additive_jax
from binius_ntt_tpu.utils.mt19937 import mt19937_stream as mt_jax
from binius_ntt_tpu_torch import (AdditiveNTT, AdditiveNTT128, NTTRadix2,
                                  PrimeFieldSumcheck, Sumcheck)
from binius_ntt_tpu_torch.fields import tower_scalar as ts
from binius_ntt_tpu_torch.ntt import additive
from binius_ntt_tpu_torch.ntt.nttdata import DataOrder, NTTData
from binius_ntt_tpu_torch.utils import benchlib, capabilities
from binius_ntt_tpu_torch.utils.mt19937 import MT19937, mt19937_stream


@pytest.mark.parametrize("seed,count", [
    (0xDEADBEEF + 6, 256), (0xDEADBEEF + 12, 1 << 14), (5489, 1), (7, 625),
])
def test_mt19937_matches_reference(seed, count):
    assert np.array_equal(mt19937_stream(seed, count), mt_jax(seed, count))


def test_mt19937_draws_continue_the_stream():
    gen = MT19937(5489)
    parts = [gen.draw(100), gen.draw(700), np.array([gen()], np.uint32)]
    assert np.array_equal(np.concatenate(parts), mt_jax(5489, 801))
    # std::mt19937's 10000th output for the default seed
    assert int(mt19937_stream(5489, 10000)[-1]) == 4123659995


@pytest.mark.parametrize("height", [3, 5, 7])
def test_tower_scalar_matches_reference(height):
    rng = np.random.default_rng(height)
    bits = 1 << height
    for _ in range(40):
        a = int.from_bytes(rng.bytes(16), "little") & ((1 << bits) - 1)
        b = int.from_bytes(rng.bytes(16), "little") & ((1 << bits) - 1)
        assert ts.multiply(a, b, height) == ts_jax.multiply(a, b, height)
        assert ts.square(a, height) == ts_jax.square(a, height)
        assert ts.inverse(a, height) == ts_jax.inverse(a, height)
        if a:
            assert ts.multiply(a, ts.inverse(a, height), height) == 1


@pytest.mark.parametrize("log_h,log_rate", [
    (6, 0), (9, 1), (12, 2), (16, 0), (10, 4),
])
def test_subspace_evals_match_reference(log_h, log_rate):
    got = additive.precompute_subspace_evals(log_h, log_rate, 7)
    want = additive_jax.precompute_subspace_evals(log_h, log_rate, 7)
    assert got == want


def test_stage_twiddles_match_reference():
    rows = additive.precompute_subspace_evals(8, 2, 5)
    for s in range(8):
        bits = 8 + 2 - 1 - s
        assert np.array_equal(additive.stage_twiddles(rows[s], bits),
                              additive_jax.stage_twiddles(rows[s], bits))


def test_nttdata_wrapper():
    d = NTTData(np.zeros(4, np.uint32))
    assert d.order is DataOrder.IN_ORDER
    assert NTTData(d.data, DataOrder.BIT_REVERSED).order.value == 1


def test_capabilities_gate_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capabilities.check_capabilities()


def test_capabilities_gate_refuses_other_generations(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match=r"\(9, 0\)"):
        capabilities.check_capabilities()


def test_device_time_refuses_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchlib.device_time(lambda: None)


def _numpy_prime_state():
    return np.zeros((2, 8, 4), np.uint32)


@pytest.mark.parametrize("make", [
    lambda: AdditiveNTT128(6, 0),
    lambda: AdditiveNTT(8, 0),
    lambda: NTTRadix2(137, 27, 8),
    lambda: Sumcheck(np.zeros(4 * 64 * 2, np.uint32), 2, 6),
    lambda: Sumcheck.from_state_dict({
        "num_vars": 6, "composition_size": 2, "round": 0,
        "device_evals": np.zeros((2, 2, 128), np.uint32),
        "host_evals": None}),
    lambda: PrimeFieldSumcheck(_numpy_prime_state()),
    lambda: PrimeFieldSumcheck.from_state_dict(
        {"round": 0, "evals": _numpy_prime_state()}),
], ids=["AdditiveNTT128", "AdditiveNTT", "NTTRadix2", "Sumcheck",
        "Sumcheck.from_state_dict", "PrimeFieldSumcheck",
        "PrimeFieldSumcheck.from_state_dict"])
def test_entry_points_default_to_the_card(make):
    """device=None means cuda:0; without a card that raises and asks for
    device="cpu" instead of running on the CPU silently."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present (tests/test_torch_cuda.py "
                    "checks that device=None lands on it)")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()


def test_default_device_passes_a_named_device_through():
    assert capabilities.default_device("cpu") == torch.device("cpu")
    assert capabilities.default_device(torch.device("meta")) == \
        torch.device("meta")
