"""The plain references held to the repository's golden digests and to the
program's CPU path, on the CPU at small sizes."""

import hashlib
import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import ntt128, sumcheck128, tower

ROOT = Path(__file__).resolve().parents[2]


def golden128():
    """ADDITIVE_NTT128_HASHES[log_rate][log_h] of the native oracle, read
    from tests/golden_hashes_oracle.py (a plain table)."""
    spec = importlib.util.spec_from_file_location(
        "golden_hashes_oracle", ROOT / "tests" / "golden_hashes_oracle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ADDITIVE_NTT128_HASHES


def mt19937_words(seed: int, n: int) -> np.ndarray:
    """std::mt19937's raw stream (numpy's legacy seeding is its
    init_genrand)."""
    return np.random.RandomState(seed).randint(0, 2 ** 32, n,
                                               dtype=np.uint32)


@pytest.mark.parametrize("log_rate", [0, 2])
@pytest.mark.parametrize("log_h", [5, 6, 7, 9, 11])
def test_ntt_reference_golden(log_h, log_rate):
    words = mt19937_words(0xDEADBEEF + log_h + log_rate, 4 << log_h)
    out = ntt128.ntt_words(torch.from_numpy(words.view(np.int32)), log_h,
                           log_rate)
    digest = hashlib.md5(out.numpy().astype("<i4").tobytes()).hexdigest()
    assert digest == golden128()[log_rate][log_h]


def test_scalar_and_plane_products_agree():
    rng = random.Random(7)
    a = [rng.getrandbits(128) for _ in range(64)]
    b = [rng.getrandbits(128) for _ in range(64)]
    pa = tower.to_planes(torch.tensor(
        [tower.to_i32(w) for v in a for w in sumcheck128.words_of(v)],
        dtype=torch.int32))
    pb = tower.to_planes(torch.tensor(
        [tower.to_i32(w) for v in b for w in sumcheck128.words_of(v)],
        dtype=torch.int32))
    prod = tower.mul_planes(pa.T.contiguous(), pb.T.contiguous()).T
    got = tower.ints_of_batch(prod[0]) + tower.ints_of_batch(prod[1])
    assert got == [tower.mul(x, y) for x, y in zip(a, b)]
    for x in a[:8]:
        assert tower.mul(x, tower.inverse(x)) == 1


def test_layout_round_trip():
    gen = torch.Generator().manual_seed(3)
    w = torch.randint(-2 ** 31, 2 ** 31, (4 * 32 * 5,), dtype=torch.int32,
                      generator=gen)
    assert torch.equal(tower.from_planes(tower.to_planes(w)), w)


@pytest.mark.parametrize("log_h,log_rate", [(6, 0), (8, 2), (10, 1)])
def test_ntt_reference_matches_program_cpu(log_h, log_rate):
    from binius_ntt_tpu_torch.ntt.additive_bitsliced import AdditiveNTT128
    gen = torch.Generator().manual_seed(log_h)
    x = torch.randint(-2 ** 31, 2 ** 31, ((1 << log_h) // 32, 128),
                      dtype=torch.int32, generator=gen)
    want = AdditiveNTT128(log_h, log_rate, device="cpu").apply_sliced(x)
    assert torch.equal(ntt128.ntt_sliced(x, log_h, log_rate), want)


@pytest.mark.parametrize("num_vars,comp", [(6, 2), (9, 3), (10, 2)])
def test_sumcheck_reference_matches_program_cpu(num_vars, comp):
    from binius_ntt_tpu_torch.sumcheck.prover import Sumcheck
    gen = torch.Generator().manual_seed(num_vars)
    cols = torch.randint(-2 ** 31, 2 ** 31,
                         (comp, (1 << num_vars) // 32, 128),
                         dtype=torch.int32, generator=gen)
    seed, index = 2 ** 31 + 99, 5
    msgs, finals = sumcheck128.prove(cols, num_vars, seed, index)
    prover = Sumcheck(cols.clone(), comp, num_vars, data_is_transposed=True,
                      device="cpu")
    chal = sumcheck128.Challenger(seed, index)
    for r in range(num_vars + 1):
        total, points = prover.round_messages()
        assert sumcheck128.int_of(total) == msgs[r][0]
        assert [sumcheck128.int_of(p) for p in points] == msgs[r][1:]
        if r < num_vars:
            chal.observe(total, points)
            prover.move_to_next_round(chal.challenge())
    host = prover.state_dict()["host_evals"]
    got = [sum(int(b & 1) << i for i, b in enumerate(col)) for col in host]
    assert got == finals
    assert not torch.equal(cols, torch.zeros_like(cols))


def test_twiddle_rows_in_gf32_at_2e24():
    """Every generator of the 2^24 rate-2 transform lies in GF(2^32), so
    its count takes four GF(2^32) products a pair."""
    work = ntt128.stage_work(ntt128.twiddle_rows(24, 2), 24, 2)
    assert all(live and sub for live, sub in work)
    work0 = ntt128.stage_work(ntt128.twiddle_rows(24, 0), 24, 0)
    assert [live for live, _ in work0].count(False) == 1
