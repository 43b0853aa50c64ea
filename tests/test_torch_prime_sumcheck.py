"""The torch port's QM31 sumcheck prover against the JAX package.

Same seeded inputs through both packages, exact word equality everywhere
(a prime field has no rounding): the M31 and QM31 ops, the round and fold
plain versions against the JAX prover's own kernels (``_round_kernel``,
``_fold_kernel``) and the Pallas kernels' emulation twins
(``round_emulate``, ``fold_emulate``) at full and partial live rows, the
protocol round by round, the reference's arange test, resume in both
directions, and the host transcript check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.fields import m31 as m31_jax
from binius_ntt_tpu.sumcheck import pallas_prime_round as ppr
from binius_ntt_tpu.sumcheck import prime_field as pf_jax
from binius_ntt_tpu_torch import PrimeFieldSumcheck
from binius_ntt_tpu_torch.convert import prime_sumcheck_state_from_jax
from binius_ntt_tpu_torch.fields import m31
from binius_ntt_tpu_torch.sumcheck import cuda_prime_round as cpr
from binius_ntt_tpu_torch.sumcheck.prime_field import (check_transcript,
                                                       interpolate_at_host)
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch

P = m31.P


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=shape, dtype=np.uint32)


def _port(fn, *words):
    return to_numpy(fn(*(to_torch(w) for w in words)))


def _jax(fn, *words):
    return np.asarray(fn(*(jnp.asarray(w) for w in words)))


def test_m31_ops_match_jax():
    a, b = _rand(8192, 1), _rand(8192, 2)
    a[:5] = (0, 1, P - 1, P - 1, 1 << 30)
    b[:5] = (P - 1, P - 1, P - 1, 1, 1 << 30)
    for port, ref in ((m31.m31_add, m31_jax.m31_add),
                      (m31.m31_sub, m31_jax.m31_sub),
                      (m31.m31_mul, m31_jax.m31_mul)):
        assert np.array_equal(_port(port, a, b), _jax(ref, a, b))


def test_m31_add_canonicalises_p_alias():
    """tests/test_prime_sumcheck.py:55-64: a + b == P gives 0, not P."""
    out = _port(m31.m31_add, np.array([1, 5, P - 1], np.uint32),
                np.array([P - 1, 3, P - 1], np.uint32))
    assert np.array_equal(out, np.array([0, 8, P - 2], np.uint32))


def test_qm31_ops_match_jax():
    x, y = _rand((4096, 4), 3), _rand((4096, 4), 4)
    x[0], y[0] = (P - 1,) * 4, (P - 1,) * 4
    for port, ref in ((m31.qm31_add, m31_jax.qm31_add),
                      (m31.qm31_sub, m31_jax.qm31_sub),
                      (m31.qm31_mul, m31_jax.qm31_mul)):
        assert np.array_equal(_port(port, x, y), _jax(ref, x, y))
    for i in range(16):
        assert np.array_equal(m31.qm31_mul_host(x[i], y[i]),
                              m31_jax.qm31_mul_host(x[i], y[i]))
        assert np.array_equal(m31.qm31_add_host(x[i], y[i]),
                              m31_jax.qm31_add_host(x[i], y[i]))
        assert np.array_equal(m31.qm31_sub_host(x[i], y[i]),
                              m31_jax.qm31_sub_host(x[i], y[i]))
    assert np.array_equal(m31.qm31_scalar(P + 5), m31_jax.qm31_scalar(P + 5))


@pytest.mark.parametrize("rows,live", [(4096, 4096), (4096, 1024),
                                       (4096, 2), (512, 256)])
def test_round_and_fold_plain_match_jax_kernels(rows, live):
    evals = _rand((2, rows, 4), rows + live)
    ch = _rand(4, 9 + live)
    want_r = np.asarray(pf_jax._round_kernel(jnp.asarray(evals),
                                             jnp.int32(live)))
    got_r = to_numpy(cpr.round_plain(to_torch(evals), live))
    assert np.array_equal(got_r, want_r)
    want_f = np.asarray(pf_jax._fold_kernel(jnp.asarray(evals), ch,
                                            jnp.int32(live)))
    x = to_torch(evals)
    assert cpr.fold_plain(x, ch, live) is x
    # only the folded live/2 prefix is contractual; both leave the rest
    assert np.array_equal(to_numpy(x)[:, :live // 2], want_f[:, :live // 2])
    assert np.array_equal(to_numpy(x)[:, live // 2:], evals[:, live // 2:])


@pytest.mark.parametrize("live", [4096, 1024, 256])
def test_round_and_fold_plain_match_pallas_emulation(live):
    """The Pallas kernels' math through its jnp twins (round_emulate and
    fold_emulate need live >= 2 * 128 rows, one planar row a half)."""
    rows = 4096
    evals = _rand((2, rows, 4), 50 + live)
    ch = _rand(4, 60 + live)
    planar = ppr.planar_from_aos(jnp.asarray(evals))
    want_r = np.asarray(ppr.round_emulate(planar, live))
    assert np.array_equal(to_numpy(cpr.round_plain(to_torch(evals), live)),
                          want_r)
    want_f = np.asarray(ppr.aos_from_planar(ppr.fold_emulate(
        planar, jnp.asarray(ch), live)))
    got_f = to_numpy(cpr.fold_plain(to_torch(evals), ch, live))
    assert np.array_equal(got_f[:, :live // 2], want_f[:, :live // 2])


def test_wrappers_on_cpu_run_the_plain_versions_and_refuse():
    evals = to_torch(_rand((2, 64, 4), 7))
    ch = _rand(4, 8)
    before = (cpr.round_kernel.launches, cpr.fold_kernel.launches)
    assert torch.equal(cpr.round_kernel(evals, 64),
                       cpr.round_plain(evals, 64))
    assert torch.equal(cpr.fold_kernel(evals.clone(), ch, 64),
                       cpr.fold_plain(evals.clone(), ch, 64))
    assert (cpr.round_kernel.launches, cpr.fold_kernel.launches) == before
    with pytest.raises(ValueError, match="rows"):
        cpr.round_kernel(evals, 3)
    with pytest.raises(ValueError, match="rows"):
        cpr.fold_kernel(evals, ch, 128)
    with pytest.raises(ValueError, match="int32"):
        cpr.round_kernel(evals.long(), 64)
    with pytest.raises(ValueError, match="contiguous"):
        cpr.round_kernel(evals[:, ::2], 32)
    with pytest.raises(ValueError, match="canonical"):
        cpr.fold_kernel(evals, np.array([P, 0, 0, 0], np.uint32), 64)
    with pytest.raises(ValueError, match="4 words"):
        cpr.fold_kernel(evals, [1, 2, 3], 64)


def _transcript(prover, challenges):
    msgs = []
    for ch in challenges:
        msgs.append(np.asarray(prover.round_messages()))
        prover.fold(ch)
    return msgs


@pytest.mark.parametrize("num_vars", [12, 14])
def test_protocol_matches_jax_round_by_round(num_vars):
    evals = _rand((2, 1 << num_vars, 4), 100 + num_vars)
    challenges = _rand((num_vars, 4), 200 + num_vars)
    ref = pf_jax.PrimeFieldSumcheck(evals, use_pallas=False)
    port = PrimeFieldSumcheck(evals, device="cpu")
    for rnd, ch in enumerate(challenges):
        want = ref.round_messages()
        got = port.round_messages()
        assert got.dtype == np.uint32 and got.shape == (3, 4)
        assert np.array_equal(got, want), rnd
        ref.fold(ch)
        port.fold(ch)
    final = np.asarray(ref.state_dict()["evals"])
    assert np.array_equal(port.state_dict()["evals"], final)
    assert final.shape == (2, 1, 4) and port.round == num_vars


def test_arange_protocol_with_the_reference_challenge():
    """tests/test_prime_sumcheck.py:25-52 (after test_sumcheck.cu:9-99):
    evals[i] = QM31(i) in both columns, the fixed challenge, the claim
    checked every round and against the final product."""
    num_vars = 12
    n = 1 << num_vars
    col = np.zeros((n, 4), np.uint32)
    col[:, 0] = np.arange(n, dtype=np.uint32)
    evals = np.stack([col, col])
    claim = np.array([sum(i * i for i in range(n)) % P, 0, 0, 0], np.uint32)
    challenge = np.array([32482843 % P, 85864538 % P, 8348234 % P,
                          9544334 % P], np.uint32)
    s = PrimeFieldSumcheck(evals, device="cpu")
    messages = _transcript(s, [challenge] * num_vars)
    final = s.state_dict()["evals"][:, 0]
    assert np.array_equal(
        check_transcript(messages, [challenge] * num_vars, final,
                         claim=claim), claim)
    with pytest.raises(ValueError, match="ended"):
        s.round_messages()


def test_check_transcript_refuses_tampering():
    num_vars = 8
    evals = _rand((2, 1 << num_vars, 4), 5)
    challenges = _rand((num_vars, 4), 6)
    s = PrimeFieldSumcheck(evals, device="cpu")
    messages = _transcript(s, challenges)
    final = s.state_dict()["evals"][:, 0]
    check_transcript(messages, challenges, final)
    bad = [m.copy() for m in messages]
    bad[3][2, 0] = (bad[3][2, 0] + 1) % P          # p(2) of round 3
    with pytest.raises(ValueError, match="round 4"):
        check_transcript(bad, challenges, final)
    with pytest.raises(ValueError, match="final"):
        check_transcript(messages, challenges, final[::-1] + 1)
    with pytest.raises(ValueError, match="messages"):
        check_transcript(messages[:-1], challenges, final)


def test_resume_from_jax_and_back():
    num_vars = 12
    evals = _rand((2, 1 << num_vars, 4), 300)
    challenges = _rand((num_vars, 4), 301)
    ref = pf_jax.PrimeFieldSumcheck(evals, use_pallas=False)
    _transcript(ref, challenges[:3])
    port = PrimeFieldSumcheck.from_state_dict(
        prime_sumcheck_state_from_jax(ref.state_dict()), device="cpu")
    assert port.round == 3
    assert all(np.array_equal(a, b) for a, b in zip(
        _transcript(port, challenges[3:]), _transcript(ref, challenges[3:])))
    # and back: the port's state dict resumes in JAX
    port2 = PrimeFieldSumcheck(evals, device="cpu")
    ref2 = pf_jax.PrimeFieldSumcheck(evals, use_pallas=False)
    _transcript(port2, challenges[:5])
    _transcript(ref2, challenges[:5])
    d = port2.state_dict()
    assert d["round"] == 5 and d["evals"].dtype == np.uint32
    assert d["evals"].shape == (2, 1 << (num_vars - 5), 4)
    back = pf_jax.PrimeFieldSumcheck.from_state_dict(d, use_pallas=False)
    assert back.round == 5
    assert all(np.array_equal(a, b) for a, b in zip(
        _transcript(port2, challenges[5:]),
        _transcript(back, challenges[5:])))
    # the dict is copied, so it resumes twice, and a resumed tensor state
    # stays on the tensor's device
    again = PrimeFieldSumcheck.from_state_dict(
        prime_sumcheck_state_from_jax(d, "cpu"))
    assert again.device == torch.device("cpu") and again.round == 5


def test_ctor_validates_and_copies():
    evals = _rand((2, 64, 4), 9)
    t = to_torch(evals)
    s = PrimeFieldSumcheck(t)
    assert s.device == torch.device("cpu")
    s.fold(_rand(4, 10))
    assert torch.equal(t, to_torch(evals))
    with pytest.raises(ValueError, match="power of two"):
        PrimeFieldSumcheck(evals[:, :48], device="cpu")
    with pytest.raises(ValueError, match="QM31"):
        PrimeFieldSumcheck(evals[:1], device="cpu")
    with pytest.raises(ValueError, match="int32"):
        PrimeFieldSumcheck(t.long())


def test_interpolate_at_host_matches_jax():
    # test_sumcheck.cu:10-11: a constant-4 polynomial at 7
    pts = [np.array([4, 0, 0, 0], np.uint32)] * 3
    assert np.array_equal(
        interpolate_at_host(np.array([7, 0, 0, 0], np.uint32), pts),
        np.array([4, 0, 0, 0], np.uint32))
    for seed in range(8):
        x, pts = _rand(4, seed), _rand((3, 4), 40 + seed)
        assert np.array_equal(interpolate_at_host(x, pts),
                              pf_jax.interpolate_at_host(x, pts))
