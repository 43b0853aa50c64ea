"""The torch port's GF(2^128) sumcheck prover against the JAX package.

Inputs come from numpy (mt19937 or a seeded generator) and go to both
packages; every comparison is exact word equality (GF(2) arithmetic has no
rounding).  The JAX side runs on the CPU through its jnp kernels
(``_round_kernel_tiled``, ``_fold_kernel_tiled``, ``round_emulate``), as
the JAX package's own tests run them.  Sizes are reused so that JAX
compiles few shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.fields import bitsliced as bs_jax
from binius_ntt_tpu.layout import bitslicing as lay_jax
from binius_ntt_tpu.sumcheck import pallas_round as pr_jax
from binius_ntt_tpu.sumcheck import prover as prover_jax
from binius_ntt_tpu.sumcheck import verifier as V_jax
from binius_ntt_tpu_torch import Sumcheck
from binius_ntt_tpu_torch.convert import sumcheck_state_from_jax
from binius_ntt_tpu_torch.fields import bitsliced
from binius_ntt_tpu_torch.layout.bitslicing import (bitslice_transpose,
                                                    repeat_value_bitsliced)
from binius_ntt_tpu_torch.sumcheck import cuda_round as cr
from binius_ntt_tpu_torch.sumcheck import prover as prover_port
from binius_ntt_tpu_torch.sumcheck import verifier as V
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream
from test_torch_sumcheck_golden import transcript

IPV = 4


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, shape,
                                                dtype=np.uint32)


def _state(num_vars, comp, seed):
    """(C, B, 128) bit-sliced uint32 state from mt19937 words (numpy)."""
    evals = mt19937_stream(seed, IPV * (1 << num_vars) * comp)
    return np.asarray(lay_jax.bitslice_transpose(
        evals.reshape(comp, -1, 128)))


def _challenges(seed, n):
    return [_words(seed + i, (4,)) for i in range(n)]


# ---- fields, layout, fold matrices -------------------------------------

@pytest.mark.parametrize("height", [0, 2, 5, 7])
def test_square_matches_jax(height):
    x = _words(1 + height, (6, 1 << height))
    want = np.asarray(bs_jax.square(jnp.asarray(x), height))
    assert np.array_equal(to_numpy(bitsliced.square(to_torch(x), height)),
                          want)


def test_square_is_the_product_with_itself():
    x = to_torch(_words(9, (16, 128)))
    assert torch.equal(bitsliced.square(x, 7), bitsliced.multiply(x, x, 7))


@pytest.mark.parametrize("full,sub", [(7, 2), (7, 3), (5, 2)])
def test_mul_subfield_chunks_matches_jax(full, sub):
    x = _words(10 + full + sub, (5, 1 << full))
    coeff = _words(20 + full + sub, (5, 1 << sub))
    want = np.asarray(bs_jax.mul_subfield_chunks(
        jnp.asarray(x), jnp.asarray(coeff), full, sub))
    got = bitsliced.mul_subfield_chunks(to_torch(x), to_torch(coeff), full,
                                        sub)
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("value", [[0, 0, 0, 0], [3, 0, 0, 0],
                                   [0xFFFFFFFF, 1, 0x80000000, 0x12345678]])
def test_repeat_value_bitsliced_matches_jax(value):
    value = np.array(value, dtype=np.uint32)
    want = lay_jax.repeat_value_bitsliced(value, 128)
    got = repeat_value_bitsliced(value, 128)
    assert got.dtype == torch.int32 and got.shape == (128,)
    assert np.array_equal(to_numpy(got), want)
    with pytest.raises(ValueError):
        repeat_value_bitsliced(value[:3], 128)


def test_fold_matrices_match_jax():
    for p in range(16):
        assert cr._fold_matrix(p) == pr_jax._fold_matrix(p)
    # the kernel's masks: row j of point p in bits 4j .. 4j+3
    masks = cr._fold_masks(5)
    assert len(masks) == 3
    for p, m in zip((2, 3, 4), masks):
        for j, row in enumerate(pr_jax._fold_matrix(p)):
            assert {k for k in range(4) if (m >> (4 * j + k)) & 1} == set(row)


def test_challenge_words_reads_uint32_bits():
    want = np.array([0xFFFFFFFF, 0x80000000, 7, 0], dtype=np.uint32)
    for form in (want, want.view(np.int32), list(map(int, want)),
                 to_torch(want)):
        assert np.array_equal(cr.challenge_words(form), want)
    with pytest.raises(ValueError):
        cr.challenge_words([1, 2, 3])


# ---- round and fold, plain versions ------------------------------------

@pytest.mark.parametrize("num_vars,comp", [(10, 2), (11, 3), (10, 4)])
def test_round_plain_matches_jax(num_vars, comp):
    state = _state(num_vars, comp, 5 + comp)
    b = state.shape[1]
    coeffs = jnp.asarray(np.stack([
        lay_jax.repeat_value_bitsliced(np.array([p, 0, 0, 0], np.uint32),
                                       128) for p in range(comp + 1)]))
    for rows in (b, b // 2):
        got = to_numpy(cr.round_plain(to_torch(state), rows, comp + 1))
        want = np.asarray(pr_jax.round_emulate(
            jnp.asarray(state[:, :rows]), num_points=comp + 1))
        assert np.array_equal(got, want)
        tiled = np.asarray(prover_jax._round_kernel_tiled(
            jnp.asarray(state), coeffs, jnp.int32(rows),
            num_points=comp + 1))
        assert np.array_equal(got, tiled)


@pytest.mark.parametrize("num_vars,comp", [(10, 2), (11, 3), (10, 4)])
def test_fold_plain_matches_jax(num_vars, comp):
    state = _state(num_vars, comp, 50 + comp)
    b = state.shape[1]
    ch = _words(60 + comp, (4,))
    coeff = jnp.asarray(lay_jax.repeat_value_bitsliced(ch, 128))
    for rows in (b, b // 2):
        x = to_torch(state.copy())
        assert cr.fold_plain(x, ch, rows) is x        # in place
        want = np.asarray(prover_jax._fold_kernel_tiled(
            jnp.asarray(state), coeff, jnp.int32(rows)))
        assert np.array_equal(to_numpy(x), want)


@pytest.mark.parametrize("comp", [2, 4])
def test_in_word_round_and_fold_match_the_jax_tail(comp):
    """rows = 1, every lane count of the last rounds: the plain round's
    sums and the plain fold's words against the JAX package's host tail
    (_host_composition, _fold_small)."""
    cols = np.ascontiguousarray(_state(6, comp, 90 + comp)[:, 0])
    x = to_torch(cols.copy())[:, None, :]                  # (C, 1, 128)
    coeffs = [lay_jax.repeat_value_bitsliced(
        np.array([p, 0, 0, 0], np.uint32), 128) for p in range(comp + 1)]
    lanes = 32
    while lanes >= 1:
        got = prover_port._compute_sum(cr.round_plain(x, 1, comp + 1, lanes))
        want_sum = prover_jax._compute_sum(
            np.asarray(prover_jax._host_composition(cols)), lanes)
        want_pts = [prover_jax._compute_sum(np.asarray(
            prover_jax._host_composition(prover_jax._fold_small(
                cols, coeffs[p], lanes))), lanes // 2)
            for p in range(comp + 1)]
        assert np.array_equal(got[0], want_sum)
        assert np.array_equal(got[1:], np.stack(want_pts))
        if lanes >= 2:
            ch = _words(95 + lanes, (4,))
            cols = prover_jax._fold_small(
                cols, lay_jax.repeat_value_bitsliced(ch, 128), lanes)
            assert cr.fold_plain(x, ch, 1, lanes) is x     # in place
            assert np.array_equal(to_numpy(x[:, 0]), cols)
        lanes //= 2


def test_round_and_fold_on_cpu_run_plain_and_launch_nothing():
    state = to_torch(_state(8, 3, 70))
    before = (cr.round_kernel.launches, cr.fold_kernel.launches)
    assert torch.equal(cr.round_kernel(state, 4, 4),
                       cr.round_plain(state, 4, 4))
    want = cr.fold_plain(state.clone(), [1, 2, 3, 4], 8)
    assert torch.equal(cr.fold_kernel(state, [1, 2, 3, 4], 8), want)
    assert (cr.round_kernel.launches, cr.fold_kernel.launches) == before


def test_round_and_fold_refuse_bad_input():
    state = to_torch(_state(8, 2, 71))                 # (2, 8, 128)
    for rows in (0, 3, 16):
        with pytest.raises(ValueError, match="rows"):
            cr.round_kernel(state, rows, 3)
        with pytest.raises(ValueError, match="rows"):
            cr.fold_kernel(state, [0, 0, 0, 1], rows)
    for rows, lanes in ((1, 3), (1, 64), (8, 16)):
        with pytest.raises(ValueError, match="lanes"):
            cr.round_kernel(state, rows, 3, lanes)
    with pytest.raises(ValueError, match="lanes"):
        cr.fold_kernel(state, [0, 0, 0, 1], 1, 1)        # nothing to fold
    with pytest.raises(ValueError, match="int32"):
        cr.round_kernel(state.long(), 8, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cr.fold_kernel(state[:, ::2], [0, 0, 0, 1], 4)
    with pytest.raises(ValueError, match="int32"):
        cr.fold_kernel(state[0], [0, 0, 0, 1], 4)


# ---- verifier -----------------------------------------------------------

def test_verifier_matches_jax():
    rng = np.random.default_rng(80)
    big = [int.from_bytes(rng.bytes(16), "little") for _ in range(16)]
    assert V.words_to_int(V.int_to_words(big[0])) == big[0]
    w = _words(81, (4,))
    assert V.words_to_int(w) == V_jax.words_to_int(w)
    assert V.words_to_int(w.view(np.int32)) == V_jax.words_to_int(w)
    for n in (2, 3, 5):
        assert (V.evaluate_univariate_given_points(big[0], big[1:1 + n], n)
                == V_jax.evaluate_univariate_given_points(big[0],
                                                          big[1:1 + n], n))
    cols = [big[:8], big[8:]]
    chal = [int.from_bytes(rng.bytes(16), "little") for _ in range(3)]
    assert (V.evaluate_multilinear_given_point(cols[0], chal)
            == V_jax.evaluate_multilinear_given_point(cols[0], chal))
    assert (V.evaluate_multilinear_composition(cols, chal)
            == V_jax.evaluate_multilinear_composition(cols, chal))


# ---- the protocol -------------------------------------------------------

def _run_protocol(num_vars, comp, transposed, seed):
    """Full protocol against the port's verifier, with the brute-force
    final evaluation (as tests/test_sumcheck.py does for the JAX prover)."""
    n_ints = IPV * (1 << num_vars) * comp
    vals = mt19937_stream(seed, n_ints + 4 * num_vars)
    evals = vals[:n_ints].copy()
    challenges = vals[n_ints:].reshape(num_vars, 4)
    given = (to_numpy(bitslice_transpose(to_torch(evals).view(-1, 128)))
             if transposed else evals)
    s = Sumcheck(given, comp, num_vars, data_is_transposed=transposed,
                 device="cpu")
    messages = transcript(s, challenges)
    claim = V.check_transcript(messages, challenges, comp + 1)
    per_col = (1 << num_vars) * IPV
    cols = [[V.words_to_int(w) for w in
             evals[c * per_col:(c + 1) * per_col].reshape(-1, 4)]
            for c in range(comp)]
    assert V.evaluate_multilinear_composition(
        cols, [V.words_to_int(ch) for ch in challenges]) == claim
    return messages, challenges


@pytest.mark.parametrize("comp,transposed", [(2, False), (3, True)])
def test_protocol_against_verifier(comp, transposed):
    _run_protocol(8, comp, transposed, seed=1000 + comp)


def test_verifier_refuses_a_tampered_transcript():
    messages, challenges = _run_protocol(8, 2, False, seed=1002)
    bad = [(sm.copy(), pts.copy()) for sm, pts in messages]
    bad[3][1][2, 0] ^= 1                     # point 2 of round 3
    with pytest.raises(ValueError, match="round 4"):
        V.check_transcript(bad, challenges, 3)
    bad = [(sm.copy(), pts.copy()) for sm, pts in messages]
    bad[0][1][0, 1] ^= 1                     # p(0) of round 0
    with pytest.raises(ValueError, match="round 0"):
        V.check_transcript(bad, challenges, 3)
    with pytest.raises(ValueError, match="final"):
        V.check_transcript(messages[:-1] + [messages[-2]], challenges, 3)


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gs, gp), (ws, wp) in zip(got, want):
        assert gs.dtype == np.uint32 and gp.dtype == np.uint32
        assert np.array_equal(gs, ws) and np.array_equal(gp, wp)


@pytest.mark.parametrize("comp", [2, 3, 4])
@pytest.mark.parametrize("num_vars,transposed", [
    (6, False), (7, True), (12, False), (12, True)])
def test_messages_match_jax_round_by_round(num_vars, transposed, comp):
    """num_vars 6 and 7 start in (or at once reach) the in-word rounds."""
    evals = mt19937_stream(200 + num_vars + comp,
                           IPV * (1 << num_vars) * comp)
    given = (np.asarray(lay_jax.bitslice_transpose(evals.reshape(-1, 128)))
             .reshape(-1) if transposed else evals)
    challenges = _challenges(300 + comp, num_vars)
    want = transcript(prover_jax.Sumcheck(
        given, comp, num_vars, data_is_transposed=transposed), challenges)
    got = transcript(Sumcheck(given, comp, num_vars,
                               data_is_transposed=transposed,
                               device="cpu"), challenges)
    _assert_same(got, want)


def test_state_dict_resume_in_the_port():
    num_vars, comp = 12, 3
    evals = mt19937_stream(77, IPV * (1 << num_vars) * comp)
    challenges = _challenges(400, num_vars)
    a = Sumcheck(evals, comp, num_vars, device="cpu")
    transcript(a, challenges[:3])
    d = a.state_dict()
    assert d["device_evals"].dtype == np.uint32
    assert d["device_evals"].shape == (comp, (1 << (num_vars - 3)) // 32, 128)
    want = transcript(a, challenges[3:])
    for _ in range(2):            # the dict is copied, so it resumes twice
        b = Sumcheck.from_state_dict(d, device="cpu")
        assert b.round == 3
        _assert_same(transcript(b, challenges[3:]), want)
    # a state saved in the in-word rounds resumes too, in the
    # reference's host_evals form
    c = Sumcheck(evals, comp, num_vars, device="cpu")
    transcript(c, challenges[:9])
    d = c.state_dict()
    assert d["device_evals"] is None and d["host_evals"].shape == (comp, 128)
    _assert_same(transcript(Sumcheck.from_state_dict(d, device="cpu"),
                            challenges[9:]),
                 want[6:])


@pytest.mark.parametrize("comp", [2, 4])
def test_resume_from_a_jax_state(comp):
    """Three rounds in JAX, the rest in the port: the same messages."""
    num_vars = 12
    evals = mt19937_stream(200 + num_vars + comp,
                           IPV * (1 << num_vars) * comp)
    challenges = _challenges(300 + comp, num_vars)
    ref = prover_jax.Sumcheck(evals, comp, num_vars)
    transcript(ref, challenges[:3])
    port = Sumcheck.from_state_dict(
        sumcheck_state_from_jax(ref.state_dict()), device="cpu")
    assert port.round == 3
    _assert_same(transcript(port, challenges[3:]),
                 transcript(ref, challenges[3:]))
    # and back: the port's state dict resumes in JAX
    ref2 = prover_jax.Sumcheck(evals, comp, num_vars)
    port2 = Sumcheck(evals, comp, num_vars, device="cpu")
    transcript(port2, challenges[:3])
    transcript(ref2, challenges[:3])
    back = prover_jax.Sumcheck.from_state_dict(port2.state_dict())
    _assert_same(transcript(port2, challenges[3:]),
                 transcript(back, challenges[3:]))


def test_device_resident_ctor_matches_and_refuses():
    num_vars, comp = 8, 2
    evals = mt19937_stream(123, IPV * (1 << num_vars) * comp)
    sliced = bitslice_transpose(to_torch(evals).view(comp, -1, 128))
    challenges = _challenges(500, num_vars)
    want = transcript(Sumcheck(evals, comp, num_vars, device="cpu"),
                      challenges)
    resident = sliced.clone()
    _assert_same(transcript(Sumcheck(resident, comp, num_vars,
                                      data_is_transposed=True,
                                      device="cpu"), challenges),
                 want)
    with pytest.raises(ValueError, match="pre-bit-sliced"):
        Sumcheck(sliced, comp, num_vars, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        Sumcheck(sliced[:, :4].contiguous(), comp, num_vars,
                 data_is_transposed=True, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        Sumcheck(sliced.long(), comp, num_vars, data_is_transposed=True,
                 device="cpu")
    with pytest.raises(ValueError, match="device"):
        Sumcheck(sliced, comp, num_vars, data_is_transposed=True,
                 device="meta")
    with pytest.raises(ValueError, match="words"):
        Sumcheck(evals[:-4], comp, num_vars, device="cpu")
    with pytest.raises(ValueError, match="num_vars"):
        Sumcheck(evals, comp, 5, device="cpu")
    with pytest.raises(ValueError, match="composition_size"):
        Sumcheck(evals, 1, num_vars, device="cpu")


def test_flat_ctor_leaves_the_callers_words():
    num_vars, comp = 7, 2
    evals = mt19937_stream(9, IPV * (1 << num_vars) * comp)
    sliced = to_numpy(bitslice_transpose(to_torch(evals).view(-1, 128)))
    before = sliced.copy()
    s = Sumcheck(sliced.reshape(-1), comp, num_vars, data_is_transposed=True,
                 device="cpu")
    transcript(s, _challenges(600, num_vars))
    assert np.array_equal(sliced, before)
