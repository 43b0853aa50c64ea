"""The torch port's per-stage GF(2^128) additive NTT and its butterflies.

The per-stage path (``AdditiveNTT128(..., use_fused=False)``, and the
default at log_h = 5) against the JAX ``AdditiveNTT128(h, r,
use_pallas=False, use_fused=False)`` word for word, each plain butterfly
against one JAX stage built from the reference's own pieces, the golden
digests of the native oracle, the scalar oracle where no digest exists, and
the fused path.  Tolerance everywhere: exact word equality.

The JAX Pallas butterflies themselves are not run: the Pallas interpreter
takes more than ten minutes on their multiply bodies, and the JAX
package's tests never run them either.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_hashes_oracle import ADDITIVE_NTT128_HASHES
from binius_ntt_tpu.fields import bitsliced as bf_jax
from binius_ntt_tpu.ntt.additive_bitsliced import \
    AdditiveNTT128 as AdditiveNTT128Jax
from binius_ntt_tpu.ntt.additive_bitsliced import _expand_bits
from binius_ntt_tpu_torch import AdditiveNTT128
from binius_ntt_tpu_torch.convert import per_stage_tables_from_jax
from binius_ntt_tpu_torch.layout.bitslicing import bitslice_transpose
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck
from binius_ntt_tpu_torch.ntt.additive_bitsliced import (apply_per_stage,
                                                         per_stage_tables)
from binius_ntt_tpu_torch.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu_torch.ntt.reference import additive_ntt_scalar
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

W = 128
LANE_MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)


def _md5(t) -> str:
    return hashlib.md5(to_numpy(t).astype("<u4").tobytes()).hexdigest()


def _words(log_h, log_rate):
    return mt19937_stream(0xDEADBEEF + log_h + log_rate, (1 << log_h) * 4)


def _ints(words):
    return [int.from_bytes(words[i * 4:(i + 1) * 4].astype("<u4").tobytes(),
                           "little") for i in range(len(words) // 4)]


@pytest.mark.parametrize("log_h,log_rate", [
    (5, 0), (5, 1), (5, 2), (5, 3), (5, 4), (7, 1), (9, 2)])
def test_per_stage_matches_jax(log_h, log_rate):
    words = _words(log_h, log_rate)
    jnt = AdditiveNTT128Jax(log_h, log_rate, use_pallas=False,
                            use_fused=False)
    want = np.asarray(jnt.apply(words))
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device="cpu")
    assert not ntt.use_fused
    assert np.array_equal(to_numpy(ntt.apply(words)), want)
    # the same transform from the JAX object's own tables
    sliced = bitslice_transpose(to_torch(words).view(-1, W))
    out = apply_per_stage(sliced, *per_stage_tables_from_jax(jnt),
                          log_rate=log_rate)
    assert np.array_equal(to_numpy(out),
                          np.asarray(jnt.apply_sliced(to_numpy(sliced))))


_MUL7 = jax.jit(lambda a, b: bf_jax.multiply(a, b, 7))


def _mul7(a, b):
    """bf_jax.multiply(a, b, 7) with broadcasting, as one jitted call on
    flat (N, 128) operands: the same words, but compiled once per N
    instead of once per operation and shape (eager dispatch takes ~8 s
    for each new shape)."""
    shape = jnp.broadcast_shapes(a.shape, b.shape)
    return _MUL7(jnp.broadcast_to(a, shape).reshape(-1, W),
                 jnp.broadcast_to(b, shape).reshape(-1, W)).reshape(shape)


def _jax_stage(x, jnt, s, log_h, log_rate):
    """One stage of the reference's jnp branch (additive_bitsliced.py:
    222-265) on (C, nb, 128) uint32 numpy words."""
    cosets, nb = x.shape[:2]
    x = jnp.asarray(x)
    if s >= 5:
        db = 1 << (s - 5)
        groups = nb // (2 * db)
        w4 = jnt._high_tables[s].reshape(-1, groups, 4)[:cosets]
        wp = _expand_bits(w4)[:, :, None, :]
        v5 = x.reshape(cosets, groups, 2, db, W)
        u, v = v5[:, :, 0], v5[:, :, 1]
        u2 = u ^ _mul7(wp, v)
        out = jnp.stack([u2, u2 ^ v], axis=2)
    else:
        a4 = jnt._low_batch_tables[s].reshape(-1, nb, 4)[:cosets]
        wp = _expand_bits(a4) ^ jnt._low_lane_planes[s][None, None, :]
        shift = 1 << s
        umask = jnp.uint32(LANE_MASKS[s])
        vmask = jnp.uint32((LANE_MASKS[s] << shift) & 0xFFFFFFFF)
        un = x ^ _mul7(wp, x >> shift)
        out = (un & umask) | ((x ^ (un << shift)) & vmask)
    return np.asarray(out).reshape(cosets * nb, W)


@pytest.fixture(scope="module")
def jax_9_2():
    return AdditiveNTT128Jax(9, 2, use_pallas=False, use_fused=False)


@pytest.mark.parametrize("s", range(9))
def test_butterfly_plain_matches_one_jax_stage(jax_9_2, s):
    log_h, log_rate = 9, 2
    cosets, nb = 1 << log_rate, (1 << log_h) // 32
    rng = np.random.default_rng(100 + s)
    x = rng.integers(0, 1 << 32, (cosets, nb, W), dtype=np.uint32)
    want = _jax_stage(x, jax_9_2, s, log_h, log_rate)
    high, low_batch, low_lanes = per_stage_tables_from_jax(jax_9_2)
    xt = to_torch(x.reshape(cosets * nb, W))
    if s >= 5:
        got = ck.butterfly_high_plain(xt, high[s])
    else:
        got = ck.butterfly_low_plain(xt, low_batch[s], low_lanes[s], s)
    assert got is xt                                   # in place
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("log_h,log_rate", [
    (5, 0), (5, 2), (6, 1), (8, 3), (10, 4), (11, 2), (12, 0), (12, 1)])
def test_per_stage_golden_cpu(log_h, log_rate):
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device="cpu")
    out = ntt.apply(_words(log_h, log_rate))
    assert out.shape == ((1 << (log_h + log_rate)) * 4,)
    assert _md5(out) == ADDITIVE_NTT128_HASHES[log_rate][log_h]


@pytest.mark.parametrize("log_rate", [0, 1, 2, 3, 4])
def test_log_h_5_defaults_to_per_stage_and_matches_the_oracle(log_rate):
    """log_h = 5 (one batch, no high stage) is the size only the per-stage
    path takes; rates 1, 3 and 4 have no digest there, so the scalar
    oracle holds it."""
    words = _words(5, log_rate)
    ntt = AdditiveNTT128(5, log_rate, device="cpu")
    assert not ntt.use_fused
    high, low_batch, _ = ntt.stage_tables
    assert high == {} and set(low_batch) == set(range(5))
    assert all(t.shape == (1 << log_rate, 4) for t in low_batch.values())
    out = ntt.apply(words)
    assert _ints(to_numpy(out)) == additive_ntt_scalar(_ints(words), 5,
                                                       log_rate, 7)
    digest = ADDITIVE_NTT128_HASHES[log_rate].get(5)
    if digest is not None:
        assert _md5(out) == digest


@pytest.mark.parametrize("log_h,log_rate", [
    (6, 0), (7, 2), (8, 1), (9, 4), (10, 3)])
def test_per_stage_matches_fused(log_h, log_rate):
    rng = np.random.default_rng(log_h * 10 + log_rate)
    words = rng.integers(0, 1 << 32, (1 << log_h) * 4, dtype=np.uint32)
    fused = AdditiveNTT128(log_h, log_rate, device="cpu")
    per_stage = AdditiveNTT128(log_h, log_rate, use_fused=False,
                               device="cpu")
    assert fused.use_fused and not per_stage.use_fused
    assert torch.equal(per_stage.apply(words), fused.apply(words))


@pytest.mark.parametrize("log_h,log_rate", [(5, 3), (9, 2), (11, 1)])
def test_converted_tables_equal_the_ports_own(log_h, log_rate):
    jnt = AdditiveNTT128Jax(log_h, log_rate, use_pallas=False,
                            use_fused=False)
    ported = per_stage_tables_from_jax(jnt, "cpu")
    own = AdditiveNTT128(log_h, log_rate, use_fused=False,
                         device="cpu").stage_tables
    built = per_stage_tables(precompute_subspace_evals(log_h, log_rate, 7),
                             log_h, log_rate, "cpu")
    for a, b, c in zip(ported, own, built):
        assert sorted(a) == sorted(b) == sorted(c)
        for s in a:
            assert a[s].dtype == torch.int32
            assert torch.equal(a[s], b[s]) and torch.equal(a[s], c[s])


def test_apply_sliced_leaves_input_and_holds_stage_tables_as_buffers():
    ntt = AdditiveNTT128(8, 2, use_fused=False, device="cpu")
    names = set(dict(ntt.named_buffers()))
    assert names == ({f"high{s}" for s in (5, 6, 7)}
                     | {f"low_batch{s}" for s in range(5)}
                     | {f"low_lanes{s}" for s in range(5)})
    assert ntt.tables == () and ntt.device == torch.device("cpu")
    x = torch.arange(8 * 128, dtype=torch.int32).view(8, 128)
    before = x.clone()
    out = ntt.apply_sliced(x)
    assert out.shape == (32, 128) and torch.equal(x, before)


@pytest.mark.parametrize("log_h,log_rate", [(5, 2), (8, 1)])
def test_stage_steps_are_the_path_apply_sliced_takes(log_h, log_rate):
    """stage_steps() gives the stages in the driver's order with their
    tables; stepping through them by hand is apply_sliced."""
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device="cpu")
    high, low_batch, low_lanes = ntt.stage_tables
    steps = list(ntt.stage_steps())
    assert [(s, k.__name__) for s, k, _, _ in steps] == (
        [(s, "butterfly_high") for s in range(log_h - 1, 4, -1)]
        + [(s, "butterfly_low") for s in range(4, -1, -1)])
    for s, kernel, plain, args in steps:
        assert plain.__name__ == kernel.__name__ + "_plain"
        want = ((high[s], ntt.chunk32[s]) if s >= 5 else
                (low_batch[s], low_lanes[s], s, ntt.chunk32[s]))
        assert len(args) == len(want) and all(
            a is b for a, b in zip(args, want))
    rng = np.random.default_rng(log_h)
    data = to_torch(rng.integers(0, 1 << 32, ((1 << log_h) // 32, W),
                                 dtype=np.uint32))
    x = data.repeat(1 << log_rate, 1)
    for _, kernel, _, args in steps:
        kernel(x, *args)
    assert torch.equal(x, ntt.apply_sliced(data))
    with pytest.raises(ValueError, match="fused"):
        AdditiveNTT128(6, 0, device="cpu").stage_steps()


def test_use_fused_choices_and_refusals():
    assert AdditiveNTT128(6, 0, device="cpu").use_fused
    assert not AdditiveNTT128(6, 0, use_fused=False, device="cpu").use_fused
    assert AdditiveNTT128(7, 1, use_fused=True, device="cpu").use_fused
    assert AdditiveNTT128(5, 0, device="cpu").stage_tables[0] == {}
    assert AdditiveNTT128(6, 0, device="cpu").stage_tables == ({}, {}, {})
    with pytest.raises(ValueError, match="log_h must be >= 5"):
        AdditiveNTT128(4, 0, use_fused=False, device="cpu")
    with pytest.raises(ValueError, match="use_fused needs log_h >= 6"):
        AdditiveNTT128(5, 0, use_fused=True, device="cpu")


def test_butterfly_wrappers_run_the_plain_versions_on_the_cpu():
    ntt = AdditiveNTT128(7, 1, use_fused=False, device="cpu")
    high, low_batch, low_lanes = ntt.stage_tables
    rng = np.random.default_rng(7)
    x = to_torch(rng.integers(0, 1 << 32, (8, W), dtype=np.uint32))
    launches = (ck.butterfly_high.launches, ck.butterfly_low.launches)
    for s in (6, 5):
        assert torch.equal(ck.butterfly_high(x.clone(), high[s]),
                           ck.butterfly_high_plain(x.clone(), high[s]))
    for s in range(5):
        args = (low_batch[s], low_lanes[s], s)
        assert torch.equal(ck.butterfly_low(x.clone(), *args),
                           ck.butterfly_low_plain(x.clone(), *args))
    # no kernel was launched
    assert (ck.butterfly_high.launches, ck.butterfly_low.launches) == launches


def test_butterfly_wrappers_refuse_bad_geometry():
    x = torch.zeros(8, W, dtype=torch.int32)
    with pytest.raises(ValueError, match="blocks"):
        ck.butterfly_high(x, torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="blocks"):
        ck.butterfly_high(x, torch.zeros(8, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        ck.butterfly_high(x.long(), torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ck.butterfly_high(torch.zeros(16, W, dtype=torch.int32)[::2],
                          torch.zeros(2, 4, dtype=torch.int32))
    lanes = torch.zeros(W, dtype=torch.int32)
    with pytest.raises(ValueError, match="a4"):
        ck.butterfly_low(x, torch.zeros(4, 4, dtype=torch.int32), lanes, 0)
    with pytest.raises(ValueError, match="stage"):
        ck.butterfly_low(x, torch.zeros(8, 4, dtype=torch.int32), lanes, 5)
    with pytest.raises(ValueError, match="lane_planes"):
        ck.butterfly_low(x, torch.zeros(8, 4, dtype=torch.int32),
                         lanes[:64], 1)
