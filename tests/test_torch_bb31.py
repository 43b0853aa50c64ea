"""The torch port's radix-2 BB31 NTT against the JAX package.

Same seeded inputs through both packages, exact word equality everywhere
(a prime field has no rounding): the Montgomery field ops, the whole
transform against the JAX NTTRadix2 and the upstream golden digests
(tests/golden_hashes.py, test_ntt.cu:126-152), the stage groups against the
JAX stage_group_r2 (its CPU emulation, emulate=True) after every group of
the JAX plan, the forward/inverse round trip, and the field injection seam.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_hashes import BB31_NTT_HASHES
from binius_ntt_tpu.fields import baby_bear as bb_jax
from binius_ntt_tpu.ntt import pallas_fused_bb31 as pfb
from binius_ntt_tpu.ntt import radix2 as radix2_jax
from binius_ntt_tpu_torch import DataOrder, NTTData, NTTRadix2
from binius_ntt_tpu_torch.convert import radix2_twiddles_from_jax
from binius_ntt_tpu_torch.fields import baby_bear as bb
from binius_ntt_tpu_torch.ntt import cuda_fused_bb31 as cfb
from binius_ntt_tpu_torch.ntt.radix2 import (BB31_OPS, FieldOps,
                                             bit_reverse_indices,
                                             make_modp_ops)
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

EDGES = np.array([0, 1, bb.P - 1, bb.P, 1 << 31, 0xFFFFFFFF],
                 dtype=np.uint32)


def _md5(t) -> str:
    return hashlib.md5(to_numpy(t).astype("<u4").tobytes()).hexdigest()


def _inputs(log_n):
    return mt19937_stream(0xDEADBEEF + log_n, 1 << log_n)


def _port(fn, *words):
    return to_numpy(fn(*(to_torch(w) for w in words)))


def _jax(fn, *words):
    return np.asarray(fn(*(jnp.asarray(w) for w in words)))


def test_constants_match_jax():
    assert (bb.P, bb.M, bb.R2) == (bb_jax.P, bb_jax.M, bb_jax.R2)
    assert bb.R_INV * (1 << 32) % bb.P == 1
    assert bb.inv_host(137) == bb_jax.inv_host(137)
    assert bb.pow_host(137, 1 << 20) == bb_jax.pow_host(137, 1 << 20)


def test_field_ops_match_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, bb.P, 4096, dtype=np.uint32)
    b = rng.integers(0, bb.P, 4096, dtype=np.uint32)
    a[:4], b[:4] = (0, 1, bb.P - 1, bb.P - 1), (bb.P - 1, 0, bb.P - 1, 1)
    for port, ref in ((bb.add, bb_jax.add), (bb.sub, bb_jax.sub),
                      (bb.mont_mul, bb_jax.mont_mul)):
        assert np.array_equal(_port(port, a, b), _jax(ref, a, b))
    assert np.array_equal(_port(bb.decode, a), _jax(bb_jax.decode, a))
    assert np.array_equal(bb.encode_host(a), bb_jax.encode_host(a))


def test_encode_matches_jax_on_raw_words_and_edges():
    """encode takes raw uint32 words (mt19937 output): a >= P wraps."""
    words = np.concatenate([EDGES, _inputs(12)])
    got = _port(bb.encode, words)
    assert np.array_equal(got, _jax(bb_jax.encode, words))
    assert (got < bb.P).all()
    assert np.array_equal(_port(bb.decode, got),
                          (words.astype(np.uint64) % bb.P).astype(np.uint32))


@pytest.mark.parametrize("log_n", [1, 6, 13])
def test_bit_reverse_indices_match_jax(log_n):
    got = bit_reverse_indices(log_n, "cpu")
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), radix2_jax.bit_reverse_indices(log_n))


@pytest.mark.parametrize("log_n", range(1, 13))
def test_transform_matches_jax(log_n):
    x = _inputs(log_n)
    ntt = NTTRadix2(137, 27, log_n, device="cpu")
    assert ntt.use_fused == (log_n >= 7)
    want = np.asarray(radix2_jax.NTTRadix2(137, 27, log_n).apply(x))
    assert np.array_equal(to_numpy(ntt.apply(x)), want)
    assert np.array_equal(to_numpy(ntt.tw),
                          to_numpy(radix2_twiddles_from_jax(
                              radix2_jax.NTTRadix2(137, 27, log_n))))


@pytest.mark.parametrize("log_n", range(1, 15))
def test_golden_digests(log_n):
    out = NTTRadix2(137, 27, log_n, device="cpu").apply(_inputs(log_n))
    assert out.shape == (1 << log_n,)
    assert _md5(out) == BB31_NTT_HASHES[log_n]


@pytest.mark.parametrize("log_n,kb,ku,pt", [
    (7, 12, 10, 8),      # single row: lane stages only (kb = 0)
    (10, 12, 10, 8),     # single bottom group + top-stage mul skip
    (13, 2, 2, 2),       # bottom + two upper groups (multi-group seams)
])
def test_groups_match_jax_group_by_group(log_n, kb, ku, pt, monkeypatch):
    """The port's plain group function, driven with the JAX plan's stage
    ranges on the JAX tables, equals the JAX stage_group_r2 (emulate=True)
    after every group (tests/test_fused_bb31.py's configurations)."""
    monkeypatch.setattr(pfb, "KB", kb)
    monkeypatch.setattr(pfb, "KU", ku)
    monkeypatch.setattr(pfb, "PT", pt)
    ntt_jax = radix2_jax.NTTRadix2(137, 27, log_n, use_fused=False)
    tw_np = np.asarray(ntt_jax._tw_mont)
    tw = radix2_twiddles_from_jax(ntt_jax, "cpu")
    static, arrays = pfb.split_tables_r2(pfb.build_tables_r2(tw_np, log_n))
    x = _inputs(log_n)[bit_reverse_indices(log_n, "cpu").numpy()]
    xj = jnp.asarray(x).reshape(-1, 128)
    xp = to_torch(x)
    last = len(static) - 1
    for gi, ((t0, k, lanes, skip), (lane_tws, row_tws)) in enumerate(
            zip(static, arrays)):
        edge = dict(encode_in=gi == 0, decode_out=gi == last)
        xj = pfb.stage_group_r2(xj, lane_tws, row_tws, t0=t0, k=k,
                                include_lanes=lanes, skip=skip, log_n=log_n,
                                emulate=True, **edge)
        s0, kk = (0, 7 + k) if lanes else (7 + t0, k)
        assert cfb.stage_group_r2_plain(xp, tw, s0=s0, k=kk, log_n=log_n,
                                        **edge) is xp
        assert np.array_equal(to_numpy(xp), np.asarray(xj).reshape(-1))
    assert _md5(xp) == BB31_NTT_HASHES[log_n]


@pytest.mark.parametrize("kb,ku", [(12, 8), (2, 2), (3, 5)])
def test_port_plans_reach_the_golden(kb, ku, monkeypatch):
    """Any plan the port picks (the kernel's too) gives the same bits: the
    wrapper on the CPU runs the plain version and launches nothing."""
    monkeypatch.setattr(cfb, "KB", kb)
    monkeypatch.setattr(cfb, "KU", ku)
    log_n = 13
    ntt = NTTRadix2(137, 27, log_n, device="cpu")
    before = cfb.stage_group_r2.launches
    out = cfb.apply_fused_r2(to_torch(_inputs(log_n)), ntt.tw, log_n=log_n)
    assert cfb.stage_group_r2.launches == before
    assert _md5(out) == BB31_NTT_HASHES[log_n]
    for s0, k in cfb.plan_groups_r2(log_n):
        # an upper group's columns lie in its row block; the first group's
        # are row blocks of their own
        lc = cfb.tile_columns(s0, k, log_n)
        assert k + lc <= cfb.TILE_LOG
        assert 0 <= lc <= (s0 if s0 else cfb.GATHER_COLS_LOG)


@pytest.mark.parametrize("log_n", [9, 10])
def test_roundtrip(log_n):
    """fwd(g), then fwd(g^-1), then 1/n == identity (test_ntt.cu:154-187)."""
    x = mt19937_stream(0xAABBCCDD, 1 << log_n) % np.uint32(bb.P)
    fwd = NTTRadix2(137, 27, log_n, device="cpu")
    inv = NTTRadix2(bb.inv_host(137), 27, log_n, device="cpu")
    out = to_numpy(inv.apply(fwd.apply(x))).astype(np.uint64)
    final = out * bb.inv_host(1 << log_n) % bb.P
    assert np.array_equal(final, x)


def test_field_ops_injection_toy_prime():
    """NTTRadix2 over F_257 (the reference's NTT<E> genericity,
    gpuntt.cuh:126-131), as tests/test_radix2_ntt.py:64-82."""
    p = 257
    ops = make_modp_ops(p)
    log_n = 6
    x = np.random.default_rng(11).integers(0, p, 1 << log_n,
                                           dtype=np.uint32)
    fwd = NTTRadix2(3, 8, log_n, field_ops=ops, device="cpu")
    inv = NTTRadix2(pow(3, -1, p), 8, log_n, field_ops=ops, device="cpu")
    assert not fwd.use_fused
    out = to_numpy(inv.apply(fwd.apply(x))).astype(np.uint64)
    assert np.array_equal(out * pow(1 << log_n, -1, p) % p, x)
    want = np.asarray(radix2_jax.NTTRadix2(
        3, 8, log_n, field_ops=radix2_jax.make_modp_ops(p)).apply(x))
    assert np.array_equal(to_numpy(fwd.apply(x)), want)
    with pytest.raises(ValueError, match="toy primes"):
        make_modp_ops(1 << 16 | 1)


def test_field_ops_injection_reproduces_bb31_golden():
    """A distinct FieldOps carrying BB31 runs the per-stage path and must
    reproduce the digests (tests/test_radix2_ntt.py:85-98)."""
    ops = FieldOps(*BB31_OPS)
    assert ops is not BB31_OPS
    for log_n in (6, 9):
        ntt = NTTRadix2(137, 27, log_n, field_ops=ops, device="cpu")
        assert not ntt.use_fused
        assert _md5(ntt.apply(_inputs(log_n))) == BB31_NTT_HASHES[log_n]


def test_per_stage_path_matches_fused():
    x = _inputs(10)
    fused = NTTRadix2(137, 27, 10, device="cpu")
    plain = NTTRadix2(137, 27, 10, use_fused=False, device="cpu")
    assert fused.use_fused and not plain.use_fused
    assert {"tw"} == set(dict(fused.named_buffers()))
    assert {"tw"} == set(dict(plain.named_buffers()))
    assert torch.equal(fused.apply(x), plain.apply(x))


@pytest.mark.parametrize("log_n", [3, 10])
def test_per_stage_path_takes_bit_reversed_input(log_n):
    """The per-stage path (one plain group over every stage) with its input
    already bit-reversed, as an NTTData, equals the IN_ORDER transform."""
    x = _inputs(log_n)
    ntt = NTTRadix2(137, 27, log_n, use_fused=False, device="cpu")
    assert not ntt.use_fused
    rev = NTTData(x[bit_reverse_indices(log_n, "cpu").numpy()],
                  DataOrder.BIT_REVERSED)
    out = ntt.apply(rev)
    assert out.order is DataOrder.IN_ORDER
    assert _md5(out.data) == BB31_NTT_HASHES[log_n]


def test_validation():
    with pytest.raises(ValueError, match="log_n"):
        NTTRadix2(137, 27, 0, device="cpu")
    with pytest.raises(ValueError, match="log_n"):
        NTTRadix2(137, 27, 28, device="cpu")
    with pytest.raises(ValueError, match="log_group_order"):
        NTTRadix2(137, 5, 6, device="cpu")
    ntt = NTTRadix2(137, 27, 8, device="cpu")
    with pytest.raises(ValueError, match="input shape"):
        ntt.apply(np.zeros(10, np.uint32))
    with pytest.raises(ValueError, match="int32"):
        ntt.apply(torch.zeros(256, dtype=torch.int64))
    x = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="stages"):
        cfb.stage_group_r2(x, ntt.tw, s0=6, k=3, log_n=8)
    with pytest.raises(ValueError, match="tw"):
        cfb.stage_group_r2(x, ntt.tw[:3], s0=0, k=8, log_n=8)
    with pytest.raises(ValueError, match="out of place"):
        cfb.stage_group_r2(x, ntt.tw, s0=0, k=8, log_n=8, src=x)
    with pytest.raises(ValueError, match="contiguous"):
        cfb.stage_group_r2(torch.zeros(512, dtype=torch.int32)[::2],
                           ntt.tw, s0=0, k=8, log_n=8)


def test_nttdata_in_and_out():
    log_n = 9
    x = _inputs(log_n)
    ntt = NTTRadix2(137, 27, log_n, device="cpu")
    want = ntt.apply(x)
    wrapped = ntt.apply(NTTData(x))
    assert wrapped.order is DataOrder.IN_ORDER
    assert torch.equal(wrapped.data, want)
    rev = NTTData(x[bit_reverse_indices(log_n, "cpu").numpy()],
                  DataOrder.BIT_REVERSED)
    out = ntt.apply(rev)
    assert out.order is DataOrder.IN_ORDER
    assert torch.equal(out.data, want)
    # a tensor input is left as it is
    xt = to_torch(x)
    before = xt.clone()
    ntt.apply(xt, input_bit_reversed=True)
    assert torch.equal(xt, before)
