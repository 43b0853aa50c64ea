"""The torch port's GF(2^32) additive NTT against the JAX package.

Same seeded inputs through both packages, exact word equality everywhere:
the SWAR multiply (fields/tower_simd.py), the scalar oracle, the stage-group
tables, the lane-group transpose and stage_group32 (the JAX side through
its CPU emulation, emulate=True), then the whole transform against the
upstream golden digests (tests/golden_hashes.py) on both of its paths.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_hashes import ADDITIVE_NTT_HASHES
from binius_ntt_tpu.fields import tower_simd as ts_jax
from binius_ntt_tpu.layout.bitslicing import \
    bitslice_transpose as bitslice_transpose_jax
from binius_ntt_tpu.ntt import additive as additive_jax
from binius_ntt_tpu.ntt import pallas_fused32 as pf32
from binius_ntt_tpu.ntt.reference import \
    additive_ntt_scalar as additive_ntt_scalar_jax
from binius_ntt_tpu_torch import AdditiveNTT, DataOrder, NTTData
from binius_ntt_tpu_torch.convert import tables32_from_jax
from binius_ntt_tpu_torch.fields import tower_simd
from binius_ntt_tpu_torch.ntt import cuda_fused32 as cf32
from binius_ntt_tpu_torch.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu_torch.ntt.reference import additive_ntt_scalar
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream


def _md5(t) -> str:
    return hashlib.md5(to_numpy(t).astype("<u4").tobytes()).hexdigest()


def _words(log_h, log_rate):
    return mt19937_stream(0xDEADBEEF + log_h + log_rate, 1 << log_h)


def _rand(seed, n):
    # every word has its top bit set, so an arithmetic shift would differ
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, n, dtype=np.uint32) | np.uint32(1 << 31)


def _plan(monkeypatch, kb, ku):
    for mod in (pf32, cf32):
        monkeypatch.setattr(mod, "KB", kb)
        monkeypatch.setattr(mod, "KU", ku)


def _port(fn, *words, **kw):
    return to_numpy(fn(*(to_torch(w) for w in words), **kw))


@pytest.mark.parametrize("height", range(6))
def test_mul_packed_matches_jax(height):
    a, b = _rand(1 + height, 4096), _rand(50 + height, 4096)
    want = np.asarray(ts_jax.mul_packed(jnp.asarray(a), jnp.asarray(b),
                                        height))
    assert np.array_equal(_port(tower_simd.mul_packed, a, b, height=height),
                          want)


@pytest.mark.parametrize("height", range(5))
def test_interleave_and_xor_adjacent_match_jax(height):
    a, b = _rand(7, 2048), _rand(8, 2048)
    got = tower_simd.interleave_32b(to_torch(a), to_torch(b), height)
    want = ts_jax.interleave_32b(jnp.asarray(a), jnp.asarray(b), height)
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy(g), np.asarray(w))
    assert np.array_equal(
        _port(tower_simd.xor_adjacent_32b, a, height=height),
        np.asarray(ts_jax.xor_adjacent_32b(jnp.asarray(a), height)))


@pytest.mark.parametrize("height", range(1, 6))
def test_inverse_packed_matches_jax(height):
    bits = 1 << height
    x = _rand(9, 2048) & np.uint32((1 << bits) - 1)
    x[:3] = (0, 1, (1 << bits) - 1)
    got = _port(tower_simd.inverse_packed, x, height=height)
    assert np.array_equal(
        got, np.asarray(ts_jax.inverse_packed(jnp.asarray(x), height)))
    # x * x^-1 = 1 except at 0
    prod = _port(tower_simd.mul_packed, x, got, height=height)
    assert np.array_equal(prod, (x != 0).astype(np.uint32))


@pytest.mark.parametrize("log_h,log_rate", [(4, 1), (5, 2)])
def test_scalar_oracle_matches_jax_and_the_transform(log_h, log_rate):
    x = [int(v) for v in _words(log_h, log_rate)]
    got = additive_ntt_scalar(x, log_h, log_rate, 5)
    assert got == additive_ntt_scalar_jax(x, log_h, log_rate, 5)
    out = AdditiveNTT(log_h, log_rate, device="cpu").apply(
        np.array(x, np.uint32))
    assert [int(v) for v in to_numpy(out)] == got


def _same_tables(port, jax_tables):
    assert len(port) == len(jax_tables)
    for (t0, k, low, tabs), (jt0, jk, jlow, jtabs) in zip(port, jax_tables):
        assert (t0, k, low) == (jt0, jk, jlow)
        assert tabs.keys() == jtabs.keys()
        assert tabs["zero"] == tuple(jtabs["zero"])
        for name, t in tabs.items():
            if name != "zero":
                assert t.dtype == torch.int32
                assert np.array_equal(to_numpy(t), np.asarray(jtabs[name]))


@pytest.mark.parametrize("log_h,log_rate,forced", [
    (7, 2, False), (13, 2, False), (16, 0, False), (11, 4, True),
    (13, 2, True),
])
def test_build_tables32_match_jax(log_h, log_rate, forced, monkeypatch):
    if forced:
        _plan(monkeypatch, 2, 2)
    else:             # the port's production plan on both sides
        _plan(monkeypatch, cf32.KB, cf32.KU)
    rows = precompute_subspace_evals(log_h, log_rate, 5)
    assert rows == additive_jax.precompute_subspace_evals(log_h, log_rate, 5)
    _same_tables(cf32.build_tables32(rows, log_h, log_rate),
                 pf32.build_tables32(rows, log_h, log_rate))


def test_tables32_from_jax_round_trip(monkeypatch):
    _plan(monkeypatch, 2, 2)
    rows = precompute_subspace_evals(11, 1, 5)
    jt = pf32.build_tables32(rows, 11, 1)
    tt = tables32_from_jax(jt)
    _same_tables(tt, jt)
    assert len(tt) == 2 and tt[-1][2] is True
    # and back: the port's tensors carry the JAX arrays' bits
    for (_, _, _, tabs), (_, _, _, jtabs) in zip(tt, jt):
        for name in ("mtile", "minst"):
            assert np.array_equal(np.asarray(jnp.asarray(
                to_numpy(tabs[name]))), np.asarray(jtabs[name]))


def test_group_plan_covers_all_bits():
    for log_nbr in range(0, 24):
        groups = cf32.plan_groups32(log_nbr)
        bits = []
        for (t0, k, low) in groups:
            bits.extend(range(t0, t0 + k))
        assert bits == list(range(log_nbr))
        assert groups[0][2] is True and all(not g[2] for g in groups[1:])
        assert all(k <= cf32.KU for (_, k, _) in groups[1:])


@pytest.mark.parametrize("rows", [1, 5, 64])
def test_bitslice_lane_groups_plain_matches_jax(rows):
    x = _rand(11 + rows, rows * 128)
    got = _port(cf32.bitslice_lane_groups_plain, x.reshape(rows, 128))
    want = np.asarray(additive_jax._bitslice_lane_groups(
        jnp.asarray(x.reshape(rows, 128))))
    assert np.array_equal(got, want)
    # the same as the GF(2^32) bit-slicing of 32-word batches
    assert np.array_equal(
        got.reshape(-1), np.asarray(bitslice_transpose_jax(
            x.reshape(-1, 32))).reshape(-1))
    # and its own inverse
    assert np.array_equal(_port(cf32.bitslice_lane_groups_plain, got), x
                          .reshape(rows, 128))


@pytest.mark.parametrize("log_h,log_rate", [(7, 2), (11, 4), (13, 2)])
def test_stage_group32_plain_matches_emulated_jax(log_h, log_rate,
                                                  monkeypatch):
    _plan(monkeypatch, 2, 2)
    rows = precompute_subspace_evals(log_h, log_rate, 5)
    jtables = pf32.build_tables32(rows, log_h, log_rate)
    cosets = 1 << log_rate
    log_nbr = log_h - 7
    packed = to_numpy(cf32.bitslice_lane_groups_plain(
        to_torch(_words(log_h, log_rate)).view(-1, 128)))
    x_jax = jnp.broadcast_to(jnp.asarray(packed)[None],
                             (cosets,) + packed.shape)
    x_port = to_torch(packed).repeat(cosets, 1).view(cosets, -1, 128)
    for (t0, k, low, jtabs), (_, _, _, tabs) in zip(
            jtables, tables32_from_jax(jtables)):
        kw = dict(t0=t0, k=k, include_low=low, cosets=cosets,
                  log_nbr=log_nbr)
        x_jax = pf32.stage_group32(x_jax, jtabs, emulate=True, **kw)
        assert cf32.stage_group32_plain(x_port, tabs, **kw) is x_port
        assert np.array_equal(to_numpy(x_port), np.asarray(x_jax))


@pytest.mark.parametrize("log_rate", [0, 2])
@pytest.mark.parametrize("log_h", list(range(1, 13)))
def test_additive_ntt_golden(log_h, log_rate):
    ntt = AdditiveNTT(log_h, log_rate, device="cpu")
    assert ntt.use_fused == (log_h >= 7)
    out = ntt.apply(_words(log_h, log_rate))
    assert out.shape == (1 << (log_h + log_rate),)
    assert _md5(out) == ADDITIVE_NTT_HASHES[log_rate][log_h]


@pytest.mark.parametrize("log_h", [6, 8])
def test_rates_without_goldens_keep_coset_zero(log_h):
    # coset row 0 of a rate-r transform is the rate-0 transform
    x = mt19937_stream(0xDEADBEEF + 123, 1 << log_h)
    base = to_numpy(AdditiveNTT(log_h, 0, device="cpu").apply(x))
    for log_rate in (1, 3, 4):
        ext = to_numpy(AdditiveNTT(log_h, log_rate, device="cpu").apply(x))
        assert ext.shape == (1 << (log_h + log_rate),)
        assert np.array_equal(ext[:1 << log_h], base)


@pytest.mark.parametrize("log_h,log_rate", [(9, 1), (11, 4)])
def test_compact_path_matches_fused(log_h, log_rate):
    x = _words(log_h, log_rate)
    compact = AdditiveNTT(log_h, log_rate, use_fused=False, device="cpu")
    fused = AdditiveNTT(log_h, log_rate, device="cpu")
    assert not compact.use_fused and fused.use_fused
    assert {"tw0", f"tw{log_h - 1}"} <= set(dict(compact.named_buffers()))
    assert {"mtile0", "cpl0"} <= set(dict(fused.named_buffers()))
    assert fused.device == torch.device("cpu")
    got = compact.apply(x)
    assert torch.equal(got, fused.apply(to_torch(x)))
    want = np.asarray(additive_jax.AdditiveNTT(
        log_h, log_rate, use_fused=False).apply(x))
    assert np.array_equal(to_numpy(got), want)


def test_nttdata_order():
    ntt = AdditiveNTT(8, 1, device="cpu")
    x = _words(8, 1)
    wrapped = ntt.apply(NTTData(x))
    assert wrapped.order is DataOrder.IN_ORDER
    assert torch.equal(wrapped.data, ntt.apply(x))
    with pytest.raises(ValueError, match="IN_ORDER"):
        ntt.apply(NTTData(x, DataOrder.BIT_REVERSED))


def test_validation():
    with pytest.raises(ValueError, match="log_h"):
        AdditiveNTT(0, 0, device="cpu")
    with pytest.raises(ValueError, match="log_rate"):
        AdditiveNTT(4, 5, device="cpu")
    with pytest.raises(ValueError, match="field bits"):
        AdditiveNTT(31, 2, device="cpu")
    with pytest.raises(ValueError, match="height"):
        AdditiveNTT(4, 0, height=6, device="cpu")
    ntt = AdditiveNTT(8, 0, device="cpu")
    with pytest.raises(ValueError, match="input shape"):
        ntt.apply(np.zeros(10, np.uint32))
    with pytest.raises(ValueError, match="int32"):
        ntt.apply(torch.zeros(256, dtype=torch.int64))


def _group_call(log_h, log_rate):
    rows = precompute_subspace_evals(log_h, log_rate, 5)
    (t0, k, low, tabs), = cf32.build_tables32(rows, log_h, log_rate)
    cosets = 1 << log_rate
    x = to_torch(_rand(3, cosets << log_h)).view(cosets, -1, 128)
    kw = dict(t0=t0, k=k, include_low=low, cosets=cosets,
              log_nbr=log_h - 7)
    return x, tabs, kw


def test_wrappers_on_cpu_run_the_plain_versions():
    x, tabs, kw = _group_call(10, 1)
    before = (cf32.stage_group32.launches, cf32.bitslice_lane_groups.launches)
    want = cf32.stage_group32_plain(x.clone(), tabs, **kw)
    assert torch.equal(cf32.stage_group32(x, tabs, **kw), want)
    rows = x.view(-1, 128)
    assert torch.equal(cf32.bitslice_lane_groups(rows),
                       cf32.bitslice_lane_groups_plain(rows))
    assert (cf32.stage_group32.launches,
            cf32.bitslice_lane_groups.launches) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, tabs, kw = _group_call(9, 0)
    with pytest.raises(ValueError, match="int32"):
        cf32.stage_group32(x.long(), tabs, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cf32.stage_group32(torch.zeros(1, 4, 256, dtype=torch.int32)
                           [:, :, ::2], tabs, **kw)
    with pytest.raises(ValueError, match="int32"):
        cf32.stage_group32(x[:, :2], tabs, **kw)
    with pytest.raises(ValueError, match="mtile"):
        cf32.stage_group32(x, dict(tabs, mtile=tabs["mtile"][:1]), **kw)
    with pytest.raises(ValueError, match="cpl"):
        cf32.stage_group32(x, dict(tabs, cpl=tabs["cpl"].long()), **kw)
    with pytest.raises(ValueError, match="zero"):
        cf32.stage_group32(x, dict(tabs, zero=()), **kw)
    with pytest.raises(ValueError, match="t0"):
        cf32.stage_group32(x, tabs, **dict(kw, t0=1))
    rows = x.view(-1, 128)
    with pytest.raises(ValueError, match="int32"):
        cf32.bitslice_lane_groups(rows.long())
    with pytest.raises(ValueError, match="contiguous"):
        cf32.bitslice_lane_groups(rows[::2])
    with pytest.raises(ValueError, match="expected"):
        cf32.bitslice_lane_groups(rows.reshape(-1, 64))
