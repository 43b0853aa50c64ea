"""Stage-group tables and stage_group of the torch port vs the JAX package.

The JAX side runs as its own tests run it (pallas_fused.stage_group with
emulate=True); both packages get the same tables and the same words, and
every comparison is exact word equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.layout.bitslicing import bitslice_transpose
from binius_ntt_tpu.ntt import pallas_fused as pf
from binius_ntt_tpu.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu.utils.mt19937 import mt19937_stream
from binius_ntt_tpu_torch.convert import tables_from_jax
from binius_ntt_tpu_torch.ntt import cuda_fused as cf
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch


def _plan(monkeypatch, kb, ku, pt):
    for mod in (pf, cf):
        monkeypatch.setattr(mod, "KB", kb)
        monkeypatch.setattr(mod, "KU", ku)
        monkeypatch.setattr(mod, "PT", pt)


def _sliced(log_h, log_rate):
    words = mt19937_stream(0xDEADBEEF + log_h + log_rate, (1 << log_h) * 4)
    return np.asarray(bitslice_transpose(words.reshape(-1, 128)))


@pytest.mark.parametrize("log_h,log_rate,kb,ku", [
    (8, 0, 10, 9), (9, 1, 2, 2), (12, 2, 3, 2), (14, 0, 8, 8),
])
def test_build_tables_match_reference(log_h, log_rate, kb, ku, monkeypatch):
    _plan(monkeypatch, kb, ku, 2)
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    want = pf.build_tables(rows, log_h, log_rate)
    got = cf.build_tables(rows, log_h, log_rate)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and g[6] == w[6]
        for gt, wt in zip(g[3:6], w[3:6]):
            if wt is None:
                assert gt is None
            else:
                assert np.array_equal(to_numpy(gt), np.asarray(wt))


def test_tables_from_jax_round_trip(monkeypatch):
    _plan(monkeypatch, 2, 2, 2)
    rows = precompute_subspace_evals(9, 1, 7)
    jt = pf.build_tables(rows, 9, 1)
    tt = tables_from_jax(jt)
    assert len(tt) == len(jt) == 2
    for t, j in zip(tt, jt):
        assert t[:3] == tuple(j[:3]) and t[6] == tuple(j[6])
        for a, b in zip(t[3:6], j[3:6]):
            if b is None:
                assert a is None
                continue
            assert a.dtype == torch.int32
            assert np.array_equal(to_numpy(a), np.asarray(b))
            # and back: the port's tensors carry the JAX arrays' bits
            assert np.array_equal(np.asarray(jnp.asarray(to_numpy(a))),
                                  np.asarray(b))


@pytest.mark.parametrize("log_h,log_rate,kb,ku,pt", [
    (8, 0, 10, 9, 8),    # one bottom group; zero-twiddle top stage
    (9, 1, 2, 2, 2),     # bottom + upper group, column chunks, cosets
    (10, 2, 2, 2, 1),    # three groups, four cosets
])
def test_stage_group_plain_matches_emulated_reference(
        log_h, log_rate, kb, ku, pt, monkeypatch):
    _plan(monkeypatch, kb, ku, pt)
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    jtables = pf.build_tables(rows, log_h, log_rate)
    cosets = 1 << log_rate
    data = _sliced(log_h, log_rate)
    x_jax = jnp.broadcast_to(jnp.asarray(data)[None], (cosets,) + data.shape)
    x_port = to_torch(data).repeat(cosets, 1).view(cosets, -1, 128)
    for jg, tg in zip(jtables, tables_from_jax(jtables)):
        t0, k, low, mtile, minst, lanes, zero = jg
        x_jax = pf.stage_group(x_jax, mtile, minst, lanes, log_h=log_h,
                               t0=t0, k=k, include_low=low, cosets=cosets,
                               zero_flags=zero, emulate=True)
        out = cf.stage_group_plain(x_port, *tg[3:6], t0=t0, k=k,
                                   include_low=low, zero_flags=zero)
        assert out is x_port          # in place
        assert np.array_equal(to_numpy(x_port), np.asarray(x_jax))


def test_stage_group_dispatch_on_cpu_runs_plain(monkeypatch):
    _plan(monkeypatch, 2, 2, 2)
    rows = precompute_subspace_evals(9, 1, 7)
    tables = cf.build_tables(rows, 9, 1)
    x = to_torch(_sliced(9, 1)).repeat(2, 1).view(2, -1, 128)
    y = x.clone()
    before = cf.stage_group.launches
    routes = dict(cf.stage_group.route_launches)
    for (t0, k, low, mtile, minst, lanes, zero, chunk32) in tables:
        kw = dict(t0=t0, k=k, include_low=low, zero_flags=zero)
        cf.stage_group(x, mtile, minst, lanes, chunk32=chunk32, **kw)
        cf.stage_group_plain(y, mtile, minst, lanes, **kw)
    assert torch.equal(x, y)
    assert cf.stage_group.launches == before
    assert cf.stage_group.route_launches == routes


def test_stage_group_rejects_bad_arguments():
    rows = precompute_subspace_evals(8, 0, 7)
    (t0, k, low, mtile, minst, lanes, zero, _), = cf.build_tables(rows, 8, 0)
    x = torch.zeros(1, 8, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        cf.stage_group(x.long(), mtile, minst, lanes, t0=t0, k=k,
                       include_low=low)
    with pytest.raises(ValueError, match="tiles"):
        cf.stage_group(x[:, :4].contiguous(), mtile, minst, lanes, t0=t0,
                       k=k, include_low=low)
    with pytest.raises(ValueError, match="lanes"):
        cf.stage_group(x, mtile, minst, None, t0=t0, k=k, include_low=low)
    with pytest.raises(ValueError, match="mtile"):
        cf.stage_group(x, mtile[:3], minst, lanes, t0=t0, k=k,
                       include_low=low)


def test_group_plan_covers_all_bits():
    for log_nb in range(0, 26):
        groups = cf.plan_groups(log_nb)
        bits = []
        for (t0, k, low) in groups:
            bits.extend(range(t0, t0 + k))
        assert bits == list(range(log_nb))
        assert groups[0][2] is True and all(not g[2] for g in groups[1:])
        assert all(k <= cf.KU for (_, k, _) in groups[1:])
