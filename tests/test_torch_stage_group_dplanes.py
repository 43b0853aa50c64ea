"""The sharded stage-group tables and stage_group's ``dplanes`` operand of
the torch port vs the JAX package.

The JAX side runs as its sharded path runs it on a CPU mesh:
``pallas_fused.stage_group(..., dplanes=..., emulate=True)`` under
``jax.jit``.  Both packages get the same tables and the same words; every
comparison is exact word equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.ntt import pallas_fused as pf
from binius_ntt_tpu.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu.ntt.additive_bitsliced import _expand_bits
from binius_ntt_tpu_torch.convert import sharded_tables_from_jax
from binius_ntt_tpu_torch.ntt import cuda_fused as cf
from binius_ntt_tpu_torch.parallel.ntt128_sharded import shard_dplanes
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch

GRID = [(9, 0, 1), (10, 1, 2), (13, 0, 3), (14, 2, 3)]
PLANS = {"production": (10, 9, 8), "forced": (2, 2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the torch side.  Parallel test workers share
    the machine's cores, and torch's default threads in several workers at
    once oversubscribe them: six concurrent runs of the (14, 2) transforms
    took over 900 s at 8 threads each and 22 s at one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(monkeypatch, kb, ku, pt):
    for mod in (pf, cf):
        monkeypatch.setattr(mod, "KB", kb)
        monkeypatch.setattr(mod, "KU", ku)
        monkeypatch.setattr(mod, "PT", pt)


@functools.lru_cache(maxsize=None)
def _jax_group(log_h, t0, k, low, cosets, zero_flags, log_nb):
    """The JAX stage group, jitted once a shape; dplanes is an argument."""
    return jax.jit(lambda x, mt, mi, ln, dpl: pf.stage_group(
        x, mt, mi, ln, log_h=log_h, t0=t0, k=k, include_low=low,
        cosets=cosets, zero_flags=zero_flags, log_nb=log_nb, dplanes=dpl,
        emulate=True))


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("log_h,log_rate,log_d", GRID)
def test_sharded_tables_match_reference(log_h, log_rate, log_d, plan,
                                        monkeypatch):
    _plan(monkeypatch, *PLANS[plan])
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    want = pf.build_tables_sharded(rows, log_h, log_rate, log_d)
    got = cf.build_tables_sharded(rows, log_h, log_rate, log_d)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        t0, k, low, mtile, minst, lanes, zero, chunk32, dtab = g
        assert (t0, k, low) == tuple(w[:3])
        assert zero == tuple(w[6])
        for gt, wt in ((mtile, w[3]), (minst, w[4]), (lanes, w[5]),
                       (dtab, w[7])):
            if wt is None:
                assert gt is None
            else:
                assert np.array_equal(to_numpy(gt), np.asarray(wt))
        # every twiddle of these domains lies in GF(2^32), the device
        # table's included: the kernel's CHUNK32 route holds
        assert chunk32
        assert not to_numpy(dtab)[..., 1:].any()


def test_sharded_tables_from_jax(monkeypatch):
    _plan(monkeypatch, 2, 2, 2)
    rows = precompute_subspace_evals(13, 0, 7)
    jt = pf.build_tables_sharded(rows, 13, 0, 3)
    tt = sharded_tables_from_jax(jt)
    ref = cf.build_tables_sharded(rows, 13, 0, 3)
    for t, r in zip(tt, ref):
        assert t[:3] == r[:3] and t[6:8] == r[6:8]
        for a, b in zip(t[3:6] + t[8:], r[3:6] + r[8:]):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("log_h,log_rate,log_d", [(20, 2, 3), (24, 0, 2)])
def test_device_table_stays_in_the_subfield(log_h, log_rate, log_d):
    """The dtab rows are XORs of the same subspace constants as mtile and
    minst, so they lie in GF(2^32) up to 2^32 points: words 1..3 are zero
    at the sizes the card runs."""
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    for *_, chunk32, dtab in cf.build_tables_sharded(rows, log_h, log_rate,
                                                     log_d):
        assert chunk32 and not to_numpy(dtab)[..., 1:].any()


def test_subfield_flag_reads_the_device_table():
    rows = precompute_subspace_evals(10, 1, 7)
    mtile, minst, lanes, _, dtab = cf.make_group_tables_sharded(
        rows, 10, 1, 0, 3, True, 2)
    assert cf.subfield_tables(mtile, minst, lanes, dtab)
    dtab = dtab.copy()
    dtab[1, 3, 2] = 1
    assert not cf.subfield_tables(mtile, minst, lanes, dtab)


@pytest.mark.parametrize("log_h,log_rate,log_d", [(9, 0, 1), (13, 0, 3)])
def test_a_stage_lives_on_the_device_bits_alone(log_h, log_rate, log_d):
    """The top local stage at rate 0 has one butterfly block a shard: its
    twiddle is the device bits' part alone, zero on shard 0 only.  Its zero
    flag must be clear, or the kernel would skip it on every shard."""
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    t0, k, low, mtile, minst, lanes, zero, _, dtab = cf.build_tables_sharded(
        rows, log_h, log_rate, log_d)[0]
    mt, mi, dt = to_numpy(mtile), to_numpy(minst), to_numpy(dtab)
    only_d = [st for st in range(mt.shape[0])
              if not mt[st].any() and not mi[st].any() and dt[st].any()]
    assert only_d, "no stage whose twiddle is the device bits' alone"
    for st in only_d:
        assert not zero[st]
        assert not dt[st, 0].any() and dt[st, 1:].any()


def test_shard_dplanes_expands_the_device_row():
    rng = np.random.default_rng(3)
    dtab = rng.integers(0, 1 << 32, (6, 4, 4), dtype=np.uint32)
    for d in range(4):
        got = to_numpy(shard_dplanes(to_torch(dtab), d))
        want = np.asarray(_expand_bits(jnp.asarray(dtab[:, d])))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("log_h,log_rate,log_d", GRID)
def test_stage_group_plain_with_dplanes_matches_reference(
        log_h, log_rate, log_d, plan, monkeypatch):
    """Every group of the local plan, on random words, for every shard d."""
    _plan(monkeypatch, *PLANS[plan])
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    jt = pf.build_tables_sharded(rows, log_h, log_rate, log_d)
    tt = cf.build_tables_sharded(rows, log_h, log_rate, log_d)
    cosets, log_nb = 1 << log_rate, log_h - 5 - log_d
    rng = np.random.default_rng(log_h * 100 + log_rate * 10 + log_d)
    for (t0, k, low, mtile, minst, lanes, zero, _, dtab), jg in zip(tt, jt):
        fn = _jax_group(log_h, t0, k, low, cosets, zero, log_nb)
        x = rng.integers(0, 1 << 32, (cosets, 1 << log_nb, 128),
                         dtype=np.uint32)
        for d in range(1 << log_d):
            dpl = shard_dplanes(dtab, d)
            want = np.asarray(fn(jnp.asarray(x), jg[3], jg[4], jg[5],
                                 _expand_bits(jg[7][:, d])))
            got = cf.stage_group_plain(to_torch(x), mtile, minst, lanes,
                                       t0=t0, k=k, include_low=low,
                                       zero_flags=zero, dplanes=dpl)
            assert np.array_equal(to_numpy(got), want), (t0, k, d)


def test_stage_group_dispatch_on_cpu_passes_dplanes():
    rows = precompute_subspace_evals(9, 0, 7)
    t0, k, low, mtile, minst, lanes, zero, _, dtab = cf.build_tables_sharded(
        rows, 9, 0, 1)[0]
    x = to_torch(np.random.default_rng(1).integers(
        0, 1 << 32, (1, 8, 128), dtype=np.uint32))
    dpl = shard_dplanes(dtab, 1)
    kw = dict(t0=t0, k=k, include_low=low, zero_flags=zero)
    want = cf.stage_group_plain(x.clone(), mtile, minst, lanes, dplanes=dpl,
                                **kw)
    without = cf.stage_group_plain(x.clone(), mtile, minst, lanes, **kw)
    got = cf.stage_group(x.clone(), mtile, minst, lanes, dplanes=dpl, **kw)
    assert torch.equal(got, want) and not torch.equal(got, without)


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout"])
def test_stage_group_rejects_bad_dplanes(bad):
    rows = precompute_subspace_evals(9, 0, 7)
    t0, k, low, mtile, minst, lanes, zero, _, dtab = cf.build_tables_sharded(
        rows, 9, 0, 1)[0]
    dpl = shard_dplanes(dtab, 1)
    dpl = {"shape": dpl[:-1], "dtype": dpl.to(torch.int64),
           "layout": dpl.t().contiguous().t()}[bad]
    x = torch.zeros((1, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="dplanes"):
        cf.stage_group(x, mtile, minst, lanes, t0=t0, k=k, include_low=low,
                       zero_flags=zero, dplanes=dpl)
