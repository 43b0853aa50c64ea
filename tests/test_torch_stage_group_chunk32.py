"""The CHUNK32 route of stage_group, on the CPU.

When every twiddle lies in the subfield GF(2^32) (the low 32 planes of the
tower's GF(2^128)), a butterfly is four GF(2^32) products, one per 32-plane
chunk, and csrc/stage_group.cu takes its CHUNK32 instantiation.  These
tests hold the algebra that route rests on, the flag that chooses it
(decided in numpy with the tables, carried by ``build_tables`` and
``tables_from_jax``), and the kernel's arithmetic transliterated into torch
over (row pair, chunk) units, against ``stage_group_plain``, which keeps the
general GF(2^128) multiply.  The kernel itself runs in
tests/test_torch_cuda.py on the card.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from binius_ntt_tpu.ntt import pallas_fused as pf
from binius_ntt_tpu_torch.convert import tables_from_jax
from binius_ntt_tpu_torch.fields import bitsliced
from binius_ntt_tpu_torch.ntt import cuda_fused as cf
from binius_ntt_tpu_torch.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu_torch.utils.bits import lsr, to_numpy, to_torch

SUB = cf.SUB_PLANES


def _rand(rng, shape):
    return to_torch(rng.integers(0, 1 << 32, shape, dtype=np.uint32))


def _subfield_twiddles(rng, shape, kind):
    """(..., 128) twiddle planes with planes 32..127 zero: 'uniform', each
    plane all-0 or all-1 (a high stage's twiddle), or 'packed', a low
    step's lane-varying wc (w0's u-lanes low, w1's high)."""
    w = torch.zeros(shape + (128,), dtype=torch.int32)
    if kind == "uniform":
        w[..., :SUB] = -to_torch(rng.integers(0, 2, shape + (SUB,),
                                              dtype=np.uint32))
    else:
        w0, w1 = _rand(rng, shape + (SUB,)), _rand(rng, shape + (SUB,))
        w[..., :SUB] = (w0 & cf._UM) | ((w1 & cf._UM) << 16)
    return w


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", ["uniform", "packed"])
def test_subfield_product_is_four_chunk_products(kind, seed):
    rng = np.random.default_rng(seed)
    w = _subfield_twiddles(rng, (64,), kind)
    v = _rand(rng, (64, 128))
    assert torch.equal(bitsliced.multiply(w, v, 7),
                       bitsliced.mul_subfield_chunks(v, w[..., :SUB], 7, 5))


def test_chunk_products_need_the_subfield():
    """One plane >= 32 set, and the chunk products are not the product."""
    rng = np.random.default_rng(3)
    w = _subfield_twiddles(rng, (64,), "uniform")
    w[:, SUB] = -1
    v = _rand(rng, (64, 128))
    assert not torch.equal(bitsliced.multiply(w, v, 7),
                           bitsliced.mul_subfield_chunks(v, w[..., :SUB], 7,
                                                         5))


@pytest.mark.parametrize("log_h,log_rate", [
    (6, 0), (9, 1), (10, 2), (12, 0), (12, 4), (13, 4), (16, 0), (16, 2),
    (20, 0), (24, 0), (24, 2), (27, 2), (28, 0), (28, 2), (29, 0)])
def test_build_tables_flag_chunk32(log_h, log_rate):
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    assert max(int(c) for r in rows for c in r) < 1 << SUB
    tables = cf.build_tables(rows, log_h, log_rate)
    assert len(tables) == len(cf.plan_groups(log_h - 5))
    assert all(g[7] is True for g in tables)


@pytest.mark.parametrize("plane", [SUB, 127])
@pytest.mark.parametrize("name", ["mtile", "minst", "lanes"])
def test_a_plane_above_31_takes_the_general_route(name, plane):
    rows = precompute_subspace_evals(8, 0, 7)
    mtile, minst, lanes, _ = cf.make_group_tables(rows, 8, 0, 0, 3, True)
    tabs = {"mtile": mtile, "minst": minst, "lanes": lanes}
    assert cf.subfield_tables(**tabs)
    tabs[name] = tabs[name].copy()
    tabs[name][1, plane] = 1
    assert not cf.subfield_tables(**tabs)


def test_tables_from_jax_carry_the_flag(monkeypatch):
    for mod in (pf, cf):
        monkeypatch.setattr(mod, "KB", 2)
        monkeypatch.setattr(mod, "KU", 2)
    rows = precompute_subspace_evals(9, 1, 7)
    jt = pf.build_tables(rows, 9, 1)
    tt = tables_from_jax(jt)
    assert [g[7] for g in tt] == [g[7] for g in cf.build_tables(rows, 9, 1)]
    assert all(g[7] is True for g in tt)
    t0, k, low, mtile, minst, lanes, zero = jt[-1]
    lanes = np.array(lanes)
    lanes[4, 100] = 1
    (*_, chunk32), = tables_from_jax([(t0, k, low, mtile, minst, lanes,
                                       zero)])
    assert chunk32 is False


@pytest.mark.parametrize("k,post,cols", [
    (9, 1 << 10, 1),     # the 2^24 upper group: a 64 KB column
    (10, 1, 1),          # the 2^24 bottom group: 128 KB, beyond the target
    (8, 1 << 16, 2),     # 64 KB of slots within 96 KB
    (5, 1 << 14, 8),     # PT columns, 32 KB
    (2, 2, 2),           # no more columns than the tile has
])
def test_chunk32_cols_fit_shared_memory(k, post, cols):
    assert cf.PT == 8
    assert cf.chunk32_cols(k, post) == cols
    assert post % cols == 0
    assert (SUB * 4 * cols) << k <= cf.CHUNK32_SMEM_LIMIT


def test_chunk32_cols_refuse_a_column_beyond_shared_memory():
    with pytest.raises(ValueError, match="CHUNK32"):
        cf.chunk32_cols(11, 1)


def _chunk32_model(x, mtile, minst, lanes, *, t0, k, include_low):
    """csrc/stage_group.cu's CHUNK32 arithmetic in torch: every butterfly
    as four GF(2^32) products with planes 0..31 of the twiddle, and the
    in-word stages in low_step32's form (u' = lo ^ w*cp, v' = u' ^ cp for
    both rows of a pair, lo and cp the rows' u- and v-lanes packed; the
    odd row's twiddle from the even row's, w1 = w0 ^ (m & 1))."""
    n_inst, post = cf._group_geometry(x, mtile, minst, lanes, t0, k,
                                      include_low)
    kk = 1 << k
    x5 = x.view(n_inst, kk, post, 4, SUB)
    q = torch.arange(n_inst, dtype=torch.int32)
    for st in range(k):
        p = k - 1 - st
        xv = x5.view(n_inst, 1 << st, 2, 1 << p, post, 4, SUB)
        u, v = xv[:, :, 0], xv[:, :, 1]
        blk = torch.arange(1 << st, dtype=torch.int32)
        w = (cf._parity_planes(blk[None, :, None], mtile[st, :SUB])
             ^ cf._parity_planes(q[:, None, None], minst[st, :SUB]))
        un = u ^ bitsliced.multiply(w[:, :, None, None, None, :], v, 5)
        v.copy_(un ^ v)
        u.copy_(un)
    if include_low:
        xf = x5.view(n_inst, kk, 4, SUB)
        t0 = torch.arange(0, kk, 2, dtype=torch.int32)
        for i in range(5):
            st = k + i
            x0, x1 = xf[:, 0::2], xf[:, 1::2]
            m = mtile[st, :SUB]
            w0 = (cf._parity_planes(t0[None, :, None], m)
                  ^ cf._parity_planes(q[:, None, None], minst[st, :SUB])
                  ^ lanes[i, :SUB])
            wc = (w0 & cf._UM) | ((w0 ^ -(m & 1)) << 16)
            lo = (x0 & cf._UM) | (x1 << 16)
            cp = lsr(x0, 16) | (x1 & cf._VM)
            un = lo ^ bitsliced.multiply(wc[:, :, None, :], cp, 5)
            vn = cp ^ un
            x0.copy_(cf._outshuffle((un & cf._UM) | (vn << 16)))
            x1.copy_(cf._outshuffle(lsr(un, 16) | (vn & cf._VM)))
    return x


@pytest.mark.parametrize("log_h,log_rate,kb,ku,pt", [
    (8, 0, 10, 9, 8),    # one bottom group; zero-twiddle top stage
    (9, 1, 2, 2, 2),     # bottom + upper group, column chunks, cosets
    (10, 2, 2, 2, 1),    # three groups, four cosets
])
def test_chunk32_arithmetic_matches_plain(log_h, log_rate, kb, ku, pt,
                                          monkeypatch):
    monkeypatch.setattr(cf, "KB", kb)
    monkeypatch.setattr(cf, "KU", ku)
    monkeypatch.setattr(cf, "PT", pt)
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    rng = np.random.default_rng(log_h + log_rate)
    cosets = 1 << log_rate
    x = _rand(rng, (cosets, (1 << log_h) // 32, 128))
    y = x.clone()
    for (t0, k, low, mtile, minst, lanes, zero,
         chunk32) in cf.build_tables(rows, log_h, log_rate):
        assert chunk32
        kw = dict(t0=t0, k=k, include_low=low)
        _chunk32_model(x, mtile, minst, lanes, **kw)
        cf.stage_group_plain(y, mtile, minst, lanes, zero_flags=zero, **kw)
        assert np.array_equal(to_numpy(x), to_numpy(y))
