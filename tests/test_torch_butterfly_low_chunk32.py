"""The CHUNK32 route of butterfly_low, on the CPU.

When every twiddle of a low (in-word) stage lies in the subfield GF(2^32)
(words 1..3 of the batch parts and lane planes 32..127 zero), csrc/
butterfly.cu runs the stage as one thread per (row pair, 32-plane chunk):
the u lanes of rows A = 2i and B = 2i + 1 packed into one word, one
GF(2^32) product per chunk, unpacked into both rows.  These tests hold a
torch transliteration of that arithmetic to ``butterfly_low_plain``, which
keeps the general GF(2^128) multiply of every lane, and to one stage of the
JAX package's per-stage path (its jnp branch, as
tests/test_torch_ntt128_per_stage.py runs it), at every stage, rates 0..2
and row counts 1, 2 and 64; and they hold the route flag that
``AdditiveNTT128`` records to chip_smoke.py's own test of the tables.  The
kernel itself runs in tests/test_torch_cuda.py on the card.  Every
comparison is exact (word equality).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from binius_ntt_tpu.ntt.additive_bitsliced import \
    AdditiveNTT128 as AdditiveNTT128Jax
from binius_ntt_tpu_torch import AdditiveNTT128
from binius_ntt_tpu_torch.fields import bitsliced
from binius_ntt_tpu_torch.fields.tower_simd import MASKS
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck
from binius_ntt_tpu_torch.ntt.cuda_fused import SUB_PLANES as SUB
from binius_ntt_tpu_torch.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu_torch.ntt.additive_bitsliced import (apply_per_stage,
                                                         routes,
                                                         per_stage_tables)
from binius_ntt_tpu_torch.utils.bits import lsr, to_numpy, to_torch, u32
from test_torch_ntt128_per_stage import _jax_stage

W = 128
ROOT = Path(__file__).resolve().parents[1]


def _words(seed, shape):
    return to_torch(np.random.default_rng(seed).integers(
        0, 1 << 32, shape, dtype=np.uint32))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _expand_word0(w: torch.Tensor) -> torch.Tensor:
    """(P,) words -> (P, 32) planes, plane i all ones where bit i is set
    (an arithmetic shift keeps bit i in place for every i < 32)."""
    return -((w[:, None] >> torch.arange(SUB, dtype=torch.int32)) & 1)


def low_model(x: torch.Tensor, a4: torch.Tensor, lane_planes: torch.Tensor,
              stage: int) -> torch.Tensor:
    """csrc/butterfly.cu's CHUNK32 low stage in torch, on a copy of x: rows
    A = 2i and B = 2i + 1 (a last row without a partner packed with a zero
    row), lo and cp packed, the packed twiddle wp from word 0 of each row's
    a4 and lane planes 0..31, four height-5 products, then unpacked."""
    shift = 1 << stage
    um = MASKS[stage]                        # the u (even) lanes
    vm = u32(um << shift)
    rows = x.shape[0]
    pad = rows % 2
    xp = torch.cat([x, torch.zeros(pad, W, dtype=torch.int32)])
    a4p = torch.cat([a4, torch.zeros(pad, 4, dtype=torch.int32)])
    xa, xb = xp[0::2], xp[1::2]
    lo = (xa & um) | ((xb << shift) & vm)
    cp = (lsr(xa, shift) & um) | (xb & vm)
    sel = ((_expand_word0(a4p[0::2, 0]) & um)
           | (_expand_word0(a4p[1::2, 0]) & vm))
    lanes = lane_planes[:SUB] & um
    wp = sel ^ lanes ^ (lanes << shift)
    prod = torch.cat([bitsliced.multiply(wp, cp[:, c * SUB:(c + 1) * SUB], 5)
                      for c in range(W // SUB)], dim=-1)
    un = lo ^ prod                           # u' of both rows
    vn = cp ^ un                             # v' of both rows
    oa = (un & um) | ((vn << shift) & vm)
    ob = (lsr(un, shift) & um) | (vn & vm)
    return torch.stack([oa, ob], dim=1).reshape(-1, W)[:rows]


_JAX = {}


def _jax_ntt(log_h, log_rate):
    key = (log_h, log_rate)
    if key not in _JAX:
        _JAX[key] = AdditiveNTT128Jax(log_h, log_rate, use_pallas=False,
                                      use_fused=False)
    return _JAX[key]


# ---- the packed stage against plain and the JAX stage --------------------

# R = cosets * nb rows: 1 at (5, 0), 2 at (5, 1), 4 at (5, 2), 64 at the rest
@pytest.mark.parametrize("stage", range(5))
@pytest.mark.parametrize("log_h,log_rate", [
    (5, 0), (5, 1), (5, 2), (11, 0), (10, 1), (9, 2)])
def test_low_model_matches_plain_and_jax(log_h, log_rate, stage):
    cosets, nb = 1 << log_rate, (1 << log_h) // 32
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device="cpu")
    _, low_batch, low_lanes = ntt.stage_tables
    assert ntt.chunk32[stage] is True
    x = _words(1000 * log_h + 10 * log_rate + stage, (cosets * nb, W))
    got = low_model(x, low_batch[stage], low_lanes[stage], stage)
    want = ck.butterfly_low_plain(x.clone(), low_batch[stage],
                                  low_lanes[stage], stage)
    assert torch.equal(got, want)
    jax_out = _jax_stage(to_numpy(x).reshape(cosets, nb, W),
                         _jax_ntt(log_h, log_rate), stage, log_h, log_rate)
    assert np.array_equal(to_numpy(got), jax_out)


@pytest.mark.parametrize("rows", [1, 2, 3, 70])
@pytest.mark.parametrize("stage", range(5))
def test_low_model_matches_plain_on_random_subfield_tables(stage, rows):
    """Random GF(2^32) twiddles: a4 word 0 and lane planes 0..31 random,
    the rest zero; an odd row count leaves the last row without a
    partner."""
    x = _words(stage, (rows, W))
    a4 = torch.zeros(rows, 4, dtype=torch.int32)
    a4[:, 0] = _words(10 + stage, (rows,))
    lanes = torch.zeros(W, dtype=torch.int32)
    lanes[:SUB] = _words(20 + stage, (SUB,))
    assert ck.low_subfield(a4, lanes)
    assert torch.equal(low_model(x, a4, lanes, stage),
                       ck.butterfly_low_plain(x.clone(), a4, lanes, stage))


@pytest.mark.parametrize("where", ["a4 word 1", "a4 word 3", "plane 32",
                                   "plane 127"])
def test_a_high_plane_takes_the_general_route(where):
    """One twiddle bit outside GF(2^32): the flag is false, and the chunk
    products are no longer the stage."""
    rows, stage = 8, 2
    x = _words(30, (rows, W))
    a4 = torch.zeros(rows, 4, dtype=torch.int32)
    a4[:, 0] = _words(31, (rows,))
    lanes = torch.zeros(W, dtype=torch.int32)
    lanes[:SUB] = _words(32, (SUB,))
    if where.startswith("a4"):
        a4[:, int(where[-1])] = _words(33, (rows,))
    else:
        lanes[int(where.split()[-1])] = -1
    assert not ck.low_subfield(a4, lanes)
    assert not _chip_smoke().subfield_step((a4, lanes, stage))
    assert not torch.equal(low_model(x, a4, lanes, stage),
                           ck.butterfly_low_plain(x.clone(), a4, lanes,
                                                  stage))


# ---- the route flag ------------------------------------------------------

@pytest.mark.parametrize("log_h,log_rate", [
    (5, 0), (5, 1), (5, 2), (5, 3), (5, 4), (8, 3), (12, 0), (12, 4),
    (16, 2), (20, 0), (20, 2)])
def test_route_flag_true_for_every_per_stage_table(log_h, log_rate):
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    tables = per_stage_tables(rows, log_h, log_rate, "cpu")
    assert routes(*tables) == {s: True for s in range(log_h)}


@pytest.mark.parametrize("log_h,log_rate", [(5, 0), (6, 1), (9, 2), (12, 4)])
def test_recorded_flag_equals_chip_smoke_subfield_step(log_h, log_rate):
    """The flag AdditiveNTT128 records at construction is chip_smoke's test
    of the same tables, and each low step's arguments end with it."""
    subfield_step = _chip_smoke().subfield_step
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device="cpu")
    lows = [(s, args) for s, k, _, args in ntt.stage_steps()
            if k is ck.butterfly_low]
    assert [s for s, _ in lows] == [4, 3, 2, 1, 0]
    for s, args in lows:
        assert args[-1] is ntt.chunk32[s] is subfield_step(args)


def test_fused_path_records_no_low_routes():
    assert AdditiveNTT128(6, 0, device="cpu").chunk32 == {}


def test_apply_per_stage_computes_the_flags_when_not_given():
    ntt = AdditiveNTT128(7, 1, use_fused=False, device="cpu")
    data = _words(40, (4, W))
    want = ntt.apply_sliced(data)
    assert torch.equal(apply_per_stage(data, *ntt.stage_tables, log_rate=1),
                       want)
    assert torch.equal(apply_per_stage(data, *ntt.stage_tables, log_rate=1,
                                       chunk32=ntt.chunk32), want)


@pytest.mark.parametrize("chunk32", [False, True])
def test_wrapper_runs_plain_on_the_cpu_on_either_route(chunk32):
    ntt = AdditiveNTT128(7, 1, use_fused=False, device="cpu")
    _, low_batch, low_lanes = ntt.stage_tables
    x = _words(41, (8, W))
    before = (ck.butterfly_low.launches, dict(ck.butterfly_low.route_launches))
    for s in range(5):
        args = (low_batch[s], low_lanes[s], s)
        assert torch.equal(ck.butterfly_low(x.clone(), *args, chunk32),
                           ck.butterfly_low_plain(x.clone(), *args))
    assert (ck.butterfly_low.launches,
            ck.butterfly_low.route_launches) == before
