"""The CHUNK32 route of butterfly_high, on the CPU.

When every twiddle of a high stage lies in the subfield GF(2^32) (words
1..3 of its compact twiddles zero), csrc/butterfly.cu runs the stage as
persistent blocks walking tiles of 16 row pairs, one thread per (row pair,
32-plane chunk) and one GF(2^32) product a thread.  These tests hold a
torch transliteration of that arithmetic, in the kernel's tile order, to
``butterfly_high_plain``, which keeps the general GF(2^128) multiply, and
to one stage of the JAX package's per-stage path (its jnp branch, as
tests/test_torch_ntt128_per_stage.py runs it), at every high stage of
log_h 9..12 and rates 0..2 and on random GF(2^32) tables; and they hold
the route flag that ``AdditiveNTT128`` records to chip_smoke.py's own test
of the tables.  The kernel itself runs in tests/test_torch_cuda.py on the
card.  Every comparison is exact (word equality).
"""

import numpy as np
import pytest
import torch

from binius_ntt_tpu.ntt.additive_bitsliced import \
    AdditiveNTT128 as AdditiveNTT128Jax
from binius_ntt_tpu_torch import AdditiveNTT128
from binius_ntt_tpu_torch.fields import bitsliced
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck
from binius_ntt_tpu_torch.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu_torch.ntt.additive_bitsliced import (apply_per_stage,
                                                         routes,
                                                         per_stage_tables)
from binius_ntt_tpu_torch.utils.bits import to_numpy
from test_torch_butterfly_low_chunk32 import _chip_smoke, _expand_word0, _words
from test_torch_ntt128_per_stage import _jax_stage

W = 128
SUB = 32                 # planes of a GF(2^32) chunk
PAIRS_B = 16             # row pairs of a tile


def tile_rows(t: int, pairs: int, log_db: int) -> list[int]:
    """The global rows of tile t, as the kernel's row lambda gives them:
    two runs of 16 rows, the first at the u row of the tile's first pair,
    the second max(db, 16) rows on, cut to the tile's pairs."""
    p = t * PAIRS_B
    run0 = ((p >> log_db) << (log_db + 1)) + (p & ((1 << log_db) - 1))
    gap = 1 << max(log_db, 4)
    n = 2 * min(PAIRS_B, pairs - p)
    return [run0 + (gap if j >= PAIRS_B else 0) + (j & (PAIRS_B - 1))
            for j in range(n)]


def high_model(x: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """csrc/butterfly.cu's CHUNK32 high stage in torch, on a copy of x: each
    tile fetched by its rows, the pair q of the tile at tile rows u and u +
    min(db, 16), its twiddle's 32 planes from word 0 of w4[(16 t + q) >>
    log_db], one height-5 product per chunk, u ^= prod, v ^= u, the tile
    stored back."""
    out = x.clone()
    rows = x.shape[0]
    log_db = (rows // w4.shape[0]).bit_length() - 2
    pairs = rows // 2
    ldb = min(log_db, 4)
    for t in range(-(-pairs // PAIRS_B)):
        g = torch.tensor(tile_rows(t, pairs, log_db))
        tile = out[g]
        q = torch.arange(len(g) // 2)
        u = ((q >> ldb) << (ldb + 1)) | (q & ((1 << ldb) - 1))
        v = u + (1 << ldb)
        wp = _expand_word0(w4[(t * PAIRS_B + q) >> log_db, 0])
        for c in range(W // SUB):
            cols = slice(c * SUB, (c + 1) * SUB)
            tile[u, cols] ^= bitsliced.multiply(wp, tile[v, cols], 5)
            tile[v, cols] ^= tile[u, cols]
        out[g] = tile
    return out


def _subfield_table(seed, blocks):
    w4 = torch.zeros(blocks, 4, dtype=torch.int32)
    w4[:, 0] = _words(seed, (blocks,))
    return w4


# ---- the tiles -----------------------------------------------------------

@pytest.mark.parametrize("rows,db", [(2, 1), (6, 1), (48, 8), (32, 16),
                                     (64, 32), (4096, 1024), (256, 2),
                                     (256, 4)])
def test_tiles_cover_every_pair_once(rows, db):
    """The tiles' rows are every row once, and each tile holds whole
    pairs: u rows with their v rows db on."""
    log_db, pairs = db.bit_length() - 1, rows // 2
    seen = []
    for t in range(-(-pairs // PAIRS_B)):
        g = tile_rows(t, pairs, log_db)
        ldb = min(log_db, 4)
        for q in range(len(g) // 2):
            u = ((q >> ldb) << (ldb + 1)) | (q & ((1 << ldb) - 1))
            assert g[u + (1 << ldb)] == g[u] + db
            assert (g[u] // db) % 2 == 0               # a u row
            assert (t * PAIRS_B + q) >> log_db == g[u] // (2 * db)
        seen += g
    assert sorted(seen) == list(range(rows))


# ---- the chunk products against plain and the JAX stage ------------------

_JAX = {}


def _jax_ntt(log_h, log_rate):
    key = (log_h, log_rate)
    if key not in _JAX:
        _JAX[key] = AdditiveNTT128Jax(log_h, log_rate, use_pallas=False,
                                      use_fused=False)
    return _JAX[key]


@pytest.mark.parametrize("log_h,log_rate", [
    (9, 0), (9, 1), (9, 2), (10, 0), (10, 1), (10, 2), (11, 0), (11, 1),
    (11, 2), (12, 0), (12, 1), (12, 2)])
def test_high_model_matches_plain_and_jax(log_h, log_rate):
    """Every high stage, each on its own random rows."""
    cosets, nb = 1 << log_rate, (1 << log_h) // 32
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device="cpu")
    high, _, _ = ntt.stage_tables
    for s in range(log_h - 1, 4, -1):
        assert ntt.chunk32[s] is True
        x = _words(1000 * log_h + 10 * log_rate + s, (cosets * nb, W))
        got = high_model(x, high[s])
        assert torch.equal(got, ck.butterfly_high_plain(x.clone(), high[s]))
        jax_out = _jax_stage(to_numpy(x).reshape(cosets, nb, W),
                             _jax_ntt(log_h, log_rate), s, log_h, log_rate)
        assert np.array_equal(to_numpy(got), jax_out), s


@pytest.mark.parametrize("rows,db", [(2, 1), (6, 1), (48, 8), (32, 16),
                                     (64, 32), (4096, 1024)])
def test_high_model_matches_plain_on_random_subfield_tables(rows, db):
    """Random GF(2^32) twiddles: a partial tile (2, 6 and 48 rows), several
    blocks a tile (db < 16) and one block over several tiles (db >= 16)."""
    x = _words(rows + db, (rows, W))
    w4 = _subfield_table(rows + db + 1, rows // (2 * db))
    assert ck.high_subfield(w4)
    assert torch.equal(high_model(x, w4),
                       ck.butterfly_high_plain(x.clone(), w4))


@pytest.mark.parametrize("word", [1, 2, 3])
def test_a_high_word_takes_the_general_route(word):
    """One twiddle bit outside GF(2^32): the flag is false, and the chunk
    products are no longer the stage."""
    x = _words(50 + word, (64, W))
    w4 = _subfield_table(60, 4)
    w4[2, word] = 1 << 7
    assert not ck.high_subfield(w4)
    assert not _chip_smoke().subfield_step((w4, False))
    assert not torch.equal(high_model(x, w4),
                           ck.butterfly_high_plain(x.clone(), w4))


# ---- the route flag ------------------------------------------------------

@pytest.mark.parametrize("log_h,log_rate", [
    (6, 0), (6, 4), (8, 3), (12, 0), (12, 4), (16, 0), (16, 2)])
def test_route_flag_true_for_every_per_stage_table(log_h, log_rate):
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    tables = per_stage_tables(rows, log_h, log_rate, "cpu")
    assert routes(*tables) == {s: True for s in range(log_h)}


@pytest.mark.parametrize("log_h,log_rate", [(6, 0), (7, 1), (9, 2),
                                            (12, 4)])
def test_recorded_flag_equals_chip_smoke_subfield_step(log_h, log_rate):
    """The flag AdditiveNTT128 records at construction is chip_smoke's test
    of the same table, and each high step's arguments end with it."""
    subfield_step = _chip_smoke().subfield_step
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device="cpu")
    highs = [(s, args) for s, k, _, args in ntt.stage_steps()
             if k is ck.butterfly_high]
    assert [s for s, _ in highs] == list(range(log_h - 1, 4, -1))
    for s, args in highs:
        assert args[-1] is ntt.chunk32[s] is subfield_step(args)


def test_log_h_5_and_the_fused_path_record_no_high_routes():
    assert list(AdditiveNTT128(5, 2, device="cpu").chunk32) == [0, 1, 2, 3, 4]
    assert AdditiveNTT128(6, 0, device="cpu").chunk32 == {}


def test_apply_per_stage_computes_the_flags_when_not_given():
    ntt = AdditiveNTT128(8, 1, use_fused=False, device="cpu")
    data = _words(70, (8, W))
    want = ntt.apply_sliced(data)
    assert torch.equal(apply_per_stage(data, *ntt.stage_tables, log_rate=1),
                       want)
    assert torch.equal(apply_per_stage(data, *ntt.stage_tables, log_rate=1,
                                       chunk32=ntt.chunk32), want)


@pytest.mark.parametrize("chunk32", [False, True])
def test_wrapper_runs_plain_on_the_cpu_on_either_route(chunk32):
    ntt = AdditiveNTT128(8, 1, use_fused=False, device="cpu")
    high, _, _ = ntt.stage_tables
    x = _words(71, (16, W))
    before = (ck.butterfly_high.launches,
              dict(ck.butterfly_high.route_launches))
    for s in range(5, 8):
        assert torch.equal(ck.butterfly_high(x.clone(), high[s], chunk32),
                           ck.butterfly_high_plain(x.clone(), high[s]))
    assert (ck.butterfly_high.launches,
            ck.butterfly_high.route_launches) == before
