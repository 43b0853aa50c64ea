"""The port's CUDA kernels on the card, against their plain versions, and
the NTT (GF(2^128) fused and per-stage, GF(2^32) and BB31) and sumcheck
(GF(2^128) and QM31) paths on the card against their golden digests.

Every test here needs an sm_90 GPU and nvcc; it is marked ``cuda`` and skips
elsewhere.  The file imports no JAX, so it also runs on a machine with only
PyTorch, where it is run without the JAX-configuring conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import hashlib

import numpy as np
import pytest
import torch

import test_torch_prime_sumcheck_golden as prime_golden
from golden_hashes import ADDITIVE_NTT_HASHES, BB31_NTT_HASHES
from golden_hashes_oracle import ADDITIVE_NTT128_HASHES
from test_torch_sumcheck_golden import (SUMCHECK_TRANSCRIPT_MD5,
                                        protocol_inputs, transcript,
                                        transcript_md5)
from torch_stage_group_tables import random_group_tables
from binius_ntt_tpu_torch import (AdditiveNTT, AdditiveNTT128, NTTRadix2,
                                  PrimeFieldSumcheck, Sumcheck, _build,
                                  tower_compact)
from binius_ntt_tpu_torch.fields import baby_bear as bb
from binius_ntt_tpu_torch.fields import tower_scalar
from binius_ntt_tpu_torch.layout.bitslicing import (
    bitslice_transpose, bitslice_transpose_streamed,
    bitslice_transpose_streamed_cols, bitslice_untranspose,
    bitslice_untranspose_streamed)
from binius_ntt_tpu_torch.ntt import additive_bitsliced as ab
from binius_ntt_tpu_torch.ntt import cuda_fused as cf
from binius_ntt_tpu_torch.ntt import cuda_fused32 as cf32
from binius_ntt_tpu_torch.ntt import cuda_fused_bb31 as cfb
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck
from binius_ntt_tpu_torch.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu_torch.parallel.mesh import make_mesh
from binius_ntt_tpu_torch.parallel.ntt128_sharded import (
    ShardedAdditiveNTT128, shard_dplanes)
from binius_ntt_tpu_torch.sumcheck import cuda_prime_round as cpr
from binius_ntt_tpu_torch.sumcheck import cuda_round as cr
from binius_ntt_tpu_torch.sumcheck import verifier as V
from binius_ntt_tpu_torch.sumcheck.prime_field import check_transcript
from binius_ntt_tpu_torch.utils.bits import lsr, to_numpy, to_torch
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _words(log_h, log_rate):
    return mt19937_stream(0xDEADBEEF + log_h + log_rate, (1 << log_h) * 4)


def _rand(seed, shape, device):
    rng = np.random.default_rng(seed)
    return to_torch(rng.integers(0, 1 << 32, shape, dtype=np.uint32), device)


@pytest.mark.parametrize("rows", [1, 31, 32, 33, 127, 1 << 12,
                                  (1 << 15) + 5, 1 << 18])
def test_mul_tiles_kernel_matches_plain(dev, rows):
    a, b = _rand(1, (rows, 128), dev), _rand(2, (rows, 128), dev)
    before = ck.mul_tiles.launches
    got = ck.mul_tiles(a, b)
    torch.cuda.synchronize()
    assert ck.mul_tiles.launches == before + 1
    assert torch.equal(got, ck.mul_tiles_plain(a, b))


def test_mul_tiles_takes_rows_that_do_not_start_on_16_bytes(dev):
    """A contiguous (N, 128) view one word into a flat buffer passes every
    shape check; the wrapper copies it before the kernel's 16-byte loads."""
    flat_a, flat_b = _rand(4, (1 + 40 * 128,), dev), _rand(5, (40 * 128,), dev)
    a = flat_a[1:].view(40, 128)
    assert a.is_contiguous() and a.data_ptr() % 16 == 4
    b = flat_b.view(40, 128)
    got = ck.mul_tiles(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.mul_tiles_plain(a, b))
    assert torch.equal(ck.mul_tiles(b, a), ck.mul_tiles_plain(b, a))


def test_mul_tiles_entry_refuses_a_pointer_off_16_bytes(dev):
    a = _rand(6, (2 * 128 + 4,), dev)
    out = torch.zeros(2 * 128 + 4, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.library()
    for pa, pz in ((a.data_ptr() + 4, out.data_ptr()),
                   (a.data_ptr(), out.data_ptr() + 8)):
        rc = lib.bntt_mul_tiles(pa, a.data_ptr(), pz, 2, stream)
        torch.cuda.synchronize()
        assert rc == 1                  # cudaErrorInvalidValue
    assert not out.any()
    assert lib.bntt_mul_tiles(a.data_ptr(), a.data_ptr(), out.data_ptr(), 2,
                              stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out[:256].view(2, 128),
                       ck.mul_tiles_plain(a[:256].view(2, 128),
                                          a[:256].view(2, 128)))


def test_mul_tiles_refuses_what_the_kernel_does_not_take(dev):
    a = _rand(3, (64, 128), dev)
    with pytest.raises(ValueError, match="contiguous"):
        ck.mul_tiles(a[::2], a[::2])
    with pytest.raises(ValueError, match="expected"):
        ck.mul_tiles(a, a.cpu())
    with pytest.raises(ValueError, match="int32"):
        ck.mul_tiles(a.long(), a.long())


@pytest.mark.parametrize("log_h,log_rate,kb,ku,pt", [
    (9, 1, 2, 2, 2), (12, 0, 2, 2, 2), (10, 2, 3, 1, 1), (13, 4, 8, 8, 8),
    (16, 2, 10, 9, 8),
])
def test_stage_group_kernel_matches_plain(dev, log_h, log_rate, kb, ku, pt,
                                          monkeypatch):
    monkeypatch.setattr(cf, "KB", kb)
    monkeypatch.setattr(cf, "KU", ku)
    monkeypatch.setattr(cf, "PT", pt)
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    tables = cf.build_tables(rows, log_h, log_rate, dev)
    cosets = 1 << log_rate
    data = bitslice_transpose(to_torch(_words(log_h, log_rate),
                                       dev).view(-1, 128))
    x = data.repeat(cosets, 1).view(cosets, -1, 128)
    before = cf.stage_group.launches
    routes = dict(cf.stage_group.route_launches)
    for (t0, k, low, mtile, minst, lanes, zero, chunk32) in tables:
        assert chunk32             # the domain's twiddles lie in GF(2^32)
        kw = dict(t0=t0, k=k, include_low=low, zero_flags=zero)
        want = cf.stage_group_plain(x.clone(), mtile, minst, lanes, **kw)
        assert cf.stage_group(x, mtile, minst, lanes, chunk32=chunk32,
                              **kw) is x
        torch.cuda.synchronize()
        assert torch.equal(x, want)
    assert cf.stage_group.launches == before + len(tables)
    assert cf.stage_group.route_launches == {
        "chunk32": routes["chunk32"] + len(tables),
        "general": routes["general"]}


@pytest.mark.parametrize("high_planes", [True, False])
@pytest.mark.parametrize("log_h,log_rate,kb,ku,pt", [
    (9, 1, 2, 2, 2), (12, 0, 8, 8, 8), (10, 2, 3, 1, 1)])
def test_stage_group_kernel_on_random_tables(dev, log_h, log_rate, kb, ku,
                                             pt, high_planes, monkeypatch):
    """Each instantiation on random tables through a whole plan: the
    general one on twiddles with planes >= 32, CHUNK32 on GF(2^32) ones."""
    monkeypatch.setattr(cf, "KB", kb)
    monkeypatch.setattr(cf, "KU", ku)
    monkeypatch.setattr(cf, "PT", pt)
    route = "general" if high_planes else "chunk32"
    x = _rand(20 + log_h, (1 << log_rate, (1 << log_h) // 32, 128), dev)
    rng = np.random.default_rng(100 * log_h)
    before = cf.stage_group.route_launches[route]
    plan = list(reversed(cf.plan_groups(log_h - 5)))
    for t0, k, low in plan:
        mtile, minst, lanes = random_group_tables(
            rng, k, low, 128 if high_planes else cf.SUB_PLANES, dev)
        kw = dict(t0=t0, k=k, include_low=low)
        want = cf.stage_group_plain(x.clone(), mtile, minst, lanes, **kw)
        cf.stage_group(x, mtile, minst, lanes, chunk32=not high_planes, **kw)
        torch.cuda.synchronize()
        assert torch.equal(x, want)
    assert cf.stage_group.route_launches[route] == before + len(plan)


def test_stage_group_chunk32_refuses_a_tile_beyond_shared_memory(dev):
    k = (cf.CHUNK32_SMEM_LIMIT // (cf.SUB_PLANES * 4)).bit_length()
    mtile, minst, _ = random_group_tables(np.random.default_rng(9), k, False,
                                          cf.SUB_PLANES, dev)
    x = _rand(10, (1, 1 << k, 128), dev)
    with pytest.raises(ValueError, match="CHUNK32"):
        cf.stage_group(x, mtile, minst, None, t0=0, k=k, include_low=False,
                       chunk32=True)


@pytest.mark.parametrize("log_h,log_rate", [(6, 0), (12, 0), (10, 2),
                                            (16, 0), (12, 4)])
def test_ntt128_golden_on_card(dev, log_h, log_rate):
    ntt = AdditiveNTT128(log_h, log_rate, device=dev)
    out = ntt.apply(_words(log_h, log_rate))
    assert out.device.type == "cuda"
    digest = hashlib.md5(to_numpy(out).astype("<u4").tobytes()).hexdigest()
    assert digest == ADDITIVE_NTT128_HASHES[log_rate][log_h]


def test_apply_sliced_rejects_a_tensor_on_another_device(dev):
    ntt = AdditiveNTT128(8, 0, device=dev)
    with pytest.raises(ValueError, match="apply_sliced"):
        ntt.apply_sliced(torch.zeros(8, 128, dtype=torch.int32))


def _sumcheck_state(num_vars, comp, device):
    words = mt19937_stream(700 + num_vars + comp,
                           4 * (1 << num_vars) * comp)
    return bitslice_transpose(to_torch(words, device).view(comp, -1, 128))


CHALLENGE = [0xFFFFFFFF, 0x80000000, 0x12345678, 7]


@pytest.mark.parametrize("comp", [2, 3, 4, cr.MAX_COMPOSITION])
def test_sumcheck_kernels_match_plain(dev, comp):
    x = _sumcheck_state(12, comp, dev)                 # B = 128 batches
    b = x.shape[1]
    for rows in (2, 4, b // 2, b):
        before = (cr.round_kernel.launches, cr.fold_kernel.launches)
        got = cr.round_kernel(x, rows, comp + 1)
        folded = cr.fold_kernel(x.clone(), CHALLENGE, rows)
        torch.cuda.synchronize()
        assert (cr.round_kernel.launches, cr.fold_kernel.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(got, cr.round_plain(x, rows, comp + 1))
        assert torch.equal(folded, cr.fold_plain(x.clone(), CHALLENGE, rows))
    for lanes in (32, 16, 2, 1):                       # in-word rounds
        got = cr.round_kernel(x, 1, comp + 1, lanes)
        assert torch.equal(got, cr.round_plain(x, 1, comp + 1, lanes))
        if lanes >= 2:
            folded = cr.fold_kernel(x.clone(), CHALLENGE, 1, lanes)
            assert torch.equal(
                folded, cr.fold_plain(x.clone(), CHALLENGE, 1, lanes))


@pytest.mark.parametrize("comp", [2, 3, cr.MAX_COMPOSITION])
@pytest.mark.parametrize("rows", [70, 66, 126])
def test_round_kernel_with_idle_lanes(dev, comp, rows):
    """A live half that is not a multiple of 32: the last group of 32 row
    pairs runs with idle lanes, which must add nothing."""
    x = _rand(30 + comp, (comp, 128, 128), dev)
    got = cr.round_kernel(x, rows, comp + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, cr.round_plain(x, rows, comp + 1))


@pytest.mark.parametrize("comp", [2, cr.MAX_COMPOSITION])
def test_round_kernel_grid_stride(dev, comp):
    """2^24 evaluations less one row pair: every warp runs many units of
    the grid-stride loop, and the last group has an idle lane."""
    b = (1 << 24) // 32
    x = _rand(40 + comp, (comp, b, 128), dev)
    got = cr.round_kernel(x, b - 2, comp + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, cr.round_plain(x, b - 2, comp + 1))


@pytest.mark.parametrize("comp", [1, 2, cr.MAX_COMPOSITION])
def test_fold_kernel_with_idle_threads(dev, comp):
    """rows = 70: 35 row pairs a column, so the fold's 64-thread blocks run
    with idle threads, which must write nothing."""
    x = _rand(50 + comp, (comp, 128, 128), dev)
    got = cr.fold_kernel(x.clone(), CHALLENGE, 70)
    torch.cuda.synchronize()
    assert torch.equal(got, cr.fold_plain(x.clone(), CHALLENGE, 70))


@pytest.mark.parametrize("cut", [0, 2])
@pytest.mark.parametrize("comp", [1, 4])
def test_fold_kernel_with_more_blocks_than_the_card_holds(dev, comp, cut):
    """2^22 evaluations: 2^16 row pairs a column, thousands of blocks more
    than the card runs at once (and at b - 2 rows a last block part idle)."""
    b = (1 << 22) // 32
    x = _rand(60 + comp, (comp, b, 128), dev)
    got = cr.fold_kernel(x.clone(), CHALLENGE, b - cut)
    torch.cuda.synchronize()
    assert torch.equal(got, cr.fold_plain(x.clone(), CHALLENGE, b - cut))


@pytest.mark.parametrize("rows,lanes", [(128, 32), (70, 32), (1, 32),
                                        (1, 2)])
def test_fold_kernel_at_challenges_zero_and_one(dev, rows, lanes):
    """w = 0 leaves every row as it is; w = 1 makes lo the upper operand
    (in-word: lo >> lanes/2, on every lane)."""
    x = _rand(70 + rows + lanes, (3, 128, 128), dev)
    n = max(rows // 2, 1)
    up = lsr(x[:, :1], lanes // 2) if rows == 1 else x[:, n:rows]
    assert torch.equal(cr.fold_kernel(x.clone(), [0, 0, 0, 0], rows, lanes),
                       x)
    got = cr.fold_kernel(x.clone(), [1, 0, 0, 0], rows, lanes)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :n], up)
    assert torch.equal(got[:, n:], x[:, n:])


def test_sumcheck_kernels_refuse_what_they_do_not_take(dev):
    x = _sumcheck_state(8, 2, dev)                     # (2, 8, 128)
    with pytest.raises(ValueError, match="contiguous"):
        cr.round_kernel(x[:, ::2], 4, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cr.fold_kernel(x[:, ::2], CHALLENGE, 4)
    with pytest.raises(ValueError, match="int32"):
        cr.round_kernel(x.long(), 8, 3)
    with pytest.raises(ValueError, match="int32"):
        cr.fold_kernel(x.long(), CHALLENGE, 8)
    with pytest.raises(ValueError, match="host words"):
        cr.fold_kernel(x, to_torch(np.array(CHALLENGE, np.uint32), dev), 8)
    with pytest.raises(ValueError, match="num_points"):
        cr.round_kernel(x, 8, 4)
    with pytest.raises(ValueError, match="lanes"):
        cr.round_kernel(x, 1, 3, 3)
    with pytest.raises(ValueError, match="lanes"):
        cr.fold_kernel(x, CHALLENGE, 8, 16)
    with pytest.raises(ValueError, match="device"):
        Sumcheck(x, 2, 8, data_is_transposed=True, device="cpu")


@pytest.mark.parametrize("comp,transposed", [(2, False), (3, True)])
def test_sumcheck_protocol_on_card(dev, comp, transposed):
    num_vars = 8
    n = 4 * (1 << num_vars) * comp
    vals = mt19937_stream(1000 + comp, n + 4 * num_vars)
    evals, challenges = vals[:n], vals[n:].reshape(num_vars, 4)
    given = (to_numpy(bitslice_transpose(to_torch(evals).view(-1, 128)))
             if transposed else evals)
    before = (cr.round_kernel.launches, cr.fold_kernel.launches)
    s = Sumcheck(given, comp, num_vars, data_is_transposed=transposed,
                 device=dev)
    messages = transcript(s, challenges)
    # every round on the card, the in-word ones too, and the final sum
    assert (cr.round_kernel.launches, cr.fold_kernel.launches) == (
        before[0] + num_vars + 1, before[1] + num_vars)
    claim = V.check_transcript(messages, challenges, comp + 1)
    per_col = (1 << num_vars) * 4
    cols = [[V.words_to_int(w) for w in
             evals[c * per_col:(c + 1) * per_col].reshape(-1, 4)]
            for c in range(comp)]
    assert V.evaluate_multilinear_composition(
        cols, [V.words_to_int(ch) for ch in challenges]) == claim


@pytest.mark.parametrize("comp", [2, 3, 4])
def test_sumcheck_golden_transcripts_on_card(dev, comp):
    words, challenges = protocol_inputs(20, comp, mt19937_stream)
    messages = transcript(Sumcheck(words, comp, 20, device=dev), challenges)
    V.check_transcript(messages, challenges, comp + 1)
    assert transcript_md5(messages) == SUMCHECK_TRANSCRIPT_MD5[20][comp]


def _md5(t) -> str:
    return hashlib.md5(to_numpy(t).astype("<u4").tobytes()).hexdigest()


@pytest.mark.parametrize("rows", [1, 3, 5, (1 << 12) + 1, 1 << 17])
def test_bitslice_lane_groups_kernel_matches_plain(dev, rows):
    x = _rand(4, (rows, 128), dev)
    before = cf32.bitslice_lane_groups.launches
    got = cf32.bitslice_lane_groups(x)
    torch.cuda.synchronize()
    assert cf32.bitslice_lane_groups.launches == before + 1
    assert torch.equal(got, cf32.bitslice_lane_groups_plain(x))
    assert torch.equal(cf32.bitslice_lane_groups(got), x)


@pytest.mark.parametrize("log_h,log_rate,kb,ku", [
    (7, 0, 2, 2), (7, 2, 2, 2), (11, 4, 2, 2), (13, 2, 2, 2), (12, 1, 3, 1),
    (16, 2, None, None), (15, 4, None, None),
])
def test_stage_group32_kernel_matches_plain(dev, log_h, log_rate, kb, ku,
                                            monkeypatch):
    if kb is not None:                  # else the production plan
        monkeypatch.setattr(cf32, "KB", kb)
        monkeypatch.setattr(cf32, "KU", ku)
    _stage_group32_groups_match_plain(dev, log_h, log_rate)


@pytest.mark.parametrize("log_h,log_rate", [(16, 2), (24, 0)])
@pytest.mark.parametrize("kb,ku", cf32.SWEPT_PLANS)
def test_stage_group32_kernel_under_each_swept_plan(dev, kb, ku, log_h,
                                                    log_rate, monkeypatch):
    """At 2^24 the plans reach the largest tiles: an upper group of 2^10
    rows (128 KB a lane group) and a bottom group of 2^8 (128 KB)."""
    monkeypatch.setattr(cf32, "KB", kb)
    monkeypatch.setattr(cf32, "KU", ku)
    _stage_group32_groups_match_plain(dev, log_h, log_rate)


@pytest.mark.parametrize("log_h,log_rate,kb,ku,groups", [
    (12, 2, 8, 9, [(0, 5, True)]),                  # bottom only
    (13, 0, 8, 9, [(0, 6, True)]),
    (16, 0, 8, 9, [(8, 1, False), (0, 8, True)]),   # an upper group of k = 1
    (10, 2, 1, 1, [(2, 1, False), (1, 1, False), (0, 1, True)]),
    (9, 0, 0, 2, [(0, 2, False), (0, 0, True)]),    # a bottom group of one row
])
def test_stage_group32_kernel_on_edge_plans(dev, log_h, log_rate, kb, ku,
                                            groups, monkeypatch):
    monkeypatch.setattr(cf32, "KB", kb)
    monkeypatch.setattr(cf32, "KU", ku)
    got = _stage_group32_groups_match_plain(dev, log_h, log_rate)
    assert got == groups


@pytest.mark.parametrize("kb,ku,log_h", [(0, 11, 18), (9, 9, 16)])
def test_stage_group32_refuses_a_tile_beyond_shared_memory(dev, kb, ku, log_h,
                                                         monkeypatch):
    """A group whose tile exceeds the card's shared memory (an upper group
    of 2^11 rows, 256 KB a lane group; a bottom group of 2^9 rows, 256 KB)
    is refused by the wrapper and by the C entry point, and not
    launched."""
    monkeypatch.setattr(cf32, "KB", kb)
    monkeypatch.setattr(cf32, "KU", ku)
    rows = precompute_subspace_evals(log_h, 0, 5)
    tables = cf32.build_tables32(rows, log_h, 0, dev)
    t0, k, low, tabs = next(g for g in tables
                            if cf32.tile_bytes32(g[1], g[2])
                            > cf32.SMEM_LIMIT)
    x = _rand(11, (1, 1 << (log_h - 7), 128), dev)
    before, x_before = cf32.stage_group32.launches, x.clone()
    with pytest.raises(ValueError, match="shared memory"):
        cf32.stage_group32(x, tabs, t0=t0, k=k, include_low=low, cosets=1,
                           log_nbr=log_h - 7)
    n_inst, post = cf32._group_geometry32(x, tabs, t0, k, low, 1, log_h - 7)
    low_ptrs = [tabs[n].data_ptr() if low else None
                for n in ("mlo_t", "mlo_i", "cpl", "lpl")]
    rc = _build.library().bntt_stage_group32(
        x.data_ptr(), tabs["mtile"].data_ptr(), tabs["minst"].data_ptr(),
        *low_ptrs, n_inst, k, post, 1, int(low), 0,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 1                      # cudaErrorInvalidValue
    assert cf32.stage_group32.launches == before
    assert torch.equal(x, x_before)


def _stage_group32_groups_match_plain(dev, log_h, log_rate):
    """stage_group32 == stage_group32_plain at every group of the current
    plan on the upstream input, the chained output held to the golden
    digest where the table has one; returns the plan's groups."""
    rows = precompute_subspace_evals(log_h, log_rate, 5)
    tables = cf32.build_tables32(rows, log_h, log_rate, dev)
    cosets = 1 << log_rate
    words = mt19937_stream(0xDEADBEEF + log_h + log_rate, 1 << log_h)
    packed = cf32.bitslice_lane_groups(to_torch(words, dev).view(-1, 128))
    x = packed.repeat(cosets, 1).view(cosets, -1, 128)
    before = cf32.stage_group32.launches
    for (t0, k, low, tabs) in tables:
        kw = dict(t0=t0, k=k, include_low=low, cosets=cosets,
                  log_nbr=log_h - 7)
        want = cf32.stage_group32_plain(x.clone(), tabs, **kw)
        assert cf32.stage_group32(x, tabs, **kw) is x
        torch.cuda.synchronize()
        assert torch.equal(x, want)
    assert cf32.stage_group32.launches == before + len(tables)
    if log_rate in ADDITIVE_NTT_HASHES:         # no upstream rate-4 table
        out = cf32.bitslice_lane_groups(x.view(-1, 128)).reshape(-1)
        assert _md5(out) == ADDITIVE_NTT_HASHES[log_rate][log_h]
    return [(t0, k, low) for (t0, k, low, _) in tables]


@pytest.mark.parametrize("log_h,log_rate", [(7, 0), (12, 0), (10, 2),
                                            (16, 2), (20, 0)])
def test_ntt32_golden_on_card(dev, log_h, log_rate):
    ntt = AdditiveNTT(log_h, log_rate, device=dev)
    before = (cf32.bitslice_lane_groups.launches,
              cf32.stage_group32.launches)
    out = ntt.apply(mt19937_stream(0xDEADBEEF + log_h + log_rate,
                                   1 << log_h))
    assert out.device.type == "cuda"
    assert _md5(out) == ADDITIVE_NTT_HASHES[log_rate][log_h]
    assert (cf32.bitslice_lane_groups.launches,
            cf32.stage_group32.launches) == (before[0] + 2,
                                             before[1] + len(ntt.tables))


def test_ntt32_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rows = precompute_subspace_evals(9, 0, 5)
    (t0, k, low, tabs), = cf32.build_tables32(rows, 9, 0, dev)
    kw = dict(t0=t0, k=k, include_low=low, cosets=1, log_nbr=2)
    x = _rand(5, (1, 4, 128), dev)
    with pytest.raises(ValueError, match="contiguous"):
        cf32.stage_group32(_rand(5, (1, 4, 256), dev)[:, :, ::2], tabs, **kw)
    with pytest.raises(ValueError, match="int32"):
        cf32.stage_group32(x.long(), tabs, **kw)
    with pytest.raises(ValueError, match="mtile"):
        cf32.stage_group32(x, dict(tabs, mtile=tabs["mtile"].cpu()), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cf32.bitslice_lane_groups(x.view(4, 128)[::2])
    with pytest.raises(ValueError, match="int32"):
        cf32.bitslice_lane_groups(x.view(4, 128).long())
    with pytest.raises(ValueError, match="expected"):
        cf32.bitslice_lane_groups(x.view(8, 64))
    ntt = AdditiveNTT(9, 0, device=dev)
    with pytest.raises(ValueError, match="int32 words on"):
        ntt.apply(torch.zeros(512, dtype=torch.int32))


@pytest.mark.parametrize("log_n,kb,ku", [
    (7, None, None), (11, None, None), (16, None, None), (7, 2, 2),
    (11, 3, 5), (16, 5, 3),
    # tiles above 48 KB of shared memory, up to the largest (2^15 words);
    # upper tiles of one-word rows, loaded word by word
    (16, 14, 2), (17, 15, 2), (18, 13, 11), (20, 12, 12), (19, 9, 5),
    (22, 12, 6), (9, 1, 3), (13, 1, 12),
])
def test_stage_group_r2_kernel_matches_plain(dev, log_n, kb, ku,
                                             monkeypatch):
    if kb is not None:                  # else the production plan
        monkeypatch.setattr(cfb, "KB", kb)
        monkeypatch.setattr(cfb, "KU", ku)
    ntt = NTTRadix2(137, 27, log_n, device=dev)
    x = to_torch(mt19937_stream(0xDEADBEEF + log_n, 1 << log_n), dev)
    plan = cfb.plan_groups_r2(log_n)
    got, want = torch.empty_like(x), torch.empty_like(x)
    before = cfb.stage_group_r2.launches
    for gi, (s0, k) in enumerate(plan):
        kw = dict(s0=s0, k=k, log_n=log_n, encode_in=gi == 0,
                  decode_out=gi == len(plan) - 1,
                  src=x if gi == 0 else None)
        assert cfb.stage_group_r2(got, ntt.tw, **kw) is got
        cfb.stage_group_r2_plain(want, ntt.tw, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert cfb.stage_group_r2.launches == before + len(plan)
    assert _md5(got) == BB31_NTT_HASHES[log_n]


@pytest.mark.parametrize("log_n", [7, 20])
def test_bb31_golden_on_card(dev, log_n):
    ntt = NTTRadix2(137, 27, log_n, device=dev)
    before = cfb.stage_group_r2.launches
    out = ntt.apply(mt19937_stream(0xDEADBEEF + log_n, 1 << log_n))
    assert out.device.type == "cuda"
    assert _md5(out) == BB31_NTT_HASHES[log_n]
    assert cfb.stage_group_r2.launches == before + len(
        cfb.plan_groups_r2(log_n))


@pytest.mark.parametrize("log_n", range(1, 7))
@pytest.mark.parametrize("use_fused", [None, False])
def test_bb31_small_sizes_launch_the_kernel(dev, log_n, use_fused):
    """Below the reference's fused gate (log_n 7) the card still runs the
    kernel: one group (0, log_n), whose top stage skips the multiply;
    use_fused=False chooses between plain paths on the CPU only."""
    ntt = NTTRadix2(137, 27, log_n, use_fused=use_fused, device=dev)
    assert ntt.use_fused
    x = mt19937_stream(0xDEADBEEF + log_n, 1 << log_n)
    before = cfb.stage_group_r2.launches
    out = ntt.apply(x)
    torch.cuda.synchronize()
    assert cfb.stage_group_r2.launches == before + 1
    assert _md5(out) == BB31_NTT_HASHES[log_n]
    want = cfb.stage_group_r2_plain(
        torch.empty_like(out), ntt.tw, s0=0, k=log_n, log_n=log_n,
        encode_in=True, decode_out=True, src=to_torch(x, dev))
    assert torch.equal(out, want)


def test_bb31_wrapper_refuses_what_the_kernel_does_not_take(dev):
    log_n = cfb.TILE_LOG + 1
    ntt = NTTRadix2(137, 27, log_n, device=dev)
    x = _rand(6, (1 << log_n,), dev)
    with pytest.raises(ValueError, match="at most"):
        cfb.stage_group_r2(x, ntt.tw, s0=0, k=cfb.TILE_LOG + 1, log_n=log_n)
    with pytest.raises(ValueError, match="tw"):
        cfb.stage_group_r2(x, ntt.tw.cpu(), s0=0, k=12, log_n=log_n)
    with pytest.raises(ValueError, match="out of place"):
        cfb.stage_group_r2(x, ntt.tw, s0=0, k=12, log_n=log_n, src=x)
    with pytest.raises(ValueError, match="16-byte"):
        cfb.stage_group_r2(_rand(6, (1 + (1 << log_n),), dev)[1:], ntt.tw,
                           s0=0, k=12, log_n=log_n)
    with pytest.raises(ValueError, match="int32 words on"):
        ntt.apply(torch.zeros(1 << log_n, dtype=torch.int32))


@pytest.mark.parametrize("s0", [0, 1])
def test_stage_group_r2_takes_tile_log_stages(dev, s0):
    """The largest group the kernel takes: TILE_LOG stages in one tile of
    2^TILE_LOG words (192 KB of shared memory with its twiddles), as the
    first group and above one stage."""
    log_n = cfb.TILE_LOG + s0
    ntt = NTTRadix2(137, 27, log_n, device=dev)
    rng = np.random.default_rng(7)      # Montgomery words: canonical
    x = to_torch(rng.integers(0, bb.P, 1 << log_n, dtype=np.uint32), dev)
    got, want = x.clone(), x.clone()
    cfb.stage_group_r2(got, ntt.tw, s0=s0, k=cfb.TILE_LOG, log_n=log_n)
    cfb.stage_group_r2_plain(want, ntt.tw, s0=s0, k=cfb.TILE_LOG,
                             log_n=log_n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [2, 4, 1 << 12, 1 << 16])
def test_prime_kernels_match_plain(dev, rows):
    rng = np.random.default_rng(rows)
    p = prime_golden.P
    evals = to_torch(rng.integers(0, p, (2, rows, 4), dtype=np.uint32), dev)
    ch = rng.integers(0, p, 4, dtype=np.uint32)
    before = (cpr.round_kernel.launches, cpr.fold_kernel.launches)
    got = cpr.round_kernel(evals, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, cpr.round_plain(evals, rows))
    folded = cpr.fold_kernel(evals.clone(), ch, rows)
    torch.cuda.synchronize()
    assert torch.equal(folded, cpr.fold_plain(evals.clone(), ch, rows))
    assert (cpr.round_kernel.launches, cpr.fold_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    # a partial live count in the full buffer
    if rows >= 8:
        assert torch.equal(cpr.round_kernel(evals, rows // 4),
                           cpr.round_plain(evals, rows // 4))


def test_prime_golden_transcript_on_card(dev):
    evals, challenges = prime_golden.protocol_inputs(20, mt19937_stream)
    before = (cpr.round_kernel.launches, cpr.fold_kernel.launches)
    messages = prime_golden.transcript(PrimeFieldSumcheck(evals, device=dev),
                                       challenges)
    assert (cpr.round_kernel.launches, cpr.fold_kernel.launches) == (
        before[0] + 20, before[1] + 20)
    check_transcript(messages[:-1], challenges, messages[-1])
    assert (prime_golden.transcript_md5(messages)
            == prime_golden.PRIME_TRANSCRIPT_MD5[20])


@pytest.mark.parametrize("log_h,log_rate", [(5, 4), (9, 2), (12, 1)])
def test_butterfly_kernels_match_plain(dev, log_h, log_rate):
    """Every stage of a per-stage transform: kernel vs plain, word-equal
    after each stage, then the chained output against the digest."""
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device=dev)
    data = bitslice_transpose(to_torch(_words(log_h, log_rate),
                                       dev).view(-1, 128))
    x = data.repeat(1 << log_rate, 1)
    before = (ck.butterfly_high.launches, ck.butterfly_low.launches)
    for _, kernel, plain, args in ntt.stage_steps():
        want = plain(x.clone(), *args)
        assert kernel(x, *args) is x
        torch.cuda.synchronize()
        assert torch.equal(x, want)
    assert (ck.butterfly_high.launches, ck.butterfly_low.launches) == (
        before[0] + log_h - 5, before[1] + 5)
    digest = ADDITIVE_NTT128_HASHES[log_rate].get(log_h)
    if digest is not None:
        assert _md5(bitslice_untranspose(x).reshape(-1)) == digest


def test_butterfly_high_on_random_rows(dev):
    """Many blocks and a pair distance of 4 rows, on random words."""
    x = _rand(7, (64, 128), dev)
    w4 = _rand(8, (8, 4), dev)
    want = ck.butterfly_high_plain(x.clone(), w4)
    ck.butterfly_high(x, w4)
    torch.cuda.synchronize()
    assert torch.equal(x, want)


def _high_table(seed, blocks, subfield, device):
    """A random high-stage table (blocks, 4); with ``subfield`` only word
    0 is set (GF(2^32) twiddles, the CHUNK32 route)."""
    w4 = np.random.default_rng(seed).integers(0, 1 << 32, (blocks, 4),
                                              dtype=np.uint32)
    if subfield:
        w4[:, 1:] = 0
    return to_torch(w4, device)


@pytest.mark.parametrize("chunk32", [True, False])
@pytest.mark.parametrize("rows,db", [(2, 1), (6, 1), (48, 8), (32, 16),
                                     (64, 32), (4096, 1024), (65536, 2)])
def test_butterfly_high_routes_on_random_rows(dev, rows, db, chunk32):
    """Each route on random rows and tables: a partial tile (2, 6 and 48
    rows), several blocks a tile (db < 16), one block over several tiles
    (db >= 16), and more tiles than the card holds blocks at once."""
    w4 = _high_table(400 + rows + db, rows // (2 * db), chunk32, dev)
    assert ck.high_subfield(w4) == chunk32
    x = _rand(500 + rows + db, (rows, 128), dev)
    want = ck.butterfly_high_plain(x.clone(), w4)
    route = "chunk32" if chunk32 else "general"
    before = dict(ck.butterfly_high.route_launches)
    assert ck.butterfly_high(x, w4, chunk32) is x
    torch.cuda.synchronize()
    assert torch.equal(x, want)
    before[route] += 1
    assert ck.butterfly_high.route_launches == before


@pytest.mark.parametrize("chunk32", [True, False])
def test_butterfly_high_routes_on_real_tables(dev, chunk32):
    """Both routes on the tables of a real transform, random rows."""
    ntt = AdditiveNTT128(12, 1, use_fused=False, device=dev)
    assert ntt.chunk32 == {s: True for s in range(12)}
    high, _, _ = ntt.stage_tables
    for s in range(5, 12):
        x = _rand(600 + s, (2 * (1 << 12) // 32, 128), dev)
        want = ck.butterfly_high_plain(x.clone(), high[s])
        ck.butterfly_high(x, high[s], chunk32)
        torch.cuda.synchronize()
        assert torch.equal(x, want)


@pytest.mark.parametrize("chunk32", [True, False])
def test_butterfly_high_refuses_bad_calls_on_both_routes(dev, chunk32):
    x = _rand(9, (8, 128), dev)
    before = dict(ck.butterfly_high.route_launches)
    with pytest.raises(ValueError, match="blocks"):
        ck.butterfly_high(x, _rand(10, (3, 4), dev), chunk32)
    with pytest.raises(ValueError, match="aligned"):
        ck.butterfly_high(x, _rand(10, (9, 4), dev).view(-1)[1:9].view(2, 4),
                          chunk32)
    assert ck.butterfly_high.route_launches == before


def _low_tables(seed, rows, subfield, device):
    """Random low-stage tables: a4 (rows, 4) and lane planes (128,); with
    ``subfield`` only a4 word 0 and lane planes 0..31 are set (GF(2^32)
    twiddles, the CHUNK32 route), else every plane is random."""
    rng = np.random.default_rng(seed)
    a4 = rng.integers(0, 1 << 32, (rows, 4), dtype=np.uint32)
    lanes = rng.integers(0, 1 << 32, 128, dtype=np.uint32)
    if subfield:
        a4[:, 1:] = 0
        lanes[32:] = 0
    return to_torch(a4, device), to_torch(lanes, device)


@pytest.mark.parametrize("chunk32", [True, False])
@pytest.mark.parametrize("rows", [1, 2, 3, 6000])
@pytest.mark.parametrize("stage", range(5))
def test_butterfly_low_on_random_rows(dev, stage, rows, chunk32):
    """Each route on random rows and tables: one row (no partner), one
    pair, an odd count, and a grid of many blocks."""
    a4, lanes = _low_tables(100 + stage, rows, chunk32, dev)
    assert ck.low_subfield(a4, lanes) == chunk32
    x = _rand(200 + rows + stage, (rows, 128), dev)
    want = ck.butterfly_low_plain(x.clone(), a4, lanes, stage)
    route = "chunk32" if chunk32 else "general"
    before = ck.butterfly_low.route_launches[route]
    assert ck.butterfly_low(x, a4, lanes, stage, chunk32) is x
    torch.cuda.synchronize()
    assert torch.equal(x, want)
    assert ck.butterfly_low.route_launches[route] == before + 1


@pytest.mark.parametrize("chunk32", [True, False])
def test_butterfly_low_routes_on_real_tables(dev, chunk32):
    """Both routes on the tables of a real transform, random rows."""
    ntt = AdditiveNTT128(12, 1, use_fused=False, device=dev)
    assert ntt.chunk32 == {s: True for s in range(12)}
    _, low_batch, low_lanes = ntt.stage_tables
    for s in range(5):
        x = _rand(300 + s, (low_batch[s].shape[0], 128), dev)
        want = ck.butterfly_low_plain(x.clone(), low_batch[s], low_lanes[s],
                                      s)
        ck.butterfly_low(x, low_batch[s], low_lanes[s], s, chunk32)
        torch.cuda.synchronize()
        assert torch.equal(x, want)


@pytest.mark.parametrize("log_h,log_rate", [
    (5, 0), (5, 1), (5, 2), (5, 3), (5, 4), (12, 2)])
def test_per_stage_path_on_card(dev, log_h, log_rate):
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=None if log_h == 5
                         else False, device=dev)
    assert not ntt.use_fused
    before = (ck.butterfly_high.launches, ck.butterfly_low.launches,
              cf.stage_group.launches)
    words = _words(log_h, log_rate)
    out = ntt.apply(words)
    torch.cuda.synchronize()
    assert (ck.butterfly_high.launches, ck.butterfly_low.launches,
            cf.stage_group.launches) == (before[0] + log_h - 5,
                                         before[1] + 5, before[2])
    digest = ADDITIVE_NTT128_HASHES[log_rate].get(log_h)
    if digest is not None:
        assert _md5(out) == digest
    # the plain per-stage path on the CPU gives the same words
    cpu = AdditiveNTT128(log_h, log_rate, use_fused=False, device="cpu")
    assert torch.equal(out.cpu(), cpu.apply(words))


def test_butterfly_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = _rand(9, (8, 128), dev)
    w4 = _rand(10, (2, 4), dev)
    with pytest.raises(ValueError, match="w4"):
        ck.butterfly_high(x, w4.cpu())
    with pytest.raises(ValueError, match="aligned"):
        ck.butterfly_high(x, _rand(10, (9, 4), dev).view(-1)[1:9].view(2, 4))
    with pytest.raises(ValueError, match="blocks"):
        ck.butterfly_high(x, _rand(10, (3, 4), dev))
    with pytest.raises(ValueError, match="contiguous"):
        ck.butterfly_low(_rand(9, (8, 256), dev)[:, ::2], w4, w4[0], 0)


@pytest.mark.parametrize("height", [5, 6, 7])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 1 << 16, (1 << 20) + 7])
def test_mul_compact_tiles_kernel_matches_plain(dev, height, n):
    nl = 1 << (height - 5)
    a, b = _rand(11, (n, nl), dev), _rand(12, (n, nl), dev)
    before = tower_compact.mul_compact_tiles.launches
    got = tower_compact.mul_compact_tiles(a, b, height)
    torch.cuda.synchronize()
    assert tower_compact.mul_compact_tiles.launches == before + 1
    assert torch.equal(got, tower_compact.mul_compact(a, b, height))
    ga, gb, gz = (to_numpy(t[:16]) for t in (a, b, got))
    for i in range(min(n, 16)):
        ai, bi, zi = (int.from_bytes(w[i].astype("<u4").tobytes(), "little")
                      for w in (ga, gb, gz))
        assert zi == tower_scalar.multiply(ai, bi, height)


def test_kernels_take_views_that_do_not_start_on_16_bytes(dev):
    """Both kernels move 16-byte vectors; their wrappers copy a view that
    starts between (at a whole word, or at a whole element)."""
    flat = _rand(14, (1 + 3 * 128,), dev)
    rows = flat[1:].view(3, 128)
    assert torch.equal(cf32.bitslice_lane_groups(rows),
                       cf32.bitslice_lane_groups_plain(rows))
    for height in (5, 6):
        nl = 1 << (height - 5)
        a, b = _rand(15, (66, nl), dev), _rand(16, (66, nl), dev)
        got = tower_compact.mul_compact_tiles(a[1:], b[1:], height)
        assert torch.equal(got, tower_compact.mul_compact(a[1:], b[1:],
                                                          height))


def test_mul_compact_tiles_refuses_what_the_kernel_does_not_take(dev):
    a = _rand(13, (64, 4), dev)
    with pytest.raises(ValueError, match="aligned"):
        tower_compact.mul_compact_tiles(a.view(-1)[2:-2].view(-1, 4),
                                        a[1:], 7)
    with pytest.raises(ValueError, match="on"):
        tower_compact.mul_compact_tiles(a, a.cpu(), 7)


def test_entry_points_default_to_cuda0(dev):
    expect = torch.device("cuda", 0)
    assert AdditiveNTT128(6, 0).device == expect
    assert AdditiveNTT128(5, 0).device == expect
    assert AdditiveNTT(8, 0).device == expect
    assert NTTRadix2(137, 27, 8).device == expect
    assert PrimeFieldSumcheck(np.zeros((2, 8, 4), np.uint32)).device == expect
    s = Sumcheck(np.zeros(4 * 64 * 2, np.uint32), 2, 6)
    assert s._evals.device == expect
    assert PrimeFieldSumcheck.from_state_dict(
        {"round": 1, "evals": np.zeros((2, 4, 4), np.uint32)}).device == \
        expect


# ---- the sharded paths (binius_ntt_tpu_torch/parallel/) ----


@pytest.mark.parametrize("log_h,log_rate,log_d", [(12, 0, 3), (13, 2, 3),
                                                  (16, 0, 2)])
def test_stage_group_kernel_with_dplanes_matches_plain(dev, log_h, log_rate,
                                                       log_d, monkeypatch):
    """Every group of a forced local plan with every shard's dplanes, the
    tables' zero flags passed on: at rate 0 the top local stage's twiddle
    is the device bits' alone, live on every shard but 0."""
    monkeypatch.setattr(cf, "KB", 2)
    monkeypatch.setattr(cf, "KU", 2)
    monkeypatch.setattr(cf, "PT", 2)
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    tables = cf.build_tables_sharded(rows, log_h, log_rate, log_d, dev)
    nb_l = (1 << log_h) // 32 >> log_d
    before = cf.stage_group.dplanes_launches
    for g, (t0, k, low, mtile, minst, lanes, zero, chunk32,
            dtab) in enumerate(tables):
        assert chunk32
        kw = dict(t0=t0, k=k, include_low=low, zero_flags=zero)
        for d in range(1 << log_d):
            x = _rand(30 + 8 * g + d, (1 << log_rate, nb_l, 128), dev)
            dpl = shard_dplanes(dtab, d)
            want = cf.stage_group_plain(x.clone(), mtile, minst, lanes,
                                        dplanes=dpl, **kw)
            cf.stage_group(x, mtile, minst, lanes, chunk32=chunk32,
                           dplanes=dpl, **kw)
            torch.cuda.synchronize()
            assert torch.equal(x, want), (t0, k, d)
    assert cf.stage_group.dplanes_launches == before + (len(tables) << log_d)


@pytest.mark.parametrize("high_planes", [True, False])
def test_stage_group_kernel_with_random_dplanes(dev, high_planes,
                                                monkeypatch):
    """Both routes on random tables and random corrections through a whole
    forced plan of a shard, D = 8: the general route with planes >= 32 set
    in every table, CHUNK32 on GF(2^32) ones."""
    monkeypatch.setattr(cf, "KB", 2)
    monkeypatch.setattr(cf, "KU", 2)
    monkeypatch.setattr(cf, "PT", 2)
    width = 128 if high_planes else cf.SUB_PLANES
    rng = np.random.default_rng(7 + width)
    log_h, log_d = 12, 3
    plan = list(reversed(cf.plan_groups(log_h - 5 - log_d)))
    for d in range(1 << log_d):
        x = _rand(60 + d, (2, (1 << log_h) // 32 >> log_d, 128), dev)
        for t0, k, low in plan:
            mtile, minst, lanes = random_group_tables(rng, k, low, width,
                                                      dev)
            dpl = np.zeros((k + 5 * low, 128), np.uint32)
            dpl[:, :width] = rng.integers(0, 1 << 32, (k + 5 * low, width),
                                          dtype=np.uint32)
            dpl = to_torch(dpl, dev)
            kw = dict(t0=t0, k=k, include_low=low)
            want = cf.stage_group_plain(x.clone(), mtile, minst, lanes,
                                        dplanes=dpl, **kw)
            cf.stage_group(x, mtile, minst, lanes, chunk32=not high_planes,
                           dplanes=dpl, **kw)
            torch.cuda.synchronize()
            assert torch.equal(x, want), (t0, k, d)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("log_h,log_rate", [(12, 0), (13, 2)])
def test_sharded_ntt128_on_card(dev, log_h, log_rate, fused):
    """LocalMesh(4) on the card against the single-device transform, every
    product a mul_tiles launch and every local group a stage_group launch
    with dplanes."""
    sliced = bitslice_transpose(to_torch(_words(log_h, log_rate),
                                         dev).view(-1, 128))
    want = AdditiveNTT128(log_h, log_rate, device=dev).apply_sliced(sliced)
    ntt = ShardedAdditiveNTT128(log_h, log_rate, make_mesh(4, dev),
                                use_fused=fused)
    mul0, sg0 = ck.mul_tiles.launches, cf.stage_group.dplanes_launches
    got = ntt.apply_sliced(sliced)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and torch.equal(got, want)
    assert ck.mul_tiles.launches > mul0
    assert (cf.stage_group.dplanes_launches > sg0) == fused


@pytest.mark.parametrize("w", [32, 128])
@pytest.mark.parametrize("rows,chunk_rows", [(96, 32), (1 << 16, 1 << 12),
                                             (64, 1 << 18)])
def test_streamed_transforms_on_card(dev, w, rows, chunk_rows):
    """Each streamed transform, chunk by chunk through the card, equals the
    whole-array transform."""
    rng = np.random.default_rng(rows + w)
    host = rng.integers(0, 1 << 32, (rows, w), dtype=np.uint32)
    whole = bitslice_transpose(to_torch(host, dev))
    got = bitslice_transpose_streamed(host, chunk_rows, device=dev)
    assert got.device == whole.device and torch.equal(got, whole)
    back = bitslice_untranspose_streamed(got, chunk_rows)
    assert isinstance(back, np.ndarray) and np.array_equal(back, host)
    cols = rng.integers(0, 1 << 32, (2, rows, w), dtype=np.uint32)
    got = bitslice_transpose_streamed_cols(cols, chunk_rows, device=dev)
    assert torch.equal(got, bitslice_transpose(to_torch(cols, dev)))


@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("log_rate", [0, 2])
@pytest.mark.parametrize("on_card", [False, True])
def test_forced_capacity_route_golden_on_card(dev, monkeypatch, fused,
                                              log_rate, on_card):
    """AdditiveNTT128(16, r).apply on the capacity route (budget lowered,
    2^11 rows in chunks of 256) from host words and from card words: the
    golden digest, an int32 output on the card."""
    monkeypatch.setattr(ab, "capacity_budget", lambda device: 0)
    monkeypatch.setattr(ab, "STREAM_CHUNK_ROWS", 256)
    words = _words(16, log_rate)
    ntt = AdditiveNTT128(16, log_rate, use_fused=fused, device=dev)
    out = ntt.apply(to_torch(words, dev) if on_card else words)
    assert out.device.type == "cuda" and out.dtype == torch.int32
    assert out.shape == ((1 << (16 + log_rate)) * 4,)
    digest = hashlib.md5(to_numpy(out).astype("<u4").tobytes()).hexdigest()
    assert digest == ADDITIVE_NTT128_HASHES[log_rate][16]
