"""The BB31 stage-group kernel's schedule, on the CPU.

csrc/stage_group_r2.cu runs a group's stages in register rounds on a
shared-memory tile; ntt/cuda_fused_bb31.py decides its launch (plan,
columns, rounds, threads, shared memory) and models its index maps (the
tile words a thread holds in a round, the twiddle each butterfly reads, the
shared-memory word of each tile word).  These tests hold the launch to the
kernel's limits for every log_n of the transform, and run the model in
numpy over whole arrays, with the kernel's REDC, against
``stage_group_r2_plain`` after every group and against the golden digests.
"""

import hashlib

import numpy as np
import pytest
import torch

from golden_hashes import BB31_NTT_HASHES
from binius_ntt_tpu_torch import NTTRadix2
from binius_ntt_tpu_torch.fields import baby_bear as bb
from binius_ntt_tpu_torch.ntt import cuda_fused_bb31 as cfb
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

# (KB, KU) plans with many seams: one- to five-stage groups, tiles of a
# few columns, rounds of one to four stages
SEAM_PLANS = [(2, 2), (3, 5), (5, 3), (7, 1), (13, 11)]
ALL_LOG_N = range(1, 28)


def _plan(monkeypatch, kb, ku):
    if kb is not None:
        monkeypatch.setattr(cfb, "KB", kb)
        monkeypatch.setattr(cfb, "KU", ku)


@pytest.mark.parametrize("log_n", ALL_LOG_N)
def test_plan_covers_every_stage_once_in_order(log_n):
    plan = cfb.plan_groups_r2(log_n)
    stages = [s for s0, k in plan for s in range(s0, s0 + k)]
    assert stages == list(range(log_n))
    assert plan[0] == (0, min(log_n, cfb.KB))
    assert all(1 <= k <= min(cfb.KU, cfb.TILE_LOG) for _, k in plan[1:])
    sizes = [k for _, k in plan[1:]]
    assert sizes == sorted(sizes, reverse=True)
    assert not sizes or sizes[0] - sizes[-1] <= 1
    if log_n <= 6:               # one kernel group on the card
        assert plan == [(0, log_n)]


@pytest.mark.parametrize("kb,ku", [(None, None), *SEAM_PLANS])
def test_launch_fits_the_card(kb, ku, monkeypatch):
    """Every group of every log_n: the tile and the staged twiddles fit
    227 KB, words a thread times threads is the tile in every round, and
    the rounds cover the group's stages."""
    _plan(monkeypatch, kb, ku)
    for log_n in ALL_LOG_N:
        for s0, k in cfb.plan_groups_r2(log_n):
            launch = cfb.launch_r2(s0, k, log_n)
            c, threads = launch["cols"], launch["threads"]
            big_k = k + c
            assert 0 <= c <= max(s0, cfb.GATHER_COLS_LOG)
            assert big_k <= min(cfb.TILE_LOG, log_n)
            row_blocks = 1 << c if s0 == 0 else 1
            assert launch["smem"] == 4 * ((1 << big_k) + (k > 1) * (
                row_blocks << (k - 1))) <= cfb.SMEM_LIMIT
            assert launch["blocks"] << big_k == 1 << log_n
            assert threads & (threads - 1) == 0
            assert 1 <= threads <= cfb.MAX_THREADS
            assert sum(launch["rounds"]) == k
            assert all(1 <= r <= cfb.ROUND_LOG for r in launch["rounds"])
            assert len(launch["rounds"]) == -(-k // cfb.ROUND_LOG)
            for r, per in zip(launch["rounds"],
                              launch["groups_per_thread"]):
                assert per >= 1 and (1 << r) * per * threads == 1 << big_k
            if launch["async_tile"]:
                assert c >= 2 and s0 > 0


@pytest.mark.parametrize("s0,k,log_n", [
    (0, 1, 1), (0, 7, 8), (0, 12, 24), (0, 13, 13), (0, 13, 27),
    (0, 15, 15), (12, 12, 24), (13, 11, 24), (12, 8, 27), (20, 7, 27),
    (14, 13, 27), (3, 2, 5), (1, 5, 6)])
def test_round_words_partition_the_tile(s0, k, log_n):
    """In each round the register groups hold every tile word once, each
    group's words differing only in the round's row bits."""
    c = cfb.tile_columns(s0, k, log_n)
    big_k = k + c
    j = 0
    for q, r in enumerate(cfb.group_rounds(k)):
        words = cfb.round_words(s0, k, log_n, q,
                                np.arange(1 << (big_k - r)))
        assert np.array_equal(np.sort(words.reshape(-1)),
                              np.arange(1 << big_k))
        row_bits = ((1 << r) - 1) << (c + j)
        assert ((words ^ words[:, :1]) & ~row_bits == 0).all()
        j += r


@pytest.mark.parametrize("s0,k", [(0, 12), (12, 12), (13, 11), (20, 7),
                                  (2, 3), (5, 1), (0, 3), (0, 1)])
def test_round_twiddles_are_the_butterflies_own(s0, k):
    """The twiddle each modelled butterfly reads, from the table or its
    shared-memory slot, is tw[i >> (s+1)] for its u word i at stage s,
    in the first, second, a middle and the last tile."""
    log_n = s0 + k + 4
    c = cfb.tile_columns(s0, k, log_n)
    hi_all, base_all = cfb.tile_bases(s0, k, log_n)
    pick = np.unique([0, 1, len(hi_all) // 2 + 1, len(hi_all) - 1])
    j = 0
    for q, r in enumerate(cfb.group_rounds(k)):
        ids = np.arange(1 << (k + c - r))
        words = cfb.round_words(s0, k, log_n, q, ids)
        for hi, base in zip(hi_all[pick], base_all[pick]):
            tws = cfb.round_twiddles(s0, k, log_n, q, int(hi), ids)
            gidx = cfb.global_index(words, s0, k, log_n, int(hi),
                                    int(base))
            for i in range(r):
                m = np.array([m for m in range(1 << r) if not m >> i & 1])
                want = gidx[:, m] >> (s0 + j + i + 1)
                assert np.array_equal(tws[i][:, m >> (i + 1)], want)
        j += r


@pytest.mark.parametrize("s0,k", [(0, 12), (0, 13), (12, 12), (13, 11),
                                  (20, 7), (14, 13), (1, 4), (2, 3)])
def test_tile_slots(s0, k):
    """The shared-memory layout is a permutation of the tile, and keeps
    16-byte chunks whole where the tile is copied in by chunks."""
    log_n = 27
    big_k = k + cfb.tile_columns(s0, k, log_n)
    e = np.arange(1 << big_k)
    slots = cfb.tile_slot(e, s0, k, log_n)
    assert np.array_equal(np.sort(slots), e)
    if cfb.async_tile(s0, k, log_n):
        assert np.array_equal(slots[3::4] - slots[::4], np.full(
            len(e) // 4, 3))
        assert (slots[::4] % 4 == 0).all()


def _bank_degree(slots):
    """Largest number of distinct words one bank serves in a warp access."""
    per_bank = {}
    for s in set(int(v) for v in slots):
        per_bank.setdefault(s % 32, set()).add(s)
    return max(len(v) for v in per_bank.values())


@pytest.mark.parametrize("log_n", [24, 27])
def test_main_path_rounds_are_conflict_free(log_n):
    """At the main path's plans a warp's 32 lanes (32 consecutive register
    groups) read and write 32 distinct banks at every word of every
    round."""
    for s0, k in cfb.plan_groups_r2(log_n):
        big_k = k + cfb.tile_columns(s0, k, log_n)
        for q, r in enumerate(cfb.group_rounds(k)):
            words = cfb.round_words(s0, k, log_n, q, np.arange(32))
            slots = cfb.tile_slot(words, s0, k, log_n)
            assert max(_bank_degree(slots[:, m]) for m in range(1 << r)) \
                == 1, (s0, k, q, big_k)


# ---- the model run in numpy against the plain version ----

def _redc(a, b):
    """The kernel's Montgomery product (REDC with one conditional
    subtract) on uint32 arrays."""
    ab = a.astype(np.uint64) * b.astype(np.uint64)
    lo = ab & 0xFFFFFFFF
    red = (0x100000000 - lo * bb.M) & 0xFFFFFFFF
    ret = (ab >> 32) + ((red * bb.P) >> 32) + (lo != 0)
    return np.where(ret >= bb.P, ret - bb.P, ret).astype(np.uint32)


def _add(a, b):
    r = a.astype(np.uint64) + b
    return np.where(r >= bb.P, r - bb.P, r).astype(np.uint32)


def _sub(a, b):
    r = a.astype(np.int64) - b.astype(np.int64)
    return np.where(r < 0, r + bb.P, r).astype(np.uint32)


def model_group(x, tw, *, s0, k, log_n, encode_in, decode_out, src):
    """One group as the kernel schedules it: every tile's register groups,
    round by round, through the modelled index maps; x updated in place."""
    if src is not None:
        x[:] = src[cfb.bit_reverse_indices(log_n, "cpu").numpy()]
    launch = cfb.launch_r2(s0, k, log_n)
    his, bases = cfb.tile_bases(s0, k, log_n)
    top = s0 + k == log_n
    last_q = len(launch["rounds"]) - 1
    for q, r in enumerate(launch["rounds"]):
        ids = np.arange(1 << (k + launch["cols"] - r))
        words = cfb.round_words(s0, k, log_n, q, ids)
        gidx = cfb.global_index(words[None], s0, k, log_n,
                                his[:, None, None], bases[:, None, None])
        w = x[gidx]                             # (tiles, ids, 2^r)
        if q == 0 and encode_in:
            w = _redc(w, np.uint32(bb.R2))
        tws = [np.stack(t) for t in zip(*(
            cfb.round_twiddles(s0, k, log_n, q, int(hi), ids)
            for hi in his))]
        for i in range(r):
            m = np.array([m for m in range(1 << r) if not m >> i & 1])
            u, v = w[..., m], w[..., m + (1 << i)]
            d = _sub(u, v)
            w[..., m] = _add(u, v)
            skip = top and q == last_q and i == r - 1
            w[..., m + (1 << i)] = (
                d if skip else _redc(d, tw[tws[i][..., m >> (i + 1)]]))
        if q == last_q and decode_out:
            w = _redc(w, np.uint32(1))
        x[gidx] = w
    return x


def test_redc_matches_the_field():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
    b = rng.integers(0, bb.P, 4096, dtype=np.uint32)
    want = to_numpy(bb.mont_mul(to_torch(a), to_torch(b)))
    assert np.array_equal(_redc(a, b), want.astype(np.uint32))


@pytest.mark.parametrize("kb,ku", [(None, None), *SEAM_PLANS])
@pytest.mark.parametrize("log_n", range(7, 17))
def test_model_matches_plain_after_every_group(log_n, kb, ku, monkeypatch):
    _plan(monkeypatch, kb, ku)
    ntt = NTTRadix2(137, 27, log_n, device="cpu")
    tw = to_numpy(ntt.tw).astype(np.uint32)
    words = mt19937_stream(0xDEADBEEF + log_n, 1 << log_n)
    plan = cfb.plan_groups_r2(log_n)
    got = np.zeros(1 << log_n, dtype=np.uint32)
    want = torch.zeros(1 << log_n, dtype=torch.int32)
    for gi, (s0, k) in enumerate(plan):
        kw = dict(s0=s0, k=k, log_n=log_n, encode_in=gi == 0,
                  decode_out=gi == len(plan) - 1)
        model_group(got, tw, src=words if gi == 0 else None, **kw)
        cfb.stage_group_r2_plain(want, ntt.tw, **kw, src=(
            to_torch(words) if gi == 0 else None))
        assert np.array_equal(got, to_numpy(want).astype(np.uint32)), \
            (s0, k)
    if log_n in BB31_NTT_HASHES:
        digest = hashlib.md5(got.astype("<u4").tobytes()).hexdigest()
        assert digest == BB31_NTT_HASHES[log_n]
