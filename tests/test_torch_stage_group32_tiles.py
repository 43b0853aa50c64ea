"""csrc/stage_group32.cu's shared-memory design, on the CPU.

The kernel runs every stage group on a tile in shared memory: an upper
group's block holds one 128-byte lane group (a slot) of each of its 2^k
tile rows in ``group_cols32`` columns; the bottom group's block all four lane groups of its rows
(slot 4t + c), runs stage 6 as slot butterflies (t, h) x (t, h + 2), then
walks each (row t, pair h) through stage 5 and the in-word stages 4..0 in
registers, the pair's u lanes (lo) and v lanes (cp) packed so that one
multiply serves both lane groups.  ``_tiles_model`` transliterates that
arithmetic into torch in the kernel's order (slots at their swizzled
shared-memory positions, twiddle planes as parity((blk & mt) ^ (q & mi)))
and is held word for word to ``stage_group32_plain``, which
tests/test_torch_ntt32.py holds to the JAX package.  The kernel itself
runs in tests/test_torch_cuda.py on the card.  Every comparison is exact.
"""

import hashlib

import numpy as np
import pytest
import torch

from golden_hashes import ADDITIVE_NTT_HASHES
from binius_ntt_tpu_torch.fields import bitsliced
from binius_ntt_tpu_torch.ntt import cuda_fused32 as cf32
from binius_ntt_tpu_torch.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu_torch.ntt.cuda_fused import _parity_planes
from binius_ntt_tpu_torch.utils.bits import lsr, to_numpy, to_torch, u32
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

W32, PACK = cf32.W32, cf32.PACK
VECS = W32 // 4                 # uint4 vectors of a slot


def _twiddle(blk, mt, q, mi):
    """(..., 32) planes parity((blk & mt) ^ (q & mi)) as 0 or ~0."""
    return _parity_planes((blk[..., None] & mt) ^ (q[..., None] & mi),
                          torch.tensor(-1, dtype=torch.int32))


class _Shared:
    """The blocks' shared memory as (blocks, slots * 8, 4) words: vector j
    of slot s at position 8 s + (j ^ (s & 7))."""

    def __init__(self, slots):          # (blocks, n_slots, 32)
        self.vec = torch.zeros(slots.shape[0], slots.shape[1] * VECS, 4,
                               dtype=torch.int32)
        s = torch.arange(slots.shape[1])
        self.store(s.expand(slots.shape[0], -1), slots)

    def _pos(self, s):                  # (blocks, units) -> (.., units, 8)
        j = torch.arange(VECS)
        return s[..., None] * VECS + (j ^ (s[..., None] & 7))

    def load(self, s):                  # (blocks, units) -> (.., units, 32)
        pos = self._pos(s).reshape(s.shape[0], -1)
        got = torch.gather(self.vec, 1, pos[..., None].expand(-1, -1, 4))
        return got.reshape(*s.shape, W32)

    def store(self, s, d):
        pos = self._pos(s).reshape(s.shape[0], -1)
        self.vec.scatter_(1, pos[..., None].expand(-1, -1, 4),
                          d.reshape(s.shape[0], -1, 4))

    def slots(self):
        n = self.vec.shape[1] // VECS
        return self.load(torch.arange(n).expand(self.vec.shape[0], -1))


def _slot_butterflies(sm, su, sv, w, zero):
    """u' = u ^ w*v, v' = u' ^ v on slots su, sv of every block."""
    b = sm.load(sv)
    prod = torch.zeros_like(b) if zero else bitsliced.multiply(w, b, 5)
    a = sm.load(su) ^ prod
    sm.store(su, a)
    sm.store(sv, b ^ a)


def _pair_walk(x0, x1, t, q, h, tabs, zero_low):
    """Stage 5 and the in-word stages 4..0 on lane groups 2h, 2h + 1."""
    for i in range(1, cf32.N_LOW):
        s = 6 - i
        c0 = tabs["cpl"][i][2 * h]                       # (.., units, 32)
        base = _twiddle(t, tabs["mlo_t"][i], q, tabs["mlo_i"][i])
        if i == 1:
            lo, cp = x0, x1
            wc = base ^ c0
        else:
            sh, um = 1 << s, cf32._LANE_MASKS[s]
            vm = u32(um << sh)
            lo = (x0 & um) | ((x1 & um) << sh)
            cp = (lsr(x0, sh) & um) | (x1 & vm)
            base = base ^ tabs["lpl"][i]
            w0, w1 = base ^ c0, base ^ tabs["cpl"][i][2 * h + 1]
            wc = (w0 & um) | ((w1 & um) << sh)
        prod = (torch.zeros_like(cp) if (zero_low >> i) & 1
                else bitsliced.multiply(wc, cp, 5))
        un = lo ^ prod
        vn = cp ^ un
        if i == 1:
            x0, x1 = un, vn
        else:
            x0 = (un & um) | ((vn & um) << sh)
            x1 = lsr(un & vm, sh) | (vn & vm)
    return x0, x1


def _tiles_model(x, tabs, *, t0, k, include_low, cosets, log_nbr):
    """csrc/stage_group32.cu's arithmetic in torch, block by block in
    parallel, unit by unit in parallel within a pass (a pass's units touch
    disjoint slots, as the kernel's threads between two barriers do)."""
    n_inst, post = cf32._group_geometry32(x, tabs, t0, k, include_low,
                                          cosets, log_nbr)
    cols = 1 if include_low else cf32.group_cols32(k, post)
    lg = 2 if include_low else cols.bit_length() - 1
    x6 = x.view(n_inst, 1 << k, post // cols, cols, PACK, W32)
    if include_low:                     # a block an instance, slot 4t + c
        slots = x6[:, :, 0, 0].reshape(n_inst, PACK << k, W32)
        q = torch.arange(n_inst, dtype=torch.int32)
    else:                               # a block per (q, columns, c),
        slots = x6.permute(0, 2, 4, 1, 3, 5).reshape(   # slot t * cols + j
            -1, cols << k, W32)
        q = torch.arange(n_inst, dtype=torch.int32).repeat_interleave(
            post // cols * PACK)
    sm = _Shared(slots)
    q = q[:, None]
    zero = tabs["zero"]

    for st in range(k):                 # row stages, p = k-1-st
        p = k - 1 - st
        i = torch.arange(1 << (k + lg - 1))
        cc, b = i & ((1 << lg) - 1), i >> lg
        lowm = (1 << p) - 1
        t = ((b & ~lowm) << 1) | (b & lowm)
        su = ((t << lg) + cc).expand(len(q), -1)
        w = _twiddle((t >> (p + 1)).to(torch.int32)[None].expand(len(q), -1),
                     tabs["mtile"][st], q.expand(-1, len(i)),
                     tabs["minst"][st])
        _slot_butterflies(sm, su, su + ((1 << lg) << p), w, zero[st])

    if include_low:
        i = torch.arange(2 << k)
        h = i & 1
        t = (i >> 1).to(torch.int32)[None].expand(len(q), -1)
        qq = q.expand(-1, len(i))
        # stage 6: lane groups h and h + 2 of row t
        su = 4 * t.long() + h
        w = (_twiddle(t, tabs["mlo_t"][0], qq, tabs["mlo_i"][0])
             ^ tabs["cpl"][0][h])
        _slot_butterflies(sm, su, su + 2, w, zero[k])
        # stage 5 and 4..0 per (row t, pair h), lane groups 2h and 2h + 1
        s0 = 4 * t.long() + 2 * h
        zero_low = sum(1 << j for j, z in enumerate(zero[k:]) if z)
        x0, x1 = _pair_walk(sm.load(s0), sm.load(s0 + 1), t, qq, h, tabs,
                            zero_low)
        sm.store(s0, x0)
        sm.store(s0 + 1, x1)

    out = sm.slots()
    if include_low:
        x6[:, :, 0, 0] = out.view(n_inst, 1 << k, PACK, W32)
    else:
        x6.copy_(out.view(n_inst, post // cols, PACK, 1 << k, cols, W32)
                 .permute(0, 3, 1, 4, 2, 5))
    return x


def _words(log_h, log_rate):
    return mt19937_stream(0xDEADBEEF + log_h + log_rate, 1 << log_h)


def _run(log_h, log_rate, monkeypatch, plan=None, rng=None):
    """Every group through the model and the plain version side by side;
    returns the chained output's MD5."""
    if plan is not None:
        monkeypatch.setattr(cf32, "KB", plan[0])
        monkeypatch.setattr(cf32, "KU", plan[1])
    tables = cf32.build_tables32(
        precompute_subspace_evals(log_h, log_rate, 5), log_h, log_rate)
    cosets = 1 << log_rate
    if rng is None:
        words = to_torch(_words(log_h, log_rate))
    else:
        words = to_torch(rng.integers(0, 1 << 32, 1 << log_h,
                                      dtype=np.uint32))
    packed = cf32.bitslice_lane_groups_plain(words.view(-1, 128))
    x = packed.repeat(cosets, 1).view(cosets, -1, 128)
    for (t0, k, low, tabs) in tables:
        kw = dict(t0=t0, k=k, include_low=low, cosets=cosets,
                  log_nbr=log_h - 7)
        want = cf32.stage_group32_plain(x.clone(), tabs, **kw)
        assert _tiles_model(x, tabs, **kw) is x
        assert torch.equal(x, want), (t0, k, low)
    out = cf32.bitslice_lane_groups_plain(x.view(-1, 128)).reshape(-1)
    return hashlib.md5(to_numpy(out).astype("<u4").tobytes()).hexdigest()


@pytest.mark.parametrize("log_h,log_rate", [(7, 0), (7, 2), (11, 4),
                                            (13, 2)])
def test_tiles_match_plain_under_a_forced_plan(log_h, log_rate,
                                               monkeypatch):
    """KB = KU = 2: group seams, cosets, a bottom group of one row."""
    digest = _run(log_h, log_rate, monkeypatch, (2, 2))
    if log_rate in ADDITIVE_NTT_HASHES:
        assert digest == ADDITIVE_NTT_HASHES[log_rate][log_h]


@pytest.mark.parametrize("log_rate", [0, 2])
@pytest.mark.parametrize("plan", cf32.SWEPT_PLANS)
def test_tiles_match_plain_under_each_swept_plan(plan, log_rate,
                                                 monkeypatch):
    rng = np.random.default_rng(16 + log_rate + 100 * plan[0] + plan[1])
    _run(16, log_rate, monkeypatch, plan, rng)


@pytest.mark.parametrize("log_rate", [0, 2])
@pytest.mark.parametrize("log_h", range(7, 13))
def test_tiles_chain_gives_the_golden_digest(log_h, log_rate, monkeypatch):
    assert (_run(log_h, log_rate, monkeypatch)
            == ADDITIVE_NTT_HASHES[log_rate][log_h])


@pytest.mark.parametrize("plan", cf32.SWEPT_PLANS)
def test_swept_plans_fit_shared_memory(plan, monkeypatch):
    """At 2^24 (17 row bits) every swept plan's tiles fit one block's
    shared memory, and the plans cover the row bits."""
    monkeypatch.setattr(cf32, "KB", plan[0])
    monkeypatch.setattr(cf32, "KU", plan[1])
    groups = cf32.plan_groups32(17)
    assert sorted(b for t0, k, _ in groups for b in range(t0, t0 + k)) \
        == list(range(17))
    assert all(cf32.tile_bytes32(k, low) <= cf32.SMEM_LIMIT
               for _, k, low in groups)


@pytest.mark.parametrize("k,post,cols", [
    (9, 1 << 8, 1), (10, 1, 1), (8, 1 << 9, 1), (7, 1 << 10, 2),
    (5, 1 << 8, 8), (1, 1 << 16, 128), (1, 1 << 4, 16), (2, 1, 1)])
def test_group_cols32(k, post, cols):
    """An upper block covers columns until a pass has 128 butterflies (or
    the tile runs out of columns): one at k >= 8."""
    assert cf32.group_cols32(k, post) == cols
    assert post % cols == 0
    assert cf32.tile_bytes32(k, False, cols) <= 32 << 10 or cols == 1


@pytest.mark.parametrize("k,low,nbytes", [
    (9, False, 64 << 10), (10, False, 128 << 10), (11, False, 256 << 10),
    (7, True, 64 << 10), (8, True, 128 << 10), (9, True, 256 << 10),
    (0, True, 512)])
def test_tile_bytes32(k, low, nbytes):
    assert cf32.tile_bytes32(k, low) == nbytes
    assert (nbytes <= cf32.SMEM_LIMIT) == (k <= (8 if low else 10))
