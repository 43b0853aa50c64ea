"""Plain additive NTT over GF(2^128) (Lin–Chung–Han novel basis).

The transform of 2^log_h elements at rate 2^-log_rate evaluates on
2^log_rate cosets: the input is copied into every coset, then stages
s = log_h-1 .. 0 pair the elements e and e + 2^s of each block of 2^(s+1)
and set u' = u + w v, v' = u' + v.  The twiddle w of a block is the XOR
of ``rows[s][k]`` over the set bits k of its indicator
``coset << (log_h-1-s) | block``.  Output element e of coset c is at
c 2^log_h + e.

Data are batches of 32 elements as bit planes (reference/tower.py).  A
stage s >= 5 pairs whole batches; a stage s < 5 pairs the lanes j and
j + 2^s of each batch, whose twiddle is the XOR of a batch part and a lane
part.
"""

from __future__ import annotations

import torch

from . import tower

# lanes whose bit s is clear, for the in-batch stages s = 0 .. 4
LANE_MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)


def twiddle_rows(log_h: int, log_rate: int) -> list[list[int]]:
    """Normalised subspace evaluations: row s holds the log_h + log_rate
    - 1 - s twiddle generators of stage s (integers of 128 bits)."""
    width = log_h + log_rate - 1
    rows = [[0] * width for _ in range(log_h)]
    for i in range(1, log_h + log_rate):
        rows[0][i - 1] = 1 << i
    norms = [1]
    for i in range(1, log_h):
        prev, c = rows[i - 1], norms[-1]

        def q(x, c=c):                      # x^2 + c x
            return tower.mul(x, x) ^ tower.mul(c, x)

        norms.append(q(prev[0]))
        for j in range(1, log_h + log_rate - i):
            rows[i][j - 1] = q(prev[j])
    for i in range(log_h):
        inv = tower.inverse(norms[i])
        for j in range(log_h + log_rate - 1 - i):
            rows[i][j] = tower.mul(inv, rows[i][j])
    return rows


def stage_work(rows, log_h: int, log_rate: int) -> list[tuple[bool, bool]]:
    """Per stage s (index s): (some twiddle is not 0, every twiddle lies in
    GF(2^32)).  The twiddles are XORs of the stage's generators, so both
    follow from the generators."""
    out = []
    for s in range(log_h):
        gens = rows[s][:log_h + log_rate - 1 - s]
        out.append((any(gens), all(g < 1 << 32 for g in gens)))
    return out


def _doubling(consts, device) -> torch.Tensor:
    """Twiddles by indicator, (2^len(consts), 4) int64 words."""
    table = torch.zeros((1, tower.WORDS), dtype=torch.int64, device=device)
    for c in consts:
        w = torch.tensor([(c >> (32 * i)) & 0xFFFFFFFF
                          for i in range(tower.WORDS)], dtype=torch.int64,
                         device=device)
        table = torch.cat([table, table ^ w])
    return table


def _stage(X, s: int, rows, log_h: int, log_rate: int, coset0: int,
           off: int, nb: int, mul) -> None:
    """Stage s, in place, on X (128, ncos, nbl): the batches [off, off +
    nbl) of the cosets [coset0, coset0 + ncos) of a transform of nb
    batches a coset (a block of the stage lies within the range)."""
    bits = log_h + log_rate - 1 - s
    dev = X.device
    ncos, nbl = X.shape[1], X.shape[2]
    cos = slice(coset0, coset0 + ncos)
    if s >= 5:
        hb = 1 << (s - 5)
        nblk, b0 = nbl // (2 * hb), off // (2 * hb)
        table = _doubling(rows[s][:bits], dev).view(1 << log_rate, -1, 4)
        tw = tower.words_to_const_planes(
            table[cos, b0:b0 + nblk].reshape(-1, 4))
        v4 = X.view(tower.BITS, ncos, nblk, 2, hb)
        u, v = v4[:, :, :, 0, :], v4[:, :, :, 1, :]
        tw = tw.view(tower.BITS, ncos, nblk, 1).expand_as(v)
        prod = mul(v.reshape(tower.BITS, -1), tw.reshape(tower.BITS, -1))
        u ^= prod.view_as(u)
        v ^= u
        return
    lane_bits = 4 - s
    lane_tw = [0] * 32
    for j in range(32):
        jj = j >> (s + 1)
        for k in range(lane_bits):
            if jj >> k & 1:
                lane_tw[j] ^= rows[s][k]
    lanes = torch.tensor([tower.to_i32(w) for w in tower.lane_planes(lane_tw)],
                         dtype=torch.int32, device=dev)[:, None]
    table = _doubling(rows[s][lane_bits:bits], dev).view(1 << log_rate, nb, 4)
    hi = tower.words_to_const_planes(table[cos, off:off + nbl].reshape(-1, 4))
    tw = hi ^ lanes                         # (128, ncos nbl)
    d, m = 1 << s, tower.to_i32(LANE_MASKS[s])
    flat = X.view(tower.BITS, -1)
    u = flat & m
    v = (flat >> d) & m
    u ^= mul(v, tw) & m
    v ^= u
    flat.copy_(u | (v << d))


def ntt_planes(x: torch.Tensor, log_h: int, log_rate: int, rows=None,
               mul=tower.mul_planes) -> torch.Tensor:
    """x (128, nb) planes of 2^log_h elements -> (128, 2^log_rate nb)
    planes of the evaluations, coset-major.  ``mul``: the planes' product
    (a control passes another)."""
    if rows is None:
        rows = twiddle_rows(log_h, log_rate)
    nb = x.shape[1]
    if nb << 5 != 1 << log_h:
        raise ValueError(f"ntt_planes: {nb} batches for 2^{log_h} points")
    cosets = 1 << log_rate
    X = x.repeat(1, cosets).view(tower.BITS, cosets, nb)
    for s in range(log_h - 1, -1, -1):
        _stage(X, s, rows, log_h, log_rate, 0, 0, nb, mul)
    return X.view(tower.BITS, cosets * nb)


def ntt_shard_planes(x: torch.Tensor, log_h: int, log_rate: int, shard: int,
                     shards: int, rows=None,
                     mul=tower.mul_planes) -> torch.Tensor:
    """The batches [shard sb, (shard + 1) sb) of every coset of the
    transform of x (128, nb), sb = nb / shards: (128, 2^log_rate, sb).
    Each coset runs the top log2(shards) stages whole, one coset at a
    time, and the shard's range goes through the others."""
    if rows is None:
        rows = twiddle_rows(log_h, log_rate)
    nb = x.shape[1]
    cosets, sb = 1 << log_rate, nb // shards
    log_d = shards.bit_length() - 1
    out = torch.empty((tower.BITS, cosets, sb), dtype=x.dtype,
                      device=x.device)
    for c in range(cosets):
        Y = x.clone().view(tower.BITS, 1, nb)
        for s in range(log_h - 1, log_h - 1 - log_d, -1):
            _stage(Y, s, rows, log_h, log_rate, c, 0, nb, mul)
        out[:, c] = Y[:, 0, shard * sb:(shard + 1) * sb]
        del Y
    for s in range(log_h - 1 - log_d, -1, -1):
        _stage(out, s, rows, log_h, log_rate, 0, shard * sb, nb, mul)
    return out


def ntt_sliced(data: torch.Tensor, log_h: int, log_rate: int, rows=None,
               mul=tower.mul_planes) -> torch.Tensor:
    """data (nb, 128) batches -> (2^log_rate nb, 128) batches."""
    out = ntt_planes(data.T.contiguous(), log_h, log_rate, rows, mul)
    return out.T.contiguous()


def ntt_words(words: torch.Tensor, log_h: int, log_rate: int, rows=None,
              mul=tower.mul_planes) -> torch.Tensor:
    """(2^log_h * 4,) element words -> (2^(log_h+log_rate) * 4,) words."""
    sliced = tower.to_planes(words)
    out = ntt_sliced(sliced, log_h, log_rate, rows, mul)
    del sliced
    return tower.from_planes(out)
