"""GF(2^128) tower arithmetic for the plain references.

The binary tower: F_0 = GF(2), F_h = F_(h-1)[X] / (X^2 + a_(h-1) X + 1),
where a_0 = 1 and a_(h-1) is the generator X of F_(h-1) for h >= 2.  An
element of F_h is an integer of 2^h bits, its low half the constant term
and its high half the coefficient of X.  GF(2^128) is F_7.

Two forms of the same multiply:

  * ``mul``, ``inverse`` on Python integers, for twiddles and the last
    rounds of a sumcheck;
  * ``mul_planes`` on bit planes: a (2^h, N) int32 tensor whose plane i
    holds bit i of 32 N elements, one a bit of the words (Karatsuba, the
    three half products of a level as one call on three times the
    columns).

And the layout between element words and planes: ``to_planes`` and
``from_planes``.  An element is four little-endian 32-bit words; a batch
is 32 consecutive elements, and bit j of plane i of a batch is bit i of
its element j.
"""

from __future__ import annotations

import torch

HEIGHT = 7
BITS = 1 << HEIGHT
WORDS = BITS // 32
# columns of one mul_planes call: the deepest level holds 3^7 of them
# for each, 2187 * 2^16 * 4 bytes = 573 MB
CHUNK = 1 << 16


def _mul_alpha(x: int, h: int) -> int:
    """x times the generator a_h of F_h (X of F_h; 1 in F_0)."""
    if h == 0:
        return x
    half = 1 << (h - 1)
    x0, x1 = x & ((1 << half) - 1), x >> half
    return x1 | ((x0 ^ _mul_alpha(x1, h - 1)) << half)


def _table8() -> list[int]:
    table = [0] * (1 << 16)
    for a in range(256):
        for b in range(256):
            table[a << 8 | b] = _mul_slow(a, b, 3)
    return table


def _mul_slow(a: int, b: int, h: int) -> int:
    if h == 0:
        return a & b
    half = 1 << (h - 1)
    m = (1 << half) - 1
    a0, a1, b0, b1 = a & m, a >> half, b & m, b >> half
    z0, z2 = _mul_slow(a0, b0, h - 1), _mul_slow(a1, b1, h - 1)
    zm = _mul_slow(a0 ^ a1, b0 ^ b1, h - 1)
    lo = z0 ^ z2
    return lo | ((zm ^ lo ^ _mul_alpha(z2, h - 1)) << half)


_T8: list[int] = []


def mul(a: int, b: int, h: int = HEIGHT) -> int:
    """Product in F_h of two integers of 2^h bits."""
    if h <= 3:
        if h < 3:
            return _mul_slow(a, b, h)
        if not _T8:
            _T8.extend(_table8())
        return _T8[a << 8 | b]
    half = 1 << (h - 1)
    m = (1 << half) - 1
    a0, a1, b0, b1 = a & m, a >> half, b & m, b >> half
    z0, z2 = mul(a0, b0, h - 1), mul(a1, b1, h - 1)
    zm = mul(a0 ^ a1, b0 ^ b1, h - 1)
    lo = z0 ^ z2
    return lo | ((zm ^ lo ^ _mul_alpha(z2, h - 1)) << half)


def inverse(a: int, h: int = HEIGHT) -> int:
    """a^-1 in F_h (0 for 0): a times its conjugate a0 + a1 a' + a1 X is
    the norm a0^2 + a0 a1 a' + a1^2 of F_(h-1), a' = a_(h-1)."""
    if h == 0:
        return a
    half = 1 << (h - 1)
    m = (1 << half) - 1
    a0, a1 = a & m, a >> half
    norm = (mul(a0, a0, h - 1) ^ _mul_alpha(mul(a0, a1, h - 1), h - 1)
            ^ mul(a1, a1, h - 1))
    ninv = inverse(norm, h - 1)
    lo = mul(a0 ^ _mul_alpha(a1, h - 1), ninv, h - 1)
    return lo | (mul(a1, ninv, h - 1) << half)


# ---- bit planes --------------------------------------------------------

def _alpha_planes(x: torch.Tensor) -> torch.Tensor:
    w = x.shape[0]
    if w == 1:
        return x
    x0, x1 = x[:w // 2], x[w // 2:]
    return torch.cat([x1, x0 ^ _alpha_planes(x1)])


def _mul_planes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w, n = a.shape
    if w == 1:
        return a & b
    h = w // 2
    a0, a1, b0, b1 = a[:h], a[h:], b[:h], b[h:]
    z = _mul_planes(torch.cat([a0, a1, a0 ^ a1], 1),
                    torch.cat([b0, b1, b0 ^ b1], 1))
    z0, z2, zm = z[:, :n], z[:, n:2 * n], z[:, 2 * n:]
    lo = z0 ^ z2
    return torch.cat([lo, zm ^ lo ^ _alpha_planes(z2)])


def mul_planes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Products of a and b, (2^h, N) int32 planes each (b may broadcast
    over columns), as (2^h, N) planes; CHUNK columns a call."""
    b = b.expand_as(a)
    n = a.shape[1]
    if n <= CHUNK:
        return _mul_planes(a.contiguous(), b.contiguous())
    out = torch.empty_like(a)
    for i in range(0, n, CHUNK):
        out[:, i:i + CHUNK] = _mul_planes(a[:, i:i + CHUNK].contiguous(),
                                          b[:, i:i + CHUNK].contiguous())
    return out


def const_planes(values, device) -> torch.Tensor:
    """Integers of 128 bits -> (128, len(values)) planes, every lane of
    column k holding values[k] (a plane is all ones or all zeros)."""
    words = torch.tensor([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(WORDS)]
                          for v in values], dtype=torch.int64)
    return words_to_const_planes(words.to(device))


def words_to_const_planes(words: torch.Tensor) -> torch.Tensor:
    """(N, 4) words (int64 or int32) -> (128, N) planes all ones or zeros,
    plane i from bit i of each value."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    w = words.to(torch.int32).T[:, None, :]                     # (4, 1, N)
    bits = (w >> shifts[:, None]) & 1                           # (4, 32, N)
    return bits.neg_().reshape(BITS, words.shape[0])


def lane_planes(values) -> list[int]:
    """32 integers of 128 bits (lane j: values[j]) -> 128 words as
    Python ints, bit j of word i being bit i of values[j]."""
    return [sum(((v >> i) & 1) << j for j, v in enumerate(values))
            for i in range(BITS)]


def to_i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >> 31 else x


def parity_value(words: torch.Tensor) -> int:
    """(128,) words of planes -> the integer whose bit i is the parity of
    word i: the sum over the 32 lanes."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = ((w[:, None] >> torch.arange(32, device=w.device)) & 1).sum(1) & 1
    return sum(int(b) << i for i, b in enumerate(bits.tolist()))


# ---- layout --------------------------------------------------------------

_LAYOUT_CHUNK = 1 << 14          # batches a step: 2^14 * 4096 B of bits


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 int32 -> (...,) int32 words, bit k from entry k."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    return (bits << shifts).sum(-1, dtype=torch.int32)


def to_planes(words: torch.Tensor) -> torch.Tensor:
    """Element words (32 nb * 4,) int32 -> (nb, 128) int32 batches, bit j
    of word i being bit i of element j."""
    x = words.reshape(-1, 32, WORDS)
    out = torch.empty((x.shape[0], BITS), dtype=torch.int32, device=x.device)
    shifts = torch.arange(32, device=x.device, dtype=torch.int32)
    for i in range(0, x.shape[0], _LAYOUT_CHUNK):
        c = x[i:i + _LAYOUT_CHUNK]
        bits = (c[..., None] >> shifts) & 1          # (b, 32 el, 4, 32)
        bits = bits.reshape(c.shape[0], 32, BITS).transpose(1, 2)
        out[i:i + _LAYOUT_CHUNK] = _pack_bits(bits)   # (b, 128)
    return out


def from_planes(sliced: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_planes`: (nb, 128) -> (32 nb * 4,)."""
    out = torch.empty((sliced.shape[0], 32, WORDS), dtype=torch.int32,
                      device=sliced.device)
    shifts = torch.arange(32, device=sliced.device, dtype=torch.int32)
    for i in range(0, sliced.shape[0], _LAYOUT_CHUNK):
        c = sliced[i:i + _LAYOUT_CHUNK]
        bits = (c[..., None] >> shifts) & 1          # (b, 128 pl, 32 el)
        bits = bits.transpose(1, 2).reshape(c.shape[0], 32, WORDS, 32)
        out[i:i + _LAYOUT_CHUNK] = _pack_bits(bits)
    return out.reshape(-1)


def ints_of_batch(batch: torch.Tensor) -> list[int]:
    """One (128,) batch of planes -> its 32 elements as integers."""
    w = from_planes(batch.reshape(1, BITS)).to(torch.int64) & 0xFFFFFFFF
    w = w.reshape(32, WORDS).tolist()
    return [sum(x << (32 * i) for i, x in enumerate(e)) for e in w]


# ---- the control's product -------------------------------------------------

def mul_planes_gf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product with both operands cut to GF(2^32) (planes 32 .. 127
    cleared): the subfield shortcut taken where it does not hold."""
    a, b = a.clone(), b.expand_as(a).clone()
    a[32:] = 0
    b[32:] = 0
    return mul_planes(a, b)


def mul_gf32(a: int, b: int, h: int = HEIGHT) -> int:
    """:func:`mul` with both operands cut to their low 32 bits."""
    m = (1 << 32) - 1
    return mul(a & m, b & m, h)
