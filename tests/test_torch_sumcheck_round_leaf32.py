"""The GF(2^128) sumcheck round kernel's arithmetic, on the CPU.

csrc/sumcheck_round.cu runs the points outer (one running product a
thread), sums a warp's 32 products with a five-step reduce-scatter (lane l
ends with words 4l .. 4l+3), and computes each GF(2^128) product as nine
GF(2^32) leaf products, the two-level Karatsuba of tower::mul_body<7> ->
<6> -> <5>, in place: the leaves of each level-6 product summed in
registers.  These tests derive the leaf table (chunk subsets and the maps
into the output chunks) from that recursion, hold the kernel's leaf order
to it, and hold torch transliterations of the table, of the kernel's
in-place product, of the reduce-scatter and of the point-outer round
against the port's multiply, the JAX package's multiply, ``round_plain``
and the JAX ``round_emulate``.  Every comparison is exact (word equality).
The kernel itself runs in tests/test_torch_cuda.py on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.fields import bitsliced as bs_jax
from binius_ntt_tpu.sumcheck import pallas_round as pr_jax
from binius_ntt_tpu_torch.fields import bitsliced
from binius_ntt_tpu_torch.sumcheck import cuda_round as cr
from binius_ntt_tpu_torch.utils.bits import lsr, to_numpy, to_torch

CSRC = Path(cr.__file__).resolve().parents[1] / "csrc"
KERNEL = CSRC / "sumcheck_round.cu"
# the in-place product, with GROUPED, shared by the round and the fold
LEAVES = CSRC / "tower_leaf32.cuh"
# the leaves by a's (and b's) chunk subsets, as mul_body<6> takes them
LEAF_ORDER = (0b0001, 0b0010, 0b0011, 0b0100, 0b1000, 0b1100, 0b0101,
              0b1010, 0b1111)
# the kernel's grouping: the level-6 products zm, z0, z2 of mul_body<7>,
# each as its operands' chunk subsets (s0, s1); its leaves s0, s1, s0 ^ s1
GROUPS = ((0b0101, 0b1010), (0b0001, 0b0010), (0b0100, 0b1000))


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, shape,
                                                dtype=np.uint32)


def _karatsuba_leaves() -> list[dict]:
    """Each 32-plane output chunk of the GF(2^128) product as a map leaf ->
    polynomial in alpha_5 (bit k: alpha_5 applied k times), walking
    tower::mul_body<7> -> <6> -> <5> symbolically.  A leaf is the GF(2^32)
    product of the XOR of a chunk subset of a by the same subset of b; it is
    keyed by the subset."""
    def add(*xs):
        out = {}
        for x in xs:
            for leaf, poly in x.items():
                out[leaf] = out.get(leaf, 0) ^ poly
        return {leaf: poly for leaf, poly in out.items() if poly}

    def alpha(x):
        return {leaf: poly << 1 for leaf, poly in x.items()}

    def mul6(x0, x1):                   # mul_body<6> on two chunk subsets
        z0, z2, zm = {x0: 1}, {x1: 1}, {x0 ^ x1: 1}
        lo = add(z0, z2)
        return [lo, add(zm, lo, alpha(z2))]

    z0 = mul6(0b0001, 0b0010)           # a_lo * b_lo
    z2 = mul6(0b0100, 0b1000)           # a_hi * b_hi
    zm = mul6(0b0101, 0b1010)           # (a_lo ^ a_hi) * (b_lo ^ b_hi)
    z2a = [z2[1], add(z2[0], alpha(z2[1]))]       # mul_alpha<6>
    lo = [add(z0[i], z2[i]) for i in range(2)]
    return lo + [add(zm[i], lo[i], z2a[i]) for i in range(2)]


def leaf_table() -> list[tuple[int, tuple]]:
    """(subset, maps into output chunks 0..3) in LEAF_ORDER."""
    chunks = _karatsuba_leaves()
    return [(s, tuple(chunk.get(s, 0) for chunk in chunks))
            for s in LEAF_ORDER]


def leaf_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The GF(2^128) product by the leaf table over (..., 128) planes:
    leaf 0 writes every output chunk, the others add through identity,
    alpha_5 and alpha_5 twice."""
    ca = a.reshape(a.shape[:-1] + (4, 32))
    cb = b.reshape(b.shape[:-1] + (4, 32))
    z = torch.zeros_like(ca)
    for first, (s, maps) in enumerate(leaf_table()):
        x = sum_chunks(ca, s)
        y = sum_chunks(cb, s)
        p = bitsliced.multiply(x, y, 5)
        p1 = bitsliced.multiply_alpha(p, 5)
        powers = (p, p1, bitsliced.multiply_alpha(p1, 5))
        for c, code in enumerate(maps):
            v = torch.zeros_like(p)
            for k in range(3):
                if (code >> k) & 1:
                    v ^= powers[k]
            z[..., c, :] = v if first == 0 else z[..., c, :] ^ v
    return z.reshape(a.shape)


def grouped_order() -> list[int]:
    return [s for s0, s1 in GROUPS for s in (s0, s1, s0 ^ s1)]


def in_place_multiply(a: torch.Tensor, b) -> torch.Tensor:
    """csrc/tower_leaf32.cuh's mul_in_place in torch over (..., 128)
    planes: per group, lo = L(s0) ^ L(s1) and hi = L(s0 ^ s1) ^ L(s0) ^
    L(s1) ^ alpha L(s1) in registers; zm to the scratch t, z0 over chunks 0
    and 1 of a, then z2 and the combine of mul_body<7> over all four.  b is
    the second operand's planes, whose leaves are gathered (the round), or
    a function of a chunk subset giving that leaf's 32 planes (the fold's
    table)."""
    ca = a.reshape(a.shape[:-1] + (4, 32)).clone()
    if callable(b):
        leaf_b = b
    else:
        cb = b.reshape(b.shape[:-1] + (4, 32))

        def leaf_b(s):
            return sum_chunks(cb, s)

    def alpha(x):
        return bitsliced.multiply_alpha(x, 5)

    t = None
    for g, (s0, s1) in enumerate(GROUPS):
        p0, p1, pm = (bitsliced.multiply(sum_chunks(ca, s), leaf_b(s), 5)
                      for s in (s0, s1, s0 ^ s1))
        lo, hi = p0 ^ p1, pm ^ p0 ^ p1 ^ alpha(p1)
        if g == 0:
            t = (lo, hi)
        elif g == 1:
            ca[..., 0, :], ca[..., 1, :] = lo, hi
        else:
            c0, c1 = ca[..., 0, :] ^ lo, ca[..., 1, :] ^ hi
            ca[..., 2, :] = t[0] ^ c0 ^ hi
            ca[..., 3, :] = t[1] ^ c1 ^ lo ^ alpha(hi)
            ca[..., 0, :], ca[..., 1, :] = c0, c1
    return ca.reshape(a.shape)


def sum_chunks(chunks: torch.Tensor, subset: int) -> torch.Tensor:
    out = torch.zeros_like(chunks[..., 0, :])
    for c in range(4):
        if (subset >> c) & 1:
            out ^= chunks[..., c, :]
    return out


def reduce_scatter(v: torch.Tensor) -> torch.Tensor:
    """The kernel's warp reduce-scatter on (..., 32 lanes, 128 words): five
    steps, at lane bit d = 16 .. 1, in which a lane keeps the half of its
    words that bit d selects and adds its partner's (lane ^ d) copy of it.
    Returns (..., 32, 4): lane l's words."""
    lane = torch.arange(32)
    t = v
    for d in (16, 8, 4, 2, 1):
        n = t.shape[-1] // 2
        top = ((lane & d) != 0)[:, None]
        a, b = t[..., :n], t[..., n:]
        keep, send = torch.where(top, b, a), torch.where(top, a, b)
        t = keep ^ send[..., lane ^ d, :]
    return t


def fold_at(lo: torch.Tensor, up: torch.Tensor, mask: int) -> torch.Tensor:
    """The kernel's fold_row: lo ^ M(lo ^ up) on every 4-plane group, M the
    4x4 matrix whose row j is bits 4j .. 4j+3 of mask."""
    lo4 = lo.reshape(lo.shape[:-1] + (32, 4))
    h4 = (lo ^ up).reshape(lo4.shape)
    out = lo4.clone()
    for j in range(4):
        for k in range(4):
            if (mask >> (4 * j + k)) & 1:
                out[..., j] ^= h4[..., k]
    return out.reshape(lo.shape)


def round_model(evals: torch.Tensor, rows: int, num_points: int,
                lanes: int = 32) -> torch.Tensor:
    """csrc/sumcheck_round.cu's round in torch: unit u is point u % P of
    the group of 32 row pairs u // P (a lane each, idle lanes past the half
    zero); its products by in_place_multiply, summed over the warp by
    reduce_scatter, the masks applied to the owned words."""
    in_word = rows == 1
    if in_word:
        lo = evals[:, :1]
        up, half = lsr(lo, lanes // 2), 1
    else:
        half = rows // 2
        lo, up = evals[:, :half], evals[:, half:rows]
    masks = [cr._matrix_mask(0), cr._matrix_mask(1)]
    masks += cr._fold_masks(num_points)
    keep_all = cr._lane_mask(lanes)
    keep = cr._lane_mask(lanes // 2) if in_word else -1
    sums = torch.zeros((num_points + 1, 128), dtype=torch.int32)
    for u in range(-(-half // 32) * num_points):
        o, first = u % num_points, u // num_points * 32
        live = slice(first, min(first + 32, half))
        f = fold_at(lo[:, live], up[:, live], masks[o])
        acc = f[0]
        for c in range(1, f.shape[0]):
            acc = in_place_multiply(acc, f[c])
        warp = torch.zeros((32, 128), dtype=torch.int32)
        warp[:acc.shape[0]] = acc
        s = reduce_scatter(warp).reshape(128)
        if o == 0:
            sums[0] ^= s & (keep_all if in_word else -1)
            sums[1] ^= s & keep
        elif o == 1:
            if not in_word:
                sums[0] ^= s
            sums[2] ^= s & keep
        else:
            sums[1 + o] ^= s & keep
    return sums


# ---- the leaf table ------------------------------------------------------

def test_leaf_table_covers_the_karatsuba():
    """Nine leaves, each the subset its operands are summed over, and every
    map of the product one of identity, alpha_5 and alpha_5 twice."""
    chunks = _karatsuba_leaves()
    assert sorted({s for chunk in chunks for s in chunk}) == sorted(
        LEAF_ORDER)
    assert all(0 < poly < 8 for chunk in chunks for poly in chunk.values())
    (first, maps), *_ = leaf_table()
    assert first == 0b0001 and maps == (1, 1, 1, 1)   # leaf 0 writes


def test_kernel_leaves_are_the_table_s_grouped():
    """The kernels' GROUPED, in the shared header, is the table's nine
    leaves, three to each level-6 product of mul_body<7>: zm = (a_lo ^
    a_hi) * (b_lo ^ b_hi), z0 = a_lo * b_lo, z2 = a_hi * b_hi."""
    text = LEAVES.read_text()
    body = re.search(r"GROUPED\[N_LEAF\] = \{([^}]*)\}", text).group(1)
    grouped = [int(w, 2) for w in re.findall(r"0b([01]+)", body)]
    assert grouped == grouped_order()
    assert sorted(grouped) == sorted(LEAF_ORDER)
    lo, hi = 0b0011, 0b1100              # a_lo, a_hi as chunk subsets
    assert [s0 | s1 for s0, s1 in GROUPS] == [lo | hi, lo, hi]


def test_point_masks_of_zero_and_one():
    """The kernel holds the matrices of points 0 and 1 itself: zero and
    the identity (IDENTITY in the source)."""
    assert cr._matrix_mask(0) == 0
    assert cr._matrix_mask(1) == 0x8421
    assert re.search(r"IDENTITY = 0x8421u", KERNEL.read_text())
    assert cr._fold_masks(5) == [cr._matrix_mask(p) for p in (2, 3, 4)]


@pytest.mark.parametrize("form", ["table", "in_place"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_leaf_product_is_the_tower_product(seed, form):
    a = _words(seed, (5, 7, 128))
    b = _words(seed + 10, (5, 7, 128))
    mul = leaf_multiply if form == "table" else in_place_multiply
    got = to_numpy(mul(to_torch(a), to_torch(b)))
    assert np.array_equal(
        got, to_numpy(bitsliced.multiply(to_torch(a), to_torch(b), 7)))
    assert np.array_equal(
        got, np.asarray(bs_jax.multiply(jnp.asarray(a), jnp.asarray(b), 7)))


def test_leaf_product_of_special_operands():
    """One, zero and single chunks: every leaf map reaches the output."""
    rng = np.random.default_rng(4)
    a = to_torch(rng.integers(0, 1 << 32, (4, 128), dtype=np.uint32))
    one = torch.zeros((4, 128), dtype=torch.int32)
    one[:, 0] = -1
    assert torch.equal(leaf_multiply(a, one), a)
    assert not leaf_multiply(a, torch.zeros_like(a)).any()
    for c in range(4):
        b = torch.zeros_like(a)
        b[:, 32 * c:32 * c + 32] = a[:, 32 * c:32 * c + 32]
        want = bitsliced.multiply(a, b, 7)
        assert torch.equal(leaf_multiply(a, b), want)
        assert torch.equal(in_place_multiply(a, b), want)


# ---- the warp reduce-scatter ---------------------------------------------

@pytest.mark.parametrize("seed,live", [(5, 32), (6, 32), (7, 13), (8, 1)])
def test_reduce_scatter_gives_each_lane_its_words(seed, live):
    v = to_torch(_words(seed, (32, 128)))
    v[live:] = 0                        # idle lanes contribute zeros
    got = reduce_scatter(v)
    total = v[0].clone()
    for lane in range(1, 32):
        total ^= v[lane]
    assert torch.equal(got, total.view(32, 4))


# ---- the point-outer round -------------------------------------------------

def _live_shapes(b: int) -> list[tuple[int, int]]:
    """(rows, lanes) of every round of a protocol over b batches, rows
    whose half is not a multiple of 32, then the in-word rounds."""
    live = [(b >> k, 32) for k in range(b.bit_length() - 1)]
    live += [(r, 32) for r in (6, 26, 70, b - 2) if 2 <= r < b]
    return live + [(1, 32 >> k) for k in range(6)]


@pytest.mark.parametrize("num_vars,comp", [
    (8, 2), (8, 3), (8, 4), (8, 8), (10, 2), (10, 3), (10, 4), (10, 8),
    (12, 2)])
def test_point_outer_round_matches_round_plain(num_vars, comp):
    b = (1 << num_vars) // 32
    state = _words(100 + num_vars + comp, (comp, b, 128))
    x = to_torch(state)
    for rows, lanes in _live_shapes(b):
        got = round_model(x, rows, comp + 1, lanes)
        assert torch.equal(got, cr.round_plain(x, rows, comp + 1, lanes)), (
            rows, lanes)
        if rows == b:                   # round_emulate takes full batches
            want = np.asarray(pr_jax.round_emulate(
                jnp.asarray(state), num_points=comp + 1))
            assert np.array_equal(to_numpy(got), want)
