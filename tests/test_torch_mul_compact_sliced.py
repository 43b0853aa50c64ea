"""mul_compact's bit-sliced design, on the CPU.

csrc/mul_compact.cu gives each thread a batch of 32 consecutive elements and
a block a tile of THREADS batches.  The tile's rows (a batch's 32 NL words)
come into shared memory through 16-byte copies that fill zeros past the last
element, chunk k of row r at slot k ^ (r % 8); a thread transposes limb c
of its 32 elements into planes 32 c .. 32 c + 31 (transpose32::in_thread at
stride NL), multiplies bit-sliced (one GF(2^32) leaf at height 5, z0's three
leaves of csrc/tower_leaf32.cuh at height 6, all nine in place at height 7),
transposes back and the live words are stored.  These tests model that in
torch, in the kernel's order, and hold it to the JAX package's
``tower_compact.mul_compact``, to the port's ``mul_compact`` and, on the
reference's 128-bit vector, to the scalar oracle; and they check the slot
map for coverage and bank conflicts.  Inputs are numpy-seeded random words;
every comparison is exact (word equality).  The kernel itself runs in
tests/test_torch_cuda.py on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.fields import tower_compact as tc_jax
from binius_ntt_tpu_torch import tower_compact as tc
from binius_ntt_tpu_torch.fields import bitsliced
from binius_ntt_tpu_torch.fields import tower_scalar as ts
from binius_ntt_tpu_torch.utils.bits import lsr, to_numpy, to_torch

CSRC = Path(tc.__file__).resolve().parents[1] / "csrc"
KERNEL = (CSRC / "mul_compact.cu").read_text()
LEAVES = (CSRC / "tower_leaf32.cuh").read_text()
THREADS = int(re.search(r"constexpr int THREADS = (\d+);", KERNEL).group(1))
GROUPED = [int(v, 0) for v in re.search(
    r"GROUPED\[N_LEAF\] = \{([^}]*)\}", LEAVES).group(1).split(",")]
MASKS = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333,
         1: 0x55555555}
SIZES = (1, 31, 32, 33, 1000)


def leaf_range(height: int) -> range:
    """mul_in_place's leaves at a height, read from the header."""
    found = re.search(r"constexpr int FIRST = H == 7 \? (\d+) : (\d+), "
                      r"LAST = H == 7 \? (\w+) : (\d+);", LEAVES)
    first7, first6, last7, last6 = found.groups()
    if height == 7:
        return range(int(first7), len(GROUPED) if last7 == "N_LEAF"
                     else int(last7))
    return range(int(first6), int(last6))


def slot(r: int, k: int, cpr: int) -> int:
    return r * cpr + (k ^ (r & 7))


def in_thread(w: torch.Tensor, stride: int, offset: int) -> torch.Tensor:
    """transpose32::in_thread<stride> on w + offset over (..., words)."""
    w = w.clone()
    for j in (16, 8, 4, 2, 1):
        lo = torch.tensor([i for i in range(32) if not i & j])
        ilo, ihi = offset + lo * stride, offset + (lo + j) * stride
        x, y = w[..., ilo], w[..., ihi]
        t = (lsr(x, j) ^ y) & MASKS[j]
        w[..., ilo], w[..., ihi] = x ^ (t << j), y ^ t
    return w


def transpose_limbs(w: torch.Tensor, nl: int) -> torch.Tensor:
    for c in range(nl):
        w = in_thread(w, nl, c)
    return w


def registers_to_planes(w: torch.Tensor, nl: int) -> torch.Tensor:
    """Plane 32 c + p from register p nl + c (store_planes)."""
    p = torch.arange(32 * nl)
    return w[..., (p % 32) * nl + p // 32]


def planes_to_registers(s: torch.Tensor, nl: int) -> torch.Tensor:
    """Register p nl + c from plane 32 c + p (load_planes)."""
    i = torch.arange(32 * nl)
    return s[..., 32 * (i % nl) + i // nl]


def gather(planes: torch.Tensor, subset: int) -> torch.Tensor:
    out = torch.zeros_like(planes[..., :32])
    for c in range(planes.shape[-1] // 32):
        if (subset >> c) & 1:
            out ^= planes[..., 32 * c:32 * c + 32]
    return out


def mul_in_place(a: torch.Tensor, b: torch.Tensor, height: int) -> torch.Tensor:
    """leaf32::mul_in_place<STRIDE, H> over (..., 32 NL) planes, in its
    loop order: each level-6 product's three leaves summed in r, zm to the
    scratch t, z0 over chunks 0 and 1 of a, z2 and the combine over all
    four."""
    a = a.clone()
    r = t = None

    def alpha(x):
        return bitsliced.multiply_alpha(x, 5)

    for leaf in leaf_range(height):
        g, k = leaf // 3, leaf % 3
        p = bitsliced.multiply(gather(a, GROUPED[leaf]),
                               gather(b, GROUPED[leaf]), 5)
        if k == 0:
            r = [p, p]
        elif k == 1:
            r = [r[0] ^ p, r[1] ^ p ^ alpha(p)]
        else:
            r = [r[0], r[1] ^ p]
            if g == 0:
                t = r
            elif g == 1:
                a[..., :32], a[..., 32:64] = r
            else:
                p1 = alpha(r[1])
                c0, c1 = a[..., :32] ^ r[0], a[..., 32:64] ^ r[1]
                a[..., 64:96] = t[0] ^ c0 ^ r[1]
                a[..., 96:128] = t[1] ^ c1 ^ r[0] ^ p1
                a[..., :32], a[..., 32:64] = c0, c1
    return a


def stage(x: torch.Tensor, tile: int, live: int, cpr: int) -> torch.Tensor:
    """The copy-in of tile ``tile``: (THREADS rows, 4 cpr words), chunk q
    of the tile at its slot, its words past ``live`` zero."""
    rows = torch.full((THREADS * cpr, 4), -1, dtype=torch.int32)
    flat = x.reshape(-1)
    w0 = tile * THREADS * cpr * 4
    for q in range(THREADS * cpr):
        n = min(max(live - 4 * q, 0), 4)
        words = torch.zeros(4, dtype=torch.int32)
        words[:n] = flat[w0 + 4 * q:w0 + 4 * q + n]
        rows[slot(q // cpr, q % cpr, cpr)] = words
    return rows


def sliced_model(a: torch.Tensor, b: torch.Tensor,
                 height: int) -> torch.Tensor:
    """The kernel in torch on (n, NL) int32 limbs."""
    n, nl = a.shape
    cpr = 8 * nl
    per = THREADS * 32                  # elements of a tile
    out = torch.full((n * nl,), -1, dtype=torch.int32)
    for tile in range((n + per - 1) // per):
        live = min(n * nl - tile * per * nl, per * nl)
        slots_a, slots_b = (stage(x, tile, live, cpr) for x in (a, b))
        # row t of the tile, thread t's registers (read_row)
        order = torch.tensor([[slot(t, k, cpr) for k in range(cpr)]
                              for t in range(THREADS)])
        wa = slots_a[order].reshape(THREADS, 32 * nl)
        wb = slots_b[order].reshape(THREADS, 32 * nl)
        wa, wb = transpose_limbs(wa, nl), transpose_limbs(wb, nl)
        if height == 5:
            prod = bitsliced.multiply(wa, wb, 5)
        else:
            prod = planes_to_registers(mul_in_place(
                registers_to_planes(wa, nl), registers_to_planes(wb, nl),
                height), nl)
        rows = transpose_limbs(prod, nl).reshape(-1)
        # rows go back to their slots and the live words out
        back = torch.zeros(THREADS * cpr, 4, dtype=torch.int32)
        back[order.reshape(-1)] = rows.reshape(-1, 4)
        for q in range(THREADS * cpr):
            m = min(max(live - 4 * q, 0), 4)
            w = tile * per * nl + 4 * q
            out[w:w + m] = back[slot(q // cpr, q % cpr, cpr)][:m]
    return out.reshape(n, nl)


def _pair(height: int, n: int):
    rng = np.random.default_rng(0x3C0 + 7 * height + n)
    nl = 1 << (height - 5)
    return tuple(rng.integers(0, 1 << 32, (n, nl), dtype=np.uint32)
                 for _ in range(2))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("height", [5, 6, 7])
def test_sliced_model_matches_jax_and_port(height, n):
    a, b = _pair(height, n)
    got = to_numpy(sliced_model(to_torch(a), to_torch(b), height))
    want = np.asarray(tc_jax.mul_compact(jnp.asarray(a), jnp.asarray(b),
                                         height))
    assert np.array_equal(got.astype(np.uint32), want.reshape(got.shape))
    port = to_numpy(tc.mul_compact(to_torch(a), to_torch(b), height))
    assert np.array_equal(got, port.reshape(got.shape))


def test_sliced_model_on_the_reference_128bit_vector():
    a = 0x0123456789ABCDEF0011223344556677
    b = 0xFEDCBA9876543210AABBCCDDEEFF0099
    la, lb = (to_torch(np.frombuffer(v.to_bytes(16, "little"),
                                     dtype=np.uint32).reshape(1, 4))
              for v in (a, b))
    got = to_numpy(sliced_model(la, lb, 7))[0].astype("<u4").tobytes()
    assert int.from_bytes(got, "little") == ts.multiply(a, b, 7)


@pytest.mark.parametrize("height", [6, 7])
def test_leaf_range_is_mul_body(height):
    """The in-place product on planes equals the port's bit-sliced tower
    multiply at GF(2^64) and GF(2^128)."""
    rng = np.random.default_rng(60 + height)
    w = 1 << height
    a, b = (to_torch(rng.integers(0, 1 << 32, (5, w), dtype=np.uint32))
            for _ in range(2))
    assert torch.equal(mul_in_place(a, b, height),
                       bitsliced.multiply(a, b, height))
    assert list(leaf_range(height)) == ([3, 4, 5] if height == 6
                                        else list(range(9)))


@pytest.mark.parametrize("height", [5, 6, 7])
def test_slots_cover_the_tile_without_bank_conflicts(height):
    """Every chunk of the tile has its own slot; 8 lanes that copy 8
    consecutive chunks, or read one chunk of 8 consecutive rows, hit 8
    distinct 16-byte bank groups (a slot's group is slot % 8)."""
    cpr = 8 << (height - 5)
    slots = [slot(q // cpr, q % cpr, cpr) for q in range(THREADS * cpr)]
    assert sorted(slots) == list(range(THREADS * cpr))
    for q0 in range(0, THREADS * cpr, 8):
        assert len({slots[q] % 8 for q in range(q0, q0 + 8)}) == 8
    for k in range(cpr):
        for t0 in range(0, THREADS, 8):
            assert len({slot(t, k, cpr) % 8 for t in range(t0, t0 + 8)}) == 8


def test_kernel_takes_its_product_from_the_shared_headers():
    assert '#include "tower_leaf32.cuh"' in KERNEL
    assert '#include "transpose32.cuh"' in KERNEL
    assert "leaf32::mul_in_place<THREADS, H>" in KERNEL
    assert "transpose32::in_thread<NL>" in KERNEL
    assert "tower_simd" not in KERNEL
