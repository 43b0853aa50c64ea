"""The 32x32 bit transpose's lane mappings and bitslice_lane_groups' tiling,
on the CPU.

csrc/transpose32.cuh runs the Hacker's Delight ladder in two mappings:
``lanes4`` (four consecutive words of a group in a lane, stages 16, 8, 4
between lanes by shuffle, stages 2, 1 in the thread) and ``in_thread`` (all
32 words of a group in one thread, at a stride).  csrc/bitslice_lane_groups.cu
gives a warp one 128-word row as its tile (one 16-byte load a lane) and walks
the rows grid-stride, TILES rows a warp at a time, on as many blocks as fit
on the card.  These tests model both mappings and the tiling in numpy and
hold them to the JAX package's ``additive._bitslice_lane_groups`` and to
``cuda_fused32.bitslice_lane_groups_plain``, and check that the grid the
launcher forms covers every row exactly once.  Inputs are numpy-seeded
random words; every comparison is exact (word equality).  The kernel
itself runs in tests/test_torch_cuda.py on the card.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from binius_ntt_tpu.ntt import additive as additive_jax
from binius_ntt_tpu_torch.ntt import cuda_fused32 as cf32
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch

CSRC = Path(cf32.__file__).resolve().parents[1] / "csrc"
KERNEL = (CSRC / "bitslice_lane_groups.cu").read_text()
HEADER = (CSRC / "transpose32.cuh").read_text()
ROWS = (1, 3, 5, (1 << 12) + 1, 1 << 17)


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


THREADS = _constant(KERNEL, "THREADS")
TILES = _constant(KERNEL, "TILES")
WARPS = THREADS // 32


def _mask(j: int) -> np.uint32:
    """transpose32::mask, read from the header."""
    found = re.search(rf"j == {j}\s*\? (0x[0-9A-Fa-f]+)u", HEADER)
    return np.uint32(int(found.group(1), 16) if found else 0x55555555)


def swap(lo, hi, j):
    """transpose32::swap: lo's index has bit j clear."""
    t = ((lo >> np.uint32(j)) ^ hi) & _mask(j)
    return lo ^ (t << np.uint32(j)), hi ^ t


def exchange(x, y, upper, j):
    """transpose32::exchange: x this lane's word, y its partner's."""
    m, s = _mask(j), np.uint32(j)
    return np.where(upper, x ^ (((y >> s) ^ x) & m),
                    x ^ ((((x >> s) ^ y) & m) << s))


def lanes4(v: np.ndarray) -> np.ndarray:
    """transpose32::lanes4 on (..., 32 lanes, 4) words: lane l holds words
    4 (l % 8) + q of group l / 8."""
    lane = np.arange(32)
    for j in (16, 8, 4):
        d = j // 4
        upper = ((lane & d) != 0)[:, None]
        v = exchange(v, v[..., lane ^ d, :], upper, j)
    w = [v[..., q] for q in range(4)]
    w[0], w[2] = swap(w[0], w[2], 2)
    w[1], w[3] = swap(w[1], w[3], 2)
    w[0], w[1] = swap(w[0], w[1], 1)
    w[2], w[3] = swap(w[2], w[3], 1)
    return np.stack(w, axis=-1)


def in_thread(w: np.ndarray, stride: int, offset: int = 0) -> np.ndarray:
    """transpose32::in_thread<stride> on w + offset: the group's word i at
    w[..., offset + i * stride]; the other words are left as they are."""
    w = w.copy()
    for j in (16, 8, 4, 2, 1):
        lo = np.array([i for i in range(32) if not i & j])
        ilo, ihi = offset + lo * stride, offset + (lo + j) * stride
        w[..., ilo], w[..., ihi] = swap(w[..., ilo], w[..., ihi], j)
    return w


def tiled(x: np.ndarray) -> np.ndarray:
    """The kernel on (R, 128) rows: a warp's tile is one row, lane l's
    16-byte vector words 4l .. 4l + 3."""
    return lanes4(x.reshape(-1, 32, 4)).reshape(x.shape)


def grid(rows: int, sms: int, per_sm: int) -> int:
    """bntt_bitslice_lane_groups' blocks: as many as the rows need, at most
    what fits on the card at once."""
    needed = -(-rows // (WARPS * TILES))
    return min(needed, sms * per_sm)


def visits(rows: int, blocks: int) -> np.ndarray:
    """How often the kernel's loop loads each row: warp w of block b takes
    rows r0 .. r0 + TILES - 1, r0 = (b * WARPS + w) * TILES, then r0 +
    blocks * WARPS * TILES, ..., skipping rows past the end."""
    count = np.zeros(rows, dtype=np.int64)
    stride = blocks * WARPS * TILES
    for warp in range(blocks * WARPS):
        for r0 in range(warp * TILES, rows, stride):
            live = np.arange(r0, min(r0 + TILES, rows))
            count[live] += 1
    return count


def _rows(rows: int) -> np.ndarray:
    rng = np.random.default_rng(0x7532 + rows)
    return rng.integers(0, 1 << 32, (rows, 128), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _jax_lane_groups(rows: int) -> np.ndarray:
    return np.asarray(additive_jax._bitslice_lane_groups(
        jnp.asarray(_rows(rows))))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("mapping", ["lanes4", "in_thread"])
def test_mapping_matches_jax_and_plain(mapping, rows):
    x = _rows(rows)
    if mapping == "lanes4":
        got = tiled(x)
    else:
        got = in_thread(x.reshape(-1, 32), 1).reshape(x.shape)
    assert np.array_equal(got, _jax_lane_groups(rows))
    plain = to_numpy(cf32.bitslice_lane_groups_plain(to_torch(x)))
    assert np.array_equal(got, plain.astype(np.uint32))


@pytest.mark.parametrize("rows", ROWS[:4])
def test_tiling_is_its_own_inverse(rows):
    x = _rows(rows)
    assert np.array_equal(tiled(tiled(x)), x)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_in_thread_at_a_stride_transposes_each_limb(stride):
    """mul_compact's use: limb c of 32 elements at w[e * stride + c] goes
    to planes 32 c .. 32 c + 31 at w[p * stride + c], each limb alone."""
    rng = np.random.default_rng(40 + stride)
    w = rng.integers(0, 1 << 32, (7, 32 * stride), dtype=np.uint32)
    got = w
    for c in range(stride):
        got = in_thread(got, stride, c)
    for c in range(stride):
        limb = w[:, c::stride]
        assert np.array_equal(got[:, c::stride],
                              _jax_transpose_groups(limb))


def _jax_transpose_groups(words: np.ndarray) -> np.ndarray:
    """The JAX function on (n, 32) groups, as a (n / 4, 128) array padded
    to whole rows."""
    n = words.shape[0]
    pad = np.zeros(((n + 3) // 4 * 4, 32), dtype=np.uint32)
    pad[:n] = words
    out = np.asarray(additive_jax._bitslice_lane_groups(
        jnp.asarray(pad.reshape(-1, 128))))
    return out.reshape(-1, 32)[:n]


def test_in_thread_bit_convention():
    """Bit j of output word p is bit p of input word j, little-endian."""
    x = np.zeros(32, dtype=np.uint32)
    x[3] = np.uint32(1 << 17)           # bit 17 of word 3
    out = in_thread(x[None], 1)[0]
    want = np.zeros(32, dtype=np.uint32)
    want[17] = np.uint32(1 << 3)
    assert np.array_equal(out, want)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("sms,per_sm", [(132, 8), (2, 1), (1, 1)])
def test_grid_covers_every_row_once(rows, sms, per_sm):
    blocks = grid(rows, sms, per_sm)
    assert 1 <= blocks <= sms * per_sm
    assert np.all(visits(rows, blocks) == 1)


def test_kernel_uses_the_shared_header():
    assert '#include "transpose32.cuh"' in KERNEL
    assert "transpose32::lanes4" in KERNEL
    assert THREADS % 32 == 0
    assert TILES >= 1
