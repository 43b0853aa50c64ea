"""The GF(2^128) bit-slicing kernel's lane mapping and tiling, and the
layout's dispatch, on the CPU.

csrc/bitslice128.cu gives a warp one 128-word row: for the transpose, lane
j loads element j's four words (register q = word j of group q) and
csrc/transpose32.cuh's ``lanes1`` runs all five ladder stages across lanes
(partner lane ^ J, the partner's half applied by ``rotate_select``), after
which lane p stores sliced word 32 q + p from register q; the untranspose
runs the same backwards, in place when asked.  The warps walk the rows
grid-stride, TILES rows a warp at a time, on as many blocks as fit on the
card.  These tests model the mapping and the tiling in numpy and hold them
word for word to the port's torch-op transforms and to the JAX package's
``layout.bitslicing``; they check that the grid the launcher forms covers
every row exactly once, that an in-place walk of the rows gives the
out-of-place result, and that a CPU tensor takes the torch ops and a bad
call raises.  The kernel itself runs in tests/test_torch_cuda.py on the
card.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.layout import bitslicing as jbs
from binius_ntt_tpu_torch import _build
from binius_ntt_tpu_torch.layout import bitslicing as bs
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch

CSRC = Path(bs.__file__).resolve().parents[1] / "csrc"
KERNEL = (CSRC / "bitslice128.cu").read_text()
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


def rotl(y: np.ndarray, r: np.ndarray) -> np.ndarray:
    """__funnelshift_l(y, y, r): y rotated left by r in [1, 31]."""
    r = r.astype(np.uint32)
    return (y << r) | (y >> (np.uint32(32) - r))


def rotate_select(x, y, rot, keep):
    """transpose32::rotate_select."""
    return (x & keep) | (rotl(y, rot) & ~keep)


def exchange(x, y, upper, j):
    """transpose32::exchange, the form lanes4 uses."""
    m, s = _mask(j), np.uint32(j)
    return np.where(upper, x ^ (((y >> s) ^ x) & m),
                    x ^ ((((x >> s) ^ y) & m) << s))


def lanes1(v: np.ndarray) -> np.ndarray:
    """transpose32::lanes1 on (..., 32 lanes, N) words: lane l holds word l
    of group q in register q."""
    lane = np.arange(32)
    for j in (16, 8, 4, 2, 1):
        upper = ((lane & j) != 0)[:, None]
        rot = np.where(upper, 32 - j, j)
        keep = np.where(upper, ~_mask(j), _mask(j)).astype(np.uint32)
        v = rotate_select(v, v[..., lane ^ j, :], rot, keep)
    return v


def transpose_rows(x: np.ndarray) -> np.ndarray:
    """The transpose kernel on (R, 128) compact rows: lane j's 16-byte load
    is element j's words 4 j .. 4 j + 3; lane p stores register q to
    sliced word 32 q + p."""
    v = lanes1(x.reshape(-1, 32, 4))
    return v.transpose(0, 2, 1).reshape(x.shape)


def untranspose_rows(x: np.ndarray) -> np.ndarray:
    """The untranspose kernel on (R, 128) sliced rows: lane p loads sliced
    words 32 q + p into register q; lane j stores its four registers as
    element j's words."""
    v = lanes1(x.reshape(-1, 4, 32).transpose(0, 2, 1))
    return v.reshape(x.shape)


def grid(rows: int, sms: int, per_sm: int) -> int:
    """The launcher's blocks: as many as the rows need, at most what fits
    on the card at once."""
    needed = -(-rows // (WARPS * TILES))
    return min(needed, sms * per_sm)


def warp_rows(rows: int, blocks: int):
    """The rows each pass of each warp's loop takes: warp w of block b
    takes rows r0 .. r0 + TILES - 1, r0 = (b * WARPS + w) * TILES, then r0
    + blocks * WARPS * TILES, ..., skipping rows past the end."""
    stride = blocks * WARPS * TILES
    for warp in range(blocks * WARPS):
        for r0 in range(warp * TILES, rows, stride):
            yield np.arange(r0, min(r0 + TILES, rows))


def _rows(rows: int) -> np.ndarray:
    rng = np.random.default_rng(0x128 + rows)
    return rng.integers(0, 1 << 32, (rows, 128), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _jax(direction: str, rows: int) -> np.ndarray:
    fn = (jbs.bitslice_transpose if direction == "transpose"
          else jbs.bitslice_untranspose)
    return np.asarray(fn(jnp.asarray(_rows(rows))))


@pytest.mark.parametrize("rows", ROWS)
def test_transpose_model_matches_jax_and_plain(rows):
    x = _rows(rows)
    got = transpose_rows(x)
    assert np.array_equal(got, _jax("transpose", rows))
    plain = to_numpy(bs.bitslice_transpose_plain(to_torch(x)))
    assert np.array_equal(got, plain)


@pytest.mark.parametrize("rows", ROWS)
def test_untranspose_model_matches_jax_and_plain(rows):
    x = _rows(rows)
    got = untranspose_rows(x)
    assert np.array_equal(got, _jax("untranspose", rows))
    plain = to_numpy(bs.bitslice_untranspose_plain(to_torch(x)))
    assert np.array_equal(got, plain)


@pytest.mark.parametrize("rows", ROWS[:4])
def test_model_round_trip(rows):
    x = _rows(rows)
    assert np.array_equal(untranspose_rows(transpose_rows(x)), x)
    assert np.array_equal(transpose_rows(untranspose_rows(x)), x)


@pytest.mark.parametrize("j", [16, 8, 4, 2, 1])
def test_rotate_select_is_exchange(j):
    """The two-operation stage equals the header's exchange on both sides
    of the pair, for random words."""
    rng = np.random.default_rng(j)
    x, y = rng.integers(0, 1 << 32, (2, 4096), dtype=np.uint32)
    for upper in (False, True):
        rot = np.full(x.shape, 32 - j if upper else j)
        keep = ~_mask(j) if upper else _mask(j)
        assert np.array_equal(rotate_select(x, y, rot, keep),
                              exchange(x, y, upper, j))


def test_lanes1_bit_convention():
    """Bit j of output word p is bit p of input word j, in every group."""
    v = np.zeros((32, 4), dtype=np.uint32)
    v[3, 2] = np.uint32(1 << 17)        # bit 17 of word 3 of group 2
    want = np.zeros((32, 4), dtype=np.uint32)
    want[17, 2] = np.uint32(1 << 3)
    assert np.array_equal(lanes1(v), want)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("sms,per_sm", [(132, 8), (2, 1), (1, 1)])
def test_grid_covers_every_row_once(rows, sms, per_sm):
    blocks = grid(rows, sms, per_sm)
    assert 1 <= blocks <= sms * per_sm
    count = np.zeros(rows, dtype=np.int64)
    for live in warp_rows(rows, blocks):
        count[live] += 1
    assert np.all(count == 1)


@pytest.mark.parametrize("rows", ROWS[:4])
@pytest.mark.parametrize("sms,per_sm", [(132, 8), (1, 1)])
def test_in_place_walk_matches_out_of_place(rows, sms, per_sm):
    """The untranspose on one buffer, warp pass by warp pass as the grid
    walks it (each pass reads its rows whole, then writes them), gives the
    out-of-place result."""
    x = _rows(rows)
    buf = x.copy()
    for live in warp_rows(rows, grid(rows, sms, per_sm)):
        buf[live] = untranspose_rows(buf[live])
    assert np.array_equal(buf, untranspose_rows(x))


def _no_kernel(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor must not reach the kernel")
    monkeypatch.setattr(_build, "library", refuse)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
@pytest.mark.parametrize("w", [32, 64, 128])
def test_cpu_tensor_takes_the_torch_ops(monkeypatch, lead, w):
    _no_kernel(monkeypatch)
    before = (bs.bitslice_transpose.launches, bs.bitslice_untranspose.launches)
    rng = np.random.default_rng(w + len(lead))
    x = to_torch(rng.integers(0, 1 << 32, lead + (w,), dtype=np.uint32))
    sliced = bs.bitslice_transpose(x)
    assert torch.equal(sliced, bs.bitslice_transpose_plain(x))
    assert np.array_equal(to_numpy(sliced),
                          np.asarray(jbs.bitslice_transpose(to_numpy(x))))
    back = bs.bitslice_untranspose(sliced)
    assert torch.equal(back, x)
    assert (bs.bitslice_transpose.launches,
            bs.bitslice_untranspose.launches) == before


@pytest.mark.parametrize("view", ["whole", "rows", "strided"])
def test_cpu_untranspose_into_out(monkeypatch, view):
    """out= on the CPU: in place, into another tensor, into a view."""
    _no_kernel(monkeypatch)
    x = to_torch(_rows(8))
    sliced = bs.bitslice_transpose(x)
    if view == "whole":
        buf = sliced.clone()
        assert bs.bitslice_untranspose(buf, out=buf) is buf
        assert torch.equal(buf, x)
    elif view == "rows":
        buf = sliced.clone()
        for i in range(0, 8, 4):
            bs.bitslice_untranspose(buf[i:i + 4], out=buf[i:i + 4])
        assert torch.equal(buf, x)
    else:
        dst = torch.zeros(16, 128, dtype=torch.int32)[::2]
        assert bs.bitslice_untranspose(sliced, out=dst) is dst
        assert torch.equal(dst, x)


@pytest.mark.parametrize("fn", [bs.bitslice_transpose,
                                bs.bitslice_untranspose])
def test_bad_calls_raise(fn):
    x = torch.zeros(2, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        fn(x.long())
    with pytest.raises(ValueError, match="int32"):
        fn(to_numpy(x))
    with pytest.raises(ValueError, match="multiple of 32"):
        fn(torch.zeros(2, 48, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 32"):
        fn(torch.zeros(2, 0, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 32"):
        fn(torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros(2, 128, dtype=torch.int32, device="meta"))


def test_untranspose_refuses_a_bad_out():
    x = torch.zeros(2, 128, dtype=torch.int32)
    for out in (torch.zeros(4, 128, dtype=torch.int32),
                torch.zeros(2, 128, dtype=torch.int64),
                torch.zeros(2, 128, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="out must be"):
            bs.bitslice_untranspose(x, out=out)


def test_kernel_is_built_and_uses_the_shared_header():
    assert '#include "transpose32.cuh"' in KERNEL
    assert KERNEL.count("transpose32::lanes1(") == 2
    assert "lanes1" in HEADER and "rotate_select" in HEADER
    for entry in ("bntt_bitslice128_transpose",
                  "bntt_bitslice128_untranspose"):
        assert f'extern "C" int {entry}(' in KERNEL
        assert _build._SIGNATURES[entry] == (_build._P, _build._P,
                                             _build._L, _build._P)
    assert THREADS % 32 == 0 and TILES >= 1
    # the in-place kernel's pointers may alias
    body = KERNEL[KERNEL.index("bitslice128_untranspose_kernel("):]
    assert "__restrict__" not in body[:body.index(")")]
