"""mul_tiles' design on the CPU: the GF(2^128) product as nine GF(2^32)
leaves spread over the warps of a block.

csrc/mul_tiles.cu gives persistent blocks of nine warps tiles of ROWS = 32
rows (tiles blockIdx.x, + gridDim.x, ...), one barrier a tile.  After it
the six combining warps (w % 4 != 0) fetch the next tile with 16-byte
copies into the other half of a double buffer, chunk k of tile row r at
slot r CPR + (k ^ (r % 8)).  Warp w makes leaf LEAF_OF_WARP(w) for the
tile's rows, lane = row: the XOR of a's 32-plane chunks in GROUPED[l]
(csrc/tower_leaf32.cuh) times the same XOR of b's; it stores the product
P_l, alpha P_l where ALPHA_LEAVES says and alpha^2 P_7 into this tile's
half of double-buffered leaf vectors, vector v plane i of row r at
(v 32 + i) VSTRIDE + r.  The combining warps then form the previous tile's
rows from the other half: lane i XORs the vectors COMBINE(c) names into
plane i of output chunk c; every warp combines the last tile after the
loop.  These tests model that in torch, in the kernel's order, with the
constants read from the sources, and hold it word for word to
``mul_tiles_plain``, to the JAX package's ``fields.bitsliced.multiply`` at
height 7 and to its Pallas ``mul_tiles`` kernel body; they check every
shared-memory access of the schedule for bank conflicts, and the walk, the
copies and the combine for cover.  Inputs are numpy-seeded random words.
The kernel itself runs in tests/test_torch_cuda.py on the card.
"""

import re
from functools import reduce
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.fields import bitsliced as bs_jax
from binius_ntt_tpu.ntt import pallas_kernels as pk_jax
from binius_ntt_tpu_torch.fields import bitsliced
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch

CSRC = Path(ck.__file__).resolve().parents[1] / "csrc"
KERNEL = (CSRC / "mul_tiles.cu").read_text()
LEAVES = (CSRC / "tower_leaf32.cuh").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr (?:int|uint32_t) {name} = (\w+);",
                         KERNEL).group(1), 0)


ROWS = _const("ROWS")
VSTRIDE = ROWS + 1
assert "constexpr int VSTRIDE = ROWS + 1;" in KERNEL
ALPHA_LEAVES = _const("ALPHA_LEAVES")
ALPHA2_LEAF = _const("ALPHA2_LEAF")
GROUPED = [int(v, 0) for v in re.search(
    r"GROUPED\[N_LEAF\] = \{([^}]*)\}", LEAVES).group(1).split(",")]
N_LEAF = len(GROUPED)
WARPS = N_LEAF                          # constexpr int WARPS = leaf32::N_LEAF
THREADS = 32 * WARPS
COMBINING = [w for w in range(WARPS) if w % 4]
N_VEC = 2 * N_LEAF + 1
COMBINE = [int(v, 0) for v in re.findall(
    r"(0x[0-9A-Fa-f]+)u", KERNEL[KERNEL.index("COMBINE(int c)"):][:200])]
# LEAF_OF_WARP's ternary chain, "w == 0 ? 3 : ..." with w itself last
_PAIRS = dict((int(w), int(leaf)) for w, leaf in re.findall(
    r"w == (\d+) \? (\d+)",
    KERNEL[KERNEL.index("LEAF_OF_WARP(int w)"):][:200]))
LEAF_OF_WARP = [_PAIRS.get(w, w) for w in range(WARPS)]
W, C32 = 128, 32
CPR = W // 4                            # 16-byte chunks of a row
TILE = ROWS * CPR
SMEM_LIMIT = 232448                     # a block's shared memory on an H100
SIZES = (1, 31, 32, 33, 1024)
# the JAX multiply, jitted: op by op it takes ~5 s a shape on the CPU
JAX_MUL = jax.jit(bs_jax.multiply, static_argnums=2)


def combiner(w: int) -> int:
    """0..5 for the combining warps (the kernel's combiner())."""
    return (w // 4) * 3 + w % 4 - 1


def slot(r: int, k: int) -> int:
    return r * CPR + (k ^ (r & 7))


SLOTS = torch.tensor([slot(q // CPR, q % CPR) for q in range(TILE)])


def vec_word(v: int, i: int, r: int) -> int:
    return (v * C32 + i) * VSTRIDE + r


def alpha(x: torch.Tensor) -> torch.Tensor:
    return bitsliced.multiply_alpha(x, 5)


def gather(chunks: torch.Tensor, subset: int) -> torch.Tensor:
    """XOR of the 32-plane chunks in ``subset`` over (rows, 4, 32)."""
    out = torch.zeros_like(chunks[:, 0])
    for c in range(4):
        if (subset >> c) & 1:
            out ^= chunks[:, c]
    return out


def fetch_chunks(t: int, n: int) -> list[int]:
    """The chunks q of tile t each thread copies, in thread order: thread
    (w, lane) of a combining warp takes q = combiner(w) 32 + lane, + 192,
    ... below the tile's live chunks."""
    chunks = min(n - t * ROWS, ROWS) * CPR
    return [q for w in COMBINING for lane in range(32)
            for q in range(combiner(w) * 32 + lane, chunks,
                           len(COMBINING) * 32)]


def fetch(x: torch.Tensor, t: int, n: int) -> torch.Tensor:
    """Tile t's copy-in: (TILE, 4) slots, chunk q of the tile at its slot;
    the slots of rows past n are never written (-1 stands for whatever the
    buffer held)."""
    tile = torch.full((TILE, 4), -1, dtype=torch.int32)
    q = torch.tensor(fetch_chunks(t, n), dtype=torch.long)
    tile[SLOTS[q]] = x.reshape(-1, 4)[t * TILE + q]
    return tile


def leaves(tile_a: torch.Tensor, tile_b: torch.Tensor) -> torch.Tensor:
    """Step 2 on one tile: its half of the leaf vectors, (N_VEC * 32 *
    VSTRIDE,) words (-1 where no warp stores)."""
    order = torch.tensor([[slot(r, k) for k in range(CPR)]
                          for r in range(ROWS)])
    # lane r reads row r's chunks from their slots (gather in the kernel)
    rows_a = tile_a[order].reshape(ROWS, 4, C32)
    rows_b = tile_b[order].reshape(ROWS, 4, C32)
    buf = torch.full((N_VEC * C32 * VSTRIDE,), -1, dtype=torch.int32)
    r, i = torch.meshgrid(torch.arange(ROWS), torch.arange(C32),
                          indexing="ij")

    def store(v: int, p: torch.Tensor) -> None:
        buf[(v * C32 + i) * VSTRIDE + r] = p

    for warp in range(WARPS):
        leaf = LEAF_OF_WARP[warp]
        p = bitsliced.multiply(gather(rows_a, GROUPED[leaf]),
                               gather(rows_b, GROUPED[leaf]), 5)
        store(2 * leaf, p)
        if (ALPHA_LEAVES >> leaf) & 1:
            q = alpha(p)
            store(2 * leaf + 1, q)
            if leaf == ALPHA2_LEAF:
                store(N_VEC - 1, alpha(q))
    return buf


def combine_row(buf: torch.Tensor, r: int) -> torch.Tensor:
    """Step 3 for tile row r: lane i makes plane i of every chunk."""
    lanes = torch.arange(C32)
    v = [buf[(k * C32 + lanes) * VSTRIDE + r] for k in range(N_VEC)]
    return torch.cat([reduce(torch.bitwise_xor, [v[k] for k in range(N_VEC)
                                                 if (m >> k) & 1])
                      for m in COMBINE])


def combine_rows(rows: int, last: bool) -> dict[int, list[int]]:
    """The rows each warp combines: the combining warps' share of a tile
    in the loop, every warp's share of the block's last tile."""
    if last:
        return {w: list(range(w, rows, WARPS)) for w in range(WARPS)}
    return {w: list(range(combiner(w), rows, len(COMBINING)))
            for w in COMBINING}


def walk(n_tiles: int, blocks: int, block: int) -> list[tuple[int, int]]:
    """(tile, buffer) in the order block ``block`` computes them."""
    return [(t, i % 2) for i, t in enumerate(range(block, n_tiles, blocks))]


def blocks_for(n: int, sms: int, per_sm: int) -> int:
    n_tiles = (n + ROWS - 1) // ROWS
    return min(n_tiles, sms * per_sm)


def schedule(a: torch.Tensor, b: torch.Tensor, sms: int = 3,
             per_sm: int = 1) -> torch.Tensor:
    """The kernel in torch on (n, 128) int32 rows.  Each block walks its
    tiles; at each, after the barrier, the next tile is fetched into the
    other tile buffer, this tile's leaves go to its half of the leaf
    vectors and the previous tile is combined from the other half; the
    last tile is combined after the loop.  Rows nobody writes stay -1."""
    n = a.shape[0]
    out = torch.full((n, W), -1, dtype=torch.int32)
    n_tiles = (n + ROWS - 1) // ROWS
    blocks = blocks_for(n, sms, per_sm)

    def combine_tile(vecs, t, last):
        rows = min(n - t * ROWS, ROWS)
        for r in sorted(sum(combine_rows(rows, last).values(), [])):
            out[t * ROWS + r] = combine_row(vecs, r)

    for block in range(blocks):
        steps = walk(n_tiles, blocks, block)
        tiles, vecs, prev = [None, None], [None, None], None
        tiles[0] = (fetch(a, steps[0][0], n), fetch(b, steps[0][0], n))
        for k, (t, buf) in enumerate(steps):
            if k + 1 < len(steps):
                nxt = steps[k + 1][0]
                tiles[buf ^ 1] = (fetch(a, nxt, n), fetch(b, nxt, n))
            vecs[buf] = leaves(*tiles[buf])
            if prev is not None:
                combine_tile(vecs[buf ^ 1], prev, last=False)
            prev = t
        combine_tile(vecs[steps[-1][1]], prev, last=True)
    return out


def _pair(n: int):
    rng = np.random.default_rng(0x17 + n)
    return tuple(rng.integers(0, 1 << 32, (n, W), dtype=np.uint32)
                 for _ in range(2))


def _pallas_body(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """What ``pallas_kernels.mul_tiles`` computes on each (tb, 128) tile of
    its grid (tb = min(TB, n), n // tb tiles): its kernel body
    ``_mul_vmem_sl``, op by op (under a second at n = 1024).  The Pallas
    interpreter (``interpret=True``) traces the same 13,448-gate body
    into one program: at n = 32 it ran over ten minutes and past 17 GB on
    the CPU, so it is not run here."""
    n = a.shape[0]
    tb = min(pk_jax.TB, n)
    return np.concatenate([
        np.asarray(pk_jax._mul_vmem_sl(jnp.asarray(a[i:i + tb]),
                                       jnp.asarray(b[i:i + tb])))
        for i in range(0, n // tb * tb, tb)])


@pytest.mark.parametrize("n", SIZES)
def test_schedule_matches_plain_and_jax(n):
    a, b = _pair(n)
    got = to_numpy(schedule(to_torch(a), to_torch(b))).astype(np.uint32)
    plain = to_numpy(ck.mul_tiles_plain(to_torch(a), to_torch(b)))
    assert np.array_equal(got, plain.astype(np.uint32))
    want = np.asarray(JAX_MUL(jnp.asarray(a), jnp.asarray(b), 7))
    assert np.array_equal(got, want.astype(np.uint32))
    assert n <= pk_jax.TB or n % pk_jax.TB == 0   # its grid covers every row
    assert np.array_equal(got, _pallas_body(a, b).astype(np.uint32))


@pytest.mark.parametrize("sms,per_sm", [(1, 1), (2, 1), (4, 2)])
def test_schedule_on_other_grids(sms, per_sm):
    a, b = _pair(100)
    got = schedule(to_torch(a), to_torch(b), sms, per_sm)
    assert torch.equal(got, ck.mul_tiles_plain(to_torch(a), to_torch(b)))


def test_combine_is_mul_body_of_the_leaves():
    """COMBINE, applied to the nine leaf products, is tower::mul_body<7>;
    its level-6 sums are leaf32::mul_in_place's lo_g and hi_g."""
    rng = np.random.default_rng(71)
    a, b = (to_torch(rng.integers(0, 1 << 32, (6, W), dtype=np.uint32))
            for _ in range(2))
    ca, cb = a.view(6, 4, C32), b.view(6, 4, C32)
    p = [bitsliced.multiply(gather(ca, s), gather(cb, s), 5)
         for s in GROUPED]
    vec = {}
    for leaf in range(N_LEAF):
        vec[2 * leaf] = p[leaf]
        vec[2 * leaf + 1] = alpha(p[leaf])
    vec[N_VEC - 1] = alpha(vec[2 * ALPHA2_LEAF + 1])
    out = torch.cat([reduce(torch.bitwise_xor, [vec[k] for k in range(N_VEC)
                                                if (m >> k) & 1])
                     for m in COMBINE], dim=-1)
    assert torch.equal(out, bitsliced.multiply(a, b, 7))
    # zm, z0, z2 as the level-6 products of the Karatsuba
    h = {"zm": (ca[:, :2] ^ ca[:, 2:], cb[:, :2] ^ cb[:, 2:]),
         "z0": (ca[:, :2], cb[:, :2]), "z2": (ca[:, 2:], cb[:, 2:])}
    for g, name in enumerate(("zm", "z0", "z2")):
        x, y = (t.reshape(6, 2 * C32) for t in h[name])
        lo = p[3 * g] ^ p[3 * g + 1]
        hi = p[3 * g] ^ p[3 * g + 1] ^ alpha(p[3 * g + 1]) ^ p[3 * g + 2]
        assert torch.equal(torch.cat([lo, hi], -1),
                           bitsliced.multiply(x, y, 6))


def test_combine_reads_only_stored_vectors():
    stored = {2 * leaf for leaf in range(N_LEAF)}
    stored |= {2 * leaf + 1 for leaf in range(N_LEAF)
               if (ALPHA_LEAVES >> leaf) & 1}
    stored |= {N_VEC - 1}
    used = {k for m in COMBINE for k in range(N_VEC) if (m >> k) & 1}
    assert used == stored
    assert len(COMBINE) == 4 and N_VEC <= 32


def test_copies_are_free_of_bank_conflicts():
    """A quarter warp's 16-byte copies (8 consecutive chunks q of the tile,
    lanes q, q + 1, ...) land in 8 distinct 16-byte bank groups (a slot's
    group is slot % 8), and every chunk of a tile has its own slot."""
    slots = [slot(q // CPR, q % CPR) for q in range(TILE)]
    assert sorted(slots) == list(range(TILE))
    for q0 in range(0, TILE, 8):
        assert len({slots[q] % 8 for q in range(q0, q0 + 8)}) == 8
    # at every step of the copy loop a quarter warp's lanes take 8
    # consecutive chunks from a multiple of 8
    step = len(COMBINING) * 32
    for w in COMBINING:
        for lane0 in range(0, 32, 8):
            for first in range(combiner(w) * 32 + lane0, TILE, step):
                qs = [first + j for j in range(8)]
                assert first % 8 == 0
                assert len({slots[q] % 8 for q in qs}) == 8


def test_leaf_reads_are_free_of_bank_conflicts():
    """Each leaf read is one chunk (16 bytes) of the 32 rows of a warp's
    lanes: its quarter warps (8 consecutive rows) hit 8 distinct groups."""
    for k in range(CPR):
        for r0 in range(0, ROWS, 8):
            assert len({slot(r, k) % 8 for r in range(r0, r0 + 8)}) == 8


def test_leaf_stores_are_free_of_bank_conflicts():
    """A leaf store writes plane i of vector v for the 32 rows of the
    warp's lanes: 32 distinct banks; no two (v, i, r) share a word."""
    for v in range(N_VEC):
        for i in range(C32):
            assert len({vec_word(v, i, r) % 32 for r in range(ROWS)}) == 32
    words = {vec_word(v, i, r) for v in range(N_VEC) for i in range(C32)
             for r in range(ROWS)}
    assert len(words) == N_VEC * C32 * ROWS
    assert max(words) < N_VEC * C32 * VSTRIDE


def test_combine_reads_are_free_of_bank_conflicts():
    """A combine read takes plane i (the lane) of vector v of one row: 32
    distinct banks, through the stride of 33 words a plane."""
    for v in range(N_VEC):
        for r in range(ROWS):
            assert len({vec_word(v, i, r) % 32 for i in range(C32)}) == 32


@pytest.mark.parametrize("sms,per_sm", [(132, 1), (4, 1), (3, 2)])
def test_walk_covers_every_tile_once(sms, per_sm):
    """The persistent blocks' tiles, over row counts below, at and above a
    grid's worth: each tile once, and a block's consecutive tiles in
    alternate halves of its double buffers."""
    for n in (1, 31, 32, 33, 100, ROWS * sms * per_sm,
              ROWS * sms * per_sm + 5, (1 << 18) + 5):
        n_tiles = (n + ROWS - 1) // ROWS
        blocks = blocks_for(n, sms, per_sm)
        seen = []
        for block in range(blocks):
            steps = walk(n_tiles, blocks, block)
            assert steps, "a launched block with no tile"
            assert [buf for _, buf in steps] == [i % 2
                                                for i in range(len(steps))]
            seen += [t for t, _ in steps]
        assert sorted(seen) == list(range(n_tiles))


@pytest.mark.parametrize("rows", [1, 5, 31, 32])
def test_copies_and_combine_cover_a_tile_once(rows):
    """The combining warps copy every live chunk of a tile once; each live
    row is combined once, in the loop by the combining warps, after it
    by every warp."""
    n = 2 * ROWS + rows
    chunks = fetch_chunks(2, n)
    assert sorted(chunks) == list(range(rows * CPR))
    for last in (False, True):
        owned = sum(combine_rows(rows, last).values(), [])
        assert sorted(owned) == list(range(rows))


def test_leaves_go_to_warps_by_scheduler():
    """Every leaf has one warp.  Warps 0, 4 and 8 share a scheduler, so
    they take leaves with no alpha map and at most two chunks a gather,
    and they neither copy nor combine."""
    assert sorted(LEAF_OF_WARP) == list(range(N_LEAF))
    for w in range(0, WARPS, 4):
        leaf = LEAF_OF_WARP[w]
        assert not (ALPHA_LEAVES >> leaf) & 1
        assert bin(GROUPED[leaf]).count("1") <= 2
    assert sorted(combiner(w) for w in COMBINING) == list(range(6))
    assert "if (!combining) return;" in KERNEL


def test_tail_rows_stay_inside_the_operands():
    """The last tile of 2^k + 5 rows fetches only its live rows' words and
    writes only its live rows."""
    n = 3 * ROWS + 5
    a, b = _pair(n)
    got = schedule(to_torch(a), to_torch(b), sms=2)
    assert torch.equal(got, ck.mul_tiles_plain(to_torch(a), to_torch(b)))
    last = n // ROWS
    tile = fetch(to_torch(a), last, n)
    written = {slot(q // CPR, q % CPR) for q in range((n - last * ROWS) * CPR)}
    assert all((tile[s] == -1).all() for s in range(TILE) if s not in written)


def test_shared_memory_fits_one_block_an_sm():
    tiles = 2 * 2 * TILE * 16
    vecs = 2 * N_VEC * C32 * VSTRIDE * 4
    assert "constexpr int SMEM = TILES_BYTES + 2 * VEC_WORDS * 4;" in KERNEL
    assert tiles + vecs == 226048
    assert tiles + vecs <= SMEM_LIMIT < 2 * (tiles + vecs)
    assert THREADS == 288 and "__launch_bounds__(THREADS, 1)" in KERNEL


def test_kernel_takes_its_leaves_from_the_shared_header():
    assert '#include "tower_leaf32.cuh"' in KERNEL
    assert "leaf32::GROUPED[l]" in KERNEL
    assert "tower_mul32(x, y, p)" in KERNEL
    assert "tower_mul128" not in KERNEL
    assert "cudaErrorInvalidValue" in KERNEL
