"""Stage-group kernel of the radix-2 BB31 NTT.

Port of binius_ntt_tpu/ntt/pallas_fused_bb31.py.  ``stage_group_r2``
launches the kernel of csrc/stage_group_r2.cu, ``stage_group_r2_plain`` is
the same function in plain torch, and ``apply_fused_r2`` chains the groups
of a plan.

A group runs the DIF stages s0 .. s0+k-1 (gpuntt.cuh:65-124) on the flat
(n,) array of Montgomery words, in place: at stage s the pairs are
(x[b*2^(s+1) + j], x[b*2^(s+1) + 2^s + j]) with twiddle w = tw[b] from the
bit-reversed (n/2,) table, and the butterfly is U = u + v, V = (u - v)*w.
Stages ascend, so the first group covers the low index bits.  Options:
``encode_in`` (Montgomery-encode the canonical input first; the first
group), ``decode_out`` (decode the result; the last group) and ``src``
(read the input from ``src`` in bit-reversed order, the transform's
IN_ORDER input permutation, gpuntt.cuh:163-168; the first group, out of
place).  The reference bit-reverses with a gather outside its kernels; the
port folds the permutation into the first group's loads, as the upstream
CUDA does, and saves a pass over the array; the kernel's blocks take their
tiles in bit-reversed order there, so that blocks in flight together share
the 32-byte sectors of their scattered loads.

The TPU kernel's split into 7 lane stages and row stages, and its
host-expanded lane-twiddle planes (7n words), follow from Mosaic's layout
rules.  On the card a block holds a tile of 2^k rows by 2^c consecutive
columns (``tile_columns``) in shared memory, at most 2^TILE_LOG words, and
runs the group's k stages in rounds (``group_rounds``): in round q a thread
holds the 2^r words whose tile rows differ only in the round's r row bits,
runs the round's r stages on them in registers and writes them back, with
one barrier a round.  The twiddles a block needs are a few contiguous
slices of the table, staged in shared memory at its start.  The plan
(``plan_groups_r2``) cuts the log_n stages into a first group of at most
KB stages and upper groups of at most KU, as even as that allows.

``launch_r2`` is the launch the kernel gets for a group, and
``round_words``, ``round_twiddles`` and ``tile_slot`` model its index maps
(the tile words a thread holds in a round, the twiddle each of its
butterflies reads, the shared-memory word of a tile word), so that the CPU
tests can run the kernel's schedule in numpy and hold it to
``stage_group_r2_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..fields import baby_bear as bb

__all__ = ["KB", "KU", "TILE_LOG", "COLS_LOG", "MIN_TILE_LOG",
           "GATHER_COLS_LOG", "ROUND_LOG", "MAX_THREADS", "SMEM_LIMIT",
           "plan_groups_r2", "tile_columns", "group_rounds",
           "block_threads", "smem_bytes", "async_tile", "launch_r2",
           "tile_bases", "row_blocks", "tile_slot", "round_words",
           "global_index", "twiddle_slots", "round_twiddles",
           "bit_reverse_indices", "stage_group_r2", "stage_group_r2_plain",
           "apply_fused_r2"]

# A block's tile holds at most 2^TILE_LOG words (128 KB of shared memory).
# The first group takes 2^k rows of 2^GATHER_COLS_LOG row blocks when it
# gathers (else one); an upper group takes 2^k rows of 2^c consecutive
# columns: 2^COLS_LOG (64 bytes, two sectors), or more for a tile of
# 2^MIN_TILE_LOG words, where the tile and the row block have room.  Any
# plan gives identical output bits.  KB = KU = 12 and GATHER_COLS_LOG = 1
# won the sweeps at 2^24 and 2^27 (tools/torch_stage_group_r2_ab.py).
TILE_LOG = 15
KB = 12
KU = 12
COLS_LOG = 4
MIN_TILE_LOG = 12
GATHER_COLS_LOG = 1
# a thread runs at most ROUND_LOG stages in registers between exchanges
ROUND_LOG = 4
MAX_THREADS = 1024
# shared memory a block of this card can have (227 KB)
SMEM_LIMIT = 232448


def plan_groups_r2(log_n: int) -> list[tuple[int, int]]:
    """Split the stages 0 .. log_n-1 into (s0, k) groups, in execution
    order (DIF ascends): a first group of min(log_n, KB) stages, then as
    few upper groups of at most KU stages as cover the rest, their sizes
    as even as possible (larger first)."""
    k0 = min(log_n, KB)
    groups = [(0, k0)]
    rest = log_n - k0
    n_up = -(-rest // KU)
    s0 = k0
    for i in range(n_up):
        k = rest // n_up + (i < rest % n_up)
        groups.append((s0, k))
        s0 += k
    return groups


def tile_columns(s0: int, k: int, log_n: int, gather: bool = True) -> int:
    """log2 of the columns a block of the kernel takes for the group (s0, k)
    of a 2^log_n transform.  An upper group's are consecutive words of its
    row block: at least 2^COLS_LOG and enough for a 2^MIN_TILE_LOG-word
    tile, within the tile's 2^TILE_LOG words and the row block's 2^s0
    columns.  A first group that gathers its input bit-reversed (the main
    path's, and the one the model below describes) takes 2^GATHER_COLS_LOG
    row blocks whose rows' sources are consecutive words (``row_blocks``);
    one that does not, one row block."""
    if s0 == 0:
        return max(min(GATHER_COLS_LOG if gather else 0, TILE_LOG - k,
                       log_n - k), 0)
    want = max(COLS_LOG, MIN_TILE_LOG - k)
    return max(min(want, s0, TILE_LOG - k), 0)


def group_rounds(k: int) -> list[int]:
    """The stages of each round of a k-stage group: as few rounds of at
    most ROUND_LOG stages as cover k, as even as possible, larger first."""
    n = -(-k // ROUND_LOG)
    return [k // n + (i < k % n) for i in range(n)]


def block_threads(s0: int, k: int, log_n: int, gather: bool = True) -> int:
    """Threads of a block: one for each register group of the group's
    largest round, at most MAX_THREADS (a thread then takes several)."""
    big_k = k + tile_columns(s0, k, log_n, gather)
    return min(1 << (big_k - max(group_rounds(k))), MAX_THREADS)


def smem_bytes(s0: int, k: int, log_n: int, gather: bool = True) -> int:
    """Dynamic shared memory of a block: the tile and, for each of its row
    blocks, the twiddles of the group's stages 1 .. k-1 (2^(k-1) words;
    stage 0's are read from the table in its round)."""
    c = tile_columns(s0, k, log_n, gather)
    row_blocks = 1 << c if s0 == 0 else 1
    return 4 * ((1 << (k + c)) + (k > 1 and row_blocks << (k - 1)))


def async_tile(s0: int, k: int, log_n: int) -> bool:
    """Whether the block copies its tile in with 16-byte cp.async copies:
    an upper group whose rows are whole 16-byte chunks (unless it reads
    ``src`` bit-reversed)."""
    return s0 > 0 and tile_columns(s0, k, log_n) >= 2


def launch_r2(s0: int, k: int, log_n: int, gather: bool = True) -> dict:
    """The launch of the kernel for the group (s0, k) of a 2^log_n
    transform (``gather``: the first group reads its input bit-reversed):
    columns, rounds, blocks, threads, register groups a thread takes in
    each round, dynamic shared memory and the tile copy."""
    c = tile_columns(s0, k, log_n, gather)
    rounds = group_rounds(k)
    threads = block_threads(s0, k, log_n, gather)
    return {"cols": c, "rounds": rounds, "blocks": 1 << (log_n - k - c),
            "threads": threads,
            "groups_per_thread": [(1 << (k + c - r)) // threads
                                  for r in rounds],
            "smem": smem_bytes(s0, k, log_n, gather),
            "async_tile": async_tile(s0, k, log_n)}


# ---- a model of the kernel's index maps, in numpy ----

def tile_bases(s0: int, k: int, log_n: int) -> np.ndarray:
    """(hi, base) of every tile of the group, in tile order: the row block
    (the first group's column 0's) and, in an upper group, the global index
    of the tile's word 0."""
    c = tile_columns(s0, k, log_n)
    tile = np.arange(1 << (log_n - k - c), dtype=np.int64)
    if s0 == 0:
        return np.stack([tile, np.zeros_like(tile)])
    hi, chunk = tile >> (s0 - c), tile & ((1 << (s0 - c)) - 1)
    return np.stack([hi, (hi << (s0 + k)) + (chunk << c)])


def row_blocks(s0: int, k: int, log_n: int, hi, cols):
    """Row block of the tile's columns ``cols``: hi in an upper group; in
    the first group hi + rev(v) << (log_n - k - c) for column v, so that
    the sources of a row's 2^c words, rev of their indices, are
    consecutive."""
    cols = np.asarray(cols, dtype=np.int64)
    if s0 > 0:
        return hi + 0 * cols
    c = tile_columns(s0, k, log_n)
    rev = sum(((cols >> b) & 1) << (c - 1 - b) for b in range(c))
    return hi | (rev << (log_n - k - c))


def global_index(e, s0: int, k: int, log_n: int, hi, base):
    """Global index of tile word e of the tile (hi, base)."""
    c = tile_columns(s0, k, log_n)
    col = e & ((1 << c) - 1)
    if s0 == 0:
        return (row_blocks(s0, k, log_n, hi, col) << k) + (e >> c)
    return base + ((e >> c) << s0) + col


def tile_slot(e, s0: int, k: int, log_n: int):
    """The shared-memory word of tile word e = row * 2^c + column: e XOR
    its bits from the first round's size up, on the bank bits (only bits
    2..4 where the tile is copied in 16-byte chunks)."""
    mask = 0x1C if async_tile(s0, k, log_n) else 0x1F
    return e ^ ((e >> group_rounds(k)[0]) & mask)


def _round_span(s0: int, k: int, log_n: int, q: int) -> tuple:
    """(a, r, j): round q's first tile-word bit, its stages and its first
    stage within the group."""
    rounds = group_rounds(k)
    j = sum(rounds[:q])
    return tile_columns(s0, k, log_n) + j, rounds[q], j


def round_words(s0: int, k: int, log_n: int, q: int, ids) -> np.ndarray:
    """Tile words (ids, 2^r) that the register groups ``ids`` hold in
    round q, word m at m's place among the round's row bits."""
    a, r, _ = _round_span(s0, k, log_n, q)
    ids = np.asarray(ids, dtype=np.int64)[:, None]
    m = np.arange(1 << r, dtype=np.int64)[None, :]
    return (ids & ((1 << a) - 1)) | (m << a) | ((ids >> a) << (a + r))


def _slot_entry(p, hi):
    """Table index of twiddle slot p >= 1 of row block hi: slot p in
    [2^h, 2^(h+1)) holds tw[(hi << h) + p - 2^h], stage k-1-h's."""
    p = np.asarray(p, dtype=np.int64)
    h = np.maximum(np.frexp(p)[1] - 1, 0).astype(np.int64)  # floor(log2)
    return (hi << h) + p - (1 << h)


def twiddle_slots(k: int, hi: int) -> np.ndarray:
    """The table index each shared-memory twiddle slot p (1 .. 2^(k-1)-1)
    holds for row block hi: stage j's 2^(k-j-1) twiddles at slots
    2^(k-j-1) + i, from tw[(hi << (k-j-1)) + i] (slot 0 unused, -1)."""
    p = np.arange(1 << (k - 1), dtype=np.int64)
    return np.where(p > 0, _slot_entry(p, hi), -1)


def round_twiddles(s0: int, k: int, log_n: int, q: int, hi: int,
                   ids) -> list:
    """Table indices of the twiddles the register groups ``ids`` read in
    round q of the tile whose row block is hi, one (ids, 2^(r-i-1)) array
    for each of its stages i: butterfly (m, m + 2^i) multiplies by entry
    m >> (i+1).  Stage 0 of the group reads the table, the others their
    shared-memory slot of the register group's row block."""
    a, r, j = _round_span(s0, k, log_n, q)
    c = tile_columns(s0, k, log_n)
    ids = np.asarray(ids, dtype=np.int64)[:, None]
    hid = ids >> a
    his = row_blocks(s0, k, log_n, hi, ids & ((1 << c) - 1))
    out = []
    for i in range(r):
        js = j + i
        mm = np.arange(1 << (r - i - 1), dtype=np.int64)[None, :]
        off = (hid << (r - i - 1)) + mm
        out.append((his << (k - 1)) + off if js == 0
                   else _slot_entry((1 << (k - js - 1)) + off, his))
    return out


def _check(name, x, tw, s0, k, log_n, src):
    n = 1 << log_n
    if x.dtype != torch.int32 or tuple(x.shape) != (n,):
        raise ValueError(f"{name}: x must be ({n},) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if (tw.dtype != torch.int32 or tuple(tw.shape) != (max(n // 2, 1),)
            or tw.device != x.device or not tw.is_contiguous()):
        raise ValueError(f"{name}: tw must be a contiguous ({n // 2},) "
                         f"int32 tensor on {x.device}")
    if not (0 <= s0 and 1 <= k and s0 + k <= log_n):
        raise ValueError(f"{name}: stages {s0} .. {s0 + k - 1} do not fit "
                         f"log_n = {log_n}")
    if src is not None:
        if (src.dtype != torch.int32 or src.shape != x.shape
                or src.device != x.device or not src.is_contiguous()):
            raise ValueError(f"{name}: src must be like x")
        if src.data_ptr() == x.data_ptr():
            raise ValueError(f"{name}: the bit-reversing load is out of "
                             f"place; src must not be x")


def bit_reverse_indices(log_n: int, device) -> torch.Tensor:
    """Permutation idx[i] = reverse of i's low log_n bits, int64 on
    ``device``; gpuntt.cuh:12-19."""
    i = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(i)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    return rev


def stage_group_r2_plain(x, tw, *, s0: int, k: int, log_n: int,
                         encode_in: bool = False, decode_out: bool = False,
                         src=None, ops=None):
    """Plain torch version of :func:`stage_group_r2`, on any device:
    whole-array stages in int64 with the field ops of fields/baby_bear.py,
    or with those of ``ops`` (a ``radix2.FieldOps``; the per-stage path of
    an injected field).  Every stage multiplies, the top one too (by
    tw[0] = enc(1)).  Works in place like the kernel: x is updated and
    returned."""
    _check("stage_group_r2_plain", x, tw, s0, k, log_n, src)
    if ops is None:
        add, sub, mul = bb.add, bb.sub, bb.mont_mul
        encode, decode = bb.encode, bb.decode
    else:
        add, sub, mul = ops.add, ops.sub, ops.mul
        encode, decode = ops.encode, ops.decode
    if src is not None:
        x.copy_(src[bit_reverse_indices(log_n, x.device)])
    if encode_in:
        x.copy_(encode(x))
    n = 1 << log_n
    for s in range(s0, s0 + k):
        nb = n >> (s + 1)
        v3 = x.view(nb, 2, 1 << s)
        u, v = v3[:, 0], v3[:, 1]
        big_u = add(u, v)
        big_v = mul(sub(u, v), tw[:nb, None])
        u.copy_(big_u)
        v.copy_(big_v)
    if decode_out:
        x.copy_(decode(x))
    return x


def stage_group_r2(x, tw, *, s0: int, k: int, log_n: int,
                   encode_in: bool = False, decode_out: bool = False,
                   src=None):
    """DIF stages s0 .. s0+k-1 over x: (2^log_n,) int32 Montgomery words,
    IN PLACE, with the bit-reversed Montgomery twiddles tw (n/2,).

    ``encode_in`` encodes canonical input words first, ``decode_out``
    decodes the result, and ``src`` (a tensor like x, not x) makes the
    group read its input from src in bit-reversed order.  x is updated and
    returned.  A CPU tensor runs :func:`stage_group_r2_plain`; a CUDA
    tensor launches the kernel of csrc/stage_group_r2.cu or raises.
    """
    if x.device.type == "cpu":
        return stage_group_r2_plain(x, tw, s0=s0, k=k, log_n=log_n,
                                    encode_in=encode_in,
                                    decode_out=decode_out, src=src)
    if x.device.type != "cuda":
        raise ValueError(f"stage_group_r2: unsupported device {x.device}")
    _check("stage_group_r2", x, tw, s0, k, log_n, src)
    if k > TILE_LOG:
        raise ValueError(f"stage_group_r2: the kernel takes at most "
                         f"{TILE_LOG} stages a group, got {k}")
    if any(t.data_ptr() % 16 for t in (x, tw, x if src is None else src)):
        raise ValueError("stage_group_r2: x, src and tw must start on a "
                         "16-byte boundary")
    launch = launch_r2(s0, k, log_n, gather=src is not None)
    rounds = sum(r << (4 * q) for q, r in enumerate(launch["rounds"]))
    flags = (int(encode_in) | int(decode_out) << 1 | int(src is not None) << 2
             | int(launch["async_tile"] and src is None) << 3)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.bntt_stage_group_r2(
            x.data_ptr(), (x if src is None else src).data_ptr(),
            tw.data_ptr(), log_n, s0, k, launch["cols"], flags, rounds,
            launch["threads"], torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "stage_group_r2")
    stage_group_r2.launches += 1
    return x


stage_group_r2.launches = 0


def apply_fused_r2(x, tw, *, log_n: int, input_bit_reversed: bool = False):
    """The whole transform: x (n,) canonical int32 words -> a new (n,)
    tensor of canonical IN_ORDER output.  The first group encodes (and,
    unless the input is already bit-reversed, permutes it on load), the
    last decodes; x itself is not modified."""
    plan = plan_groups_r2(log_n)
    if input_bit_reversed:
        out, src = x.clone(), None
    else:
        out, src = torch.empty_like(x), x
    last = len(plan) - 1
    for gi, (s0, k) in enumerate(plan):
        stage_group_r2(out, tw, s0=s0, k=k, log_n=log_n,
                       encode_in=gi == 0, decode_out=gi == last,
                       src=src if gi == 0 else None)
    return out
