"""Stage-group kernel of the GF(2^32) additive NTT on the packed layout.

Port of binius_ntt_tpu/ntt/pallas_fused32.py.  The host-side table code is
carried over unchanged (``_bit_masks32``, ``plan_groups32``,
``make_group_tables32``, ``build_tables32``); ``stage_group32`` launches
the kernel of csrc/stage_group32.cu and ``bitslice_lane_groups`` that of
csrc/bitslice_lane_groups.cu, each beside its plain torch version, and
``apply_fused32`` chains the groups.

Packed bit-sliced layout (4 blocks per 128-word row):

  * element e = 32*b + j: bits [4:0] = j (in-word), [6:5] = c, rest = r,
    where block b = 4*r + c;
  * a block of 32 GF(2^32) elements is 32 bit-planes (bit j of plane p =
    bit p of element 32*b + j);
  * row r of the (nb/4, 128) array holds blocks 4r..4r+3 at lane groups
    [32c, 32c+32) — ``bitslice_lane_groups`` of the compact (n/128, 128)
    words.

Stages descend (DIT): stages s >= 7 pair rows, stages 6 and 5 pair lane
groups, stages 4..0 pair bits inside each word.  The reference transposes
its tiles to plane-major around every multiply to suit Mosaic; the port
indexes the rows directly: lane group c of row r is words [32c, 32c+32),
the 32 planes of block 4r + c.

Twiddles are GF(2)-linear in the butterfly-block indicator, so plane p of
a twiddle is the parity of ``index & mask[p]`` over the tile-row and
instance parts, regenerated on the fly from (32,) mask rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..fields import bitsliced
from ..layout.bitslicing import transpose32
from ..utils.bits import lsr, to_torch, u32
from .cuda_fused import _parity_planes

__all__ = ["KB", "KU", "SWEPT_PLANS", "SMEM_LIMIT", "group_cols32",
           "tile_bytes32", "plan_groups32", "make_group_tables32",
           "build_tables32", "stage_group32", "stage_group32_plain",
           "bitslice_lane_groups", "bitslice_lane_groups_plain",
           "apply_fused32"]

HEIGHT = 5
W32 = 32
PACK = 4             # bit-sliced blocks packed per 128-word row
W = PACK * W32
N_LOW = 7            # stages 6..0 run in the bottom group's low section

# Plan for Hopper.  KB / KU are the most row bits of the bottom / an upper
# group.  Every group runs on a tile in shared memory: an upper group's
# block holds one 128-byte lane group of each of its 2^k tile rows in
# group_cols32 columns (64 KB at k = 9, 128 KB at k = 10, one column
# each), the bottom group's block all four lane groups of its 2^k rows
# (64 KB at k = 7, 128 KB at k = 8), so no plan may go beyond KU = 10 or
# KB = 8 (SMEM_LIMIT).  At 2^24 (17 row bits) the two-group plans are
# (8, 9) and (7, 10); on the H100, (8, 9) ran the chain 7% faster than
# (7, 10) and 10-17% faster than the three-group plans below.  Any plan
# gives identical output bits.
KB = 8
KU = 9
# the plans the card sweep compared at 2^24 (tools/torch_stage_group32_ab.py
# --plans; PERF.md): the two-group ones and three-group ones
SWEPT_PLANS = ((8, 9), (7, 10), (6, 10), (8, 8), (5, 10))
# the most shared memory one block may have on the card
SMEM_LIMIT = 227 * 1024
# butterflies a pass of an upper block should have: a small group's block
# takes more columns until it has this many (128 threads, 32 KB of tile)
BLOCK_BUTTERFLIES = 128

_LANE_MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)
_LOW_NAMES = ("mlo_t", "mlo_i", "cpl", "lpl")


def _bit_masks32(constants, offset: int, count: int) -> np.ndarray:
    """mask[i] = sum_m bit_i(constants[offset+m]) << m   (shape (32,))."""
    out = np.zeros(W32, dtype=np.uint32)
    for m in range(max(count, 0)):
        c = int(constants[offset + m])
        for i in range(W32):
            if (c >> i) & 1:
                out[i] |= np.uint32(1 << m)
    return out


def plan_groups32(log_nbr: int) -> list[tuple[int, int, bool]]:
    """Split packed-row index bits into (t0, k, include_low) groups."""
    groups = []
    kb = min(log_nbr, KB)
    groups.append((0, kb, True))
    t0 = kb
    while t0 < log_nbr:
        k = min(log_nbr - t0, KU)
        groups.append((t0, k, False))
        t0 += k
    return groups


def make_group_tables32(rows, log_h: int, log_rate: int, t0: int, k: int,
                        include_low: bool):
    """Parity-mask tables for one stage group (host-side, numpy).

    rows: precompute_subspace_evals(log_h, log_rate, 5) (python ints).
    Row-pairing stage s = 7 + t0 + rbit has indicator
    coset << (log_h-1-s) | (r >> (rbit+1) within-group bits first); the
    twiddle is c-independent, so one (32,) plane mask serves all slabs.
    """
    mtile, minst = [], []
    zero = []
    # high (row-pairing) stages s = 7+t0+k-1 .. 7+t0, descending
    for rbit in range(k - 1, -1, -1):
        s = 7 + t0 + rbit
        m0 = k - 1 - rbit          # tile bits in the butterfly-block index
        nbits = log_h + log_rate - 1 - s
        mt = _bit_masks32(rows[s], 0, min(m0, nbits))
        mi = _bit_masks32(rows[s], m0, max(nbits - m0, 0))
        mtile.append(mt)
        minst.append(mi)
        zero.append(not mt.any() and not mi.any())
    mtile = (np.stack(mtile) if mtile
             else np.zeros((0, W32), dtype=np.uint32))
    minst = (np.stack(minst) if minst
             else np.zeros((0, W32), dtype=np.uint32))

    if not include_low:
        return dict(mtile=mtile, minst=minst, zero=tuple(zero))

    # low stages 6..0: r enters the indicator at a stage-dependent offset,
    # c contributes per-lane-group constants, j contributes true bit-planes
    mlo_t = np.zeros((N_LOW, W32), dtype=np.uint32)
    mlo_i = np.zeros((N_LOW, W32), dtype=np.uint32)
    cpl = np.zeros((N_LOW, PACK, W32), dtype=np.uint32)
    lpl = np.zeros((N_LOW, W32), dtype=np.uint32)
    for i, s in enumerate(range(6, -1, -1)):
        if s > log_h - 1:
            zero.append(True)      # unreachable for log_h >= 7
            continue
        nbits = log_h + log_rate - 1 - s
        if s == 6:
            r_off = 0
            c_bits = ()
        elif s == 5:
            r_off = 1
            c_bits = (None, 0)     # c bit 1 -> indicator bit 0
        else:
            r_off = 6 - s
            c_bits = (4 - s, 5 - s)  # c bits 0,1 -> indicator bits 4-s,5-s
            lane_bits = min(4 - s, nbits)
            for j in range(32):
                v = 0
                jj = j >> (s + 1)
                for m in range(lane_bits):
                    if (jj >> m) & 1:
                        v ^= rows[s][m]
                for p in range(W32):
                    if (v >> p) & 1:
                        lpl[i, p] |= np.uint32(1 << j)
        mlo_t[i] = _bit_masks32(rows[s], r_off,
                                min(k, max(nbits - r_off, 0)))
        mlo_i[i] = _bit_masks32(rows[s], r_off + k,
                                max(nbits - r_off - k, 0))
        for c in range(PACK):
            v = 0
            for t, pos in enumerate(c_bits):
                if pos is None:
                    continue
                if (c >> t) & 1 and pos < nbits:
                    v ^= rows[s][pos]
            for p in range(W32):
                if (v >> p) & 1:
                    cpl[i, c, p] = np.uint32(0xFFFFFFFF)
        zero.append(not mlo_t[i].any() and not mlo_i[i].any()
                    and not cpl[i].any() and not lpl[i].any())

    return dict(mtile=mtile, minst=minst, mlo_t=mlo_t, mlo_i=mlo_i,
                cpl=cpl, lpl=lpl, zero=tuple(zero))


def build_tables32(rows, log_h: int, log_rate: int, device=None):
    """Per-group tables, ordered for execution (top group first): a tuple
    of (t0, k, include_low, tabs), tabs a dict of int32 tensors on
    ``device`` plus its ``zero`` flags."""
    if log_h < 7:
        raise ValueError("the packed layout needs log_h >= 7 (four blocks "
                         "of 32 elements)")
    out = []
    for (t0, k, include_low) in reversed(plan_groups32(log_h - 7)):
        tabs = make_group_tables32(rows, log_h, log_rate, t0, k, include_low)
        out.append((t0, k, include_low,
                    {name: (to_torch(v, device) if isinstance(v, np.ndarray)
                            else v) for name, v in tabs.items()}))
    return tuple(out)


def group_cols32(k: int, post: int) -> int:
    """Tile columns an upper group's block covers: the fewest (a power of
    two dividing ``post``) that give a pass BLOCK_BUTTERFLIES butterflies,
    one for a group of 2^8 rows or more."""
    return max(1, min(post, (2 * BLOCK_BUTTERFLIES) >> k))


def tile_bytes32(k: int, include_low: bool, cols: int = 1) -> int:
    """Shared memory of one stage_group32 block: 2^k * cols slots of 128
    bytes (one lane group of a tile row), four sets of 2^k in the bottom
    group."""
    return (PACK if include_low else cols) * (W32 * 4 << k)


def _table_shapes(k: int, include_low: bool) -> dict:
    shapes = {"mtile": (k, W32), "minst": (k, W32)}
    if include_low:
        shapes.update(mlo_t=(N_LOW, W32), mlo_i=(N_LOW, W32),
                      cpl=(N_LOW, PACK, W32), lpl=(N_LOW, W32))
    return shapes


def _group_geometry32(x, tabs, t0, k, include_low, cosets, log_nbr):
    """Validate a stage_group32 call; return (n_inst, post)."""
    nbr = 1 << log_nbr
    if (x.dtype != torch.int32
            or tuple(x.shape) != (cosets, nbr, W)):
        raise ValueError(f"stage_group32: x must be ({cosets}, {nbr}, {W}) "
                         f"int32, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("stage_group32: x must be contiguous and 16-byte "
                         "aligned")
    if k < 0 or t0 < 0 or t0 + k > log_nbr or (k == 0 and not include_low):
        raise ValueError(f"stage_group32: group (t0={t0}, k={k}) does not "
                         f"fit {log_nbr} row bits")
    if include_low and t0 != 0:
        raise ValueError("stage_group32: the bottom group has t0 = 0")
    for name, shape in _table_shapes(k, include_low).items():
        t = tabs.get(name)
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
                or tuple(t.shape) != shape or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"stage_group32: {name} must be a contiguous "
                             f"{shape} int32 tensor on {x.device}")
    if len(tabs["zero"]) != k + (N_LOW if include_low else 0):
        raise ValueError("stage_group32: one zero flag per stage")
    pre = 1 << (log_nbr - t0 - k)
    return cosets * pre, 1 << t0


def stage_group32_plain(x, tabs, *, t0: int, k: int, include_low: bool,
                        cosets: int, log_nbr: int):
    """Plain torch version of :func:`stage_group32`, on any device.

    Whole-tensor ops over every instance at once, with the GF(2^32)
    multiply of fields/bitsliced.py.  Works in place like the kernel: x is
    updated and returned.  Zero-flagged stages are computed like any other
    (their twiddle is 0, so the product is 0).
    """
    n_inst, post = _group_geometry32(x, tabs, t0, k, include_low, cosets,
                                     log_nbr)
    kk = 1 << k
    dev = x.device
    x5 = x.view(n_inst, kk, post, PACK, W32)
    q = torch.arange(n_inst, dtype=torch.int32, device=dev)
    for st in range(k):
        rbit = k - 1 - st
        xv = x5.view(n_inst, 1 << st, 2, 1 << rbit, post, PACK, W32)
        u, v = xv[:, :, 0], xv[:, :, 1]
        blk = torch.arange(1 << st, dtype=torch.int32, device=dev)
        w = (_parity_planes(blk[None, :, None], tabs["mtile"][st])
             ^ _parity_planes(q[:, None, None], tabs["minst"][st]))
        u2 = u ^ bitsliced.multiply(w[:, :, None, None, None, :], v, HEIGHT)
        v2 = u2 ^ v
        u.copy_(u2)
        v.copy_(v2)

    if not include_low:
        return x
    xf = x5.view(n_inst, kk, PACK, W32)
    t = torch.arange(kk, dtype=torch.int32, device=dev)

    def base(i):     # (n_inst, kk, 1, 32): the row and instance part
        return (_parity_planes(t[None, :, None], tabs["mlo_t"][i])
                ^ _parity_planes(q[:, None, None], tabs["mlo_i"][i])
                )[:, :, None, :]

    # stage 6 pairs lane groups c and c + 2, stage 5 c and c + 1 (cpl[0]
    # is zero; cpl[1] adds c bit 1)
    pairs = ((slice(0, 2), slice(2, 4)), (slice(0, None, 2),
                                          slice(1, None, 2)))
    for i, (cu, cv) in enumerate(pairs):
        u, v = xf[:, :, cu], xf[:, :, cv]
        w = base(i) ^ tabs["cpl"][i][cu]
        u2 = u ^ bitsliced.multiply(w, v, HEIGHT)
        v2 = u2 ^ v
        u.copy_(u2)
        v.copy_(v2)

    # stages 4..0: in-word; lane groups (0, 1) and (2, 3) pack their
    # v-halves into one composite multiply
    for i, s in enumerate(range(4, -1, -1), start=2):
        shift = 1 << s
        um = _LANE_MASKS[s]
        vm = u32(_LANE_MASKS[s] << shift)
        x0, x1 = xf[:, :, 0::2], xf[:, :, 1::2]
        wt = base(i) ^ tabs["cpl"][i] ^ tabs["lpl"][i]
        w0, w1 = wt[:, :, 0::2], wt[:, :, 1::2]
        comp = (lsr(x0, shift) & um) | (x1 & vm)
        wcmp = (w0 & um) | ((w1 & um) << shift)
        prod = bitsliced.multiply(wcmp, comp, HEIGHT)
        un0 = x0 ^ (prod & um)
        un1 = x1 ^ lsr(prod & vm, shift)
        y0 = (un0 & um) | ((x0 ^ (un0 << shift)) & vm)
        y1 = (un1 & um) | ((x1 ^ (un1 << shift)) & vm)
        x0.copy_(y0)
        x1.copy_(y1)
    return x


def stage_group32(x, tabs, *, t0: int, k: int, include_low: bool,
                  cosets: int, log_nbr: int):
    """One stage group over x: (cosets, 2^log_nbr, 128) int32, IN PLACE.

    Covers row stages 7+t0+k-1 .. 7+t0 and, if include_low, the low stages
    6..0.  x is updated in place and returned.  A CPU tensor runs
    :func:`stage_group32_plain`; a CUDA tensor launches the kernel of
    csrc/stage_group32.cu or raises, as it does for a group whose tile
    (:func:`tile_bytes32`) exceeds SMEM_LIMIT.
    """
    if x.device.type == "cpu":
        return stage_group32_plain(x, tabs, t0=t0, k=k,
                                   include_low=include_low, cosets=cosets,
                                   log_nbr=log_nbr)
    if x.device.type != "cuda":
        raise ValueError(f"stage_group32: unsupported device {x.device}")
    n_inst, post = _group_geometry32(x, tabs, t0, k, include_low, cosets,
                                     log_nbr)
    cols = 1 if include_low else group_cols32(k, post)
    tile = tile_bytes32(k, include_low, cols)
    if tile > SMEM_LIMIT:
        kind = "bottom" if include_low else "upper"
        raise ValueError(f"stage_group32: the {kind} group's tile of 2^{k} "
                         f"rows needs {tile} bytes of shared memory, more "
                         f"than {SMEM_LIMIT}")
    zero_mask = sum(1 << st for st, z in enumerate(tabs["zero"]) if z)
    low = [tabs[name].data_ptr() if include_low else None
           for name in _LOW_NAMES]
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.bntt_stage_group32(
            x.data_ptr(), tabs["mtile"].data_ptr(), tabs["minst"].data_ptr(),
            *low, n_inst, k, post, cols, int(include_low), zero_mask,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "stage_group32")
    stage_group32.launches += 1
    return x


stage_group32.launches = 0


def _check_rows(x) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != W:
        raise ValueError(f"bitslice_lane_groups: expected (R, {W}) int32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bitslice_lane_groups: x must be contiguous")


def bitslice_lane_groups_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`bitslice_lane_groups`: transpose32 on
    the (R, 4, 32) view.  Returns a new tensor."""
    _check_rows(x)
    return transpose32(x.view(-1, PACK, W32)).reshape(x.shape)


def bitslice_lane_groups(x: torch.Tensor) -> torch.Tensor:
    """The 32x32 bit transpose within each aligned 32-word group of the
    (R, 128) int32 rows: compact GF(2^32) words <-> the packed bit-sliced
    layout (its own inverse).  Returns a new tensor; x is left as it is.
    A CPU tensor runs :func:`bitslice_lane_groups_plain`; a CUDA tensor
    launches the kernel of csrc/bitslice_lane_groups.cu or raises.  The
    kernel moves 16-byte vectors: a view that does not start on 16 bytes is
    copied first."""
    if x.device.type == "cpu":
        return bitslice_lane_groups_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"bitslice_lane_groups: unsupported device "
                         f"{x.device}")
    _check_rows(x)
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.bntt_bitslice_lane_groups(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "bitslice_lane_groups")
    bitslice_lane_groups.launches += 1
    return out


bitslice_lane_groups.launches = 0


def apply_fused32(data, tables, *, log_h: int, log_rate: int):
    """Full transform: data (nbr, 128) packed bit-sliced -> (cosets*nbr,
    128).

    tables: build_tables32() output, top group first (DIT: high stages
    first).  The input is copied once per coset into a fresh tensor (the
    groups work in place); ``data`` itself is not modified.
    """
    nbr = data.shape[0]
    cosets = 1 << log_rate
    log_nbr = log_h - 7
    x = data.repeat(cosets, 1).view(cosets, nbr, W)
    for (t0, k, include_low, tabs) in tables:
        stage_group32(x, tabs, t0=t0, k=k, include_low=include_low,
                      cosets=cosets, log_nbr=log_nbr)
    return x.view(cosets * nbr, W)
