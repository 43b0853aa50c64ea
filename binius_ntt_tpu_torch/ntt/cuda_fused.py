"""Stage-group kernel of the bit-sliced GF(2^128) additive NTT.

Port of binius_ntt_tpu/ntt/pallas_fused.py.  The host table builders are
carried over unchanged (``_bit_masks``, ``plan_groups``, ``_dtable``,
``make_group_tables_sharded`` and its log_d = 0 case
``make_group_tables``, ``build_tables`` and ``build_tables_sharded``,
which add the route flag below); ``stage_group`` launches the CUDA kernel
of csrc/stage_group.cu, ``stage_group_plain`` is the same function in
plain torch, and ``apply_fused`` chains the groups.  A sharded transform
(parallel/ntt128_sharded.py) passes each shard's ``dplanes``, the device
bits' part of every stage's twiddle, which both XOR into the twiddle.

Route: when no table plane >= 32 is set (``subfield_tables``), every
twiddle lies in the subfield GF(2^32), and the kernel takes its CHUNK32
instantiation, four GF(2^32) chunk products a butterfly; otherwise the
general one, one GF(2^128) product.  The flag is decided in numpy when the
tables are built and travels with them, so the wrapper never reads the
device to choose.  The plain version stays the general GF(2^128) multiply.

Twiddles are GF(2)-linear in the butterfly-block indicator, so bit ``i`` of
a twiddle is the parity of ``indicator & mask[i]``.  The indicator splits
into a tile part (``blk``, from the tile row) and an instance part (``q``),
each with a (stages, 128) mask table; the twiddle planes are rebuilt on the
fly and never stored.

Stage grouping (batch index b has log_nb = log_h - 5 bits; stage s >= 5
pairs batches across bit s-5; stages s < 5 are in-word):

  * bottom group: a tile of 2^k consecutive batches covers high stages
    s = k+4 .. 5 and the 5 in-word stages;
  * upper groups: a tile of 2^k batches strided by 2^t0 covers stages
    t0+k+4 .. t0+5.

Geometry: the kernel and the plain version index the tile directly.  At
high stage st of a group (0-based) the pairing bit of the tile row t is
p = k-1-st, and blk = t >> (p+1) — the bits the reference's
constant-geometry loop rotates into the low st positions, in the same
order, so the reference's mask tables apply unchanged.  The in-word stages
keep the reference's out-shuffle loop, for which the ``lanes`` rows are
pre-permuted.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..fields import bitsliced
from ..utils.bits import lsr, to_torch, u32
from ..utils.timing import span

__all__ = ["KB", "KU", "PT", "SUB_PLANES", "plan_groups",
           "make_group_tables", "make_group_tables_sharded",
           "subfield_tables", "build_tables", "build_tables_sharded",
           "chunk32_cols", "stage_group",
           "stage_group_plain", "coset_copy", "apply_fused"]

HEIGHT = 7
W = 1 << HEIGHT
IPV = W // 32              # 4 words per compact value
# planes of the subfield GF(2^32): the low 32 planes of the tower's GF(2^128)
SUB_PLANES = 32
# shared memory of a CHUNK32 block (one 32-plane chunk, 128 bytes, of each
# of its 2^k * cols slots): the most one block may have on the card, and
# the size within which two blocks share an SM
CHUNK32_SMEM_LIMIT = 227 * 1024
CHUNK32_SMEM_TARGET = 96 * 1024

# Plan for Hopper.  KB / KU are the most batch bits of the bottom / an
# upper group.  PT is the most tile columns one thread block covers: a
# general block covers min(PT, post) columns, its tile in global memory
# (L2); a CHUNK32 block holds one 32-plane chunk of its tile in shared
# memory and covers as many of those columns as fit (chunk32_cols), which
# at k = 9 and 10 (a column of 64 / 128 KB) is one.  Fewer, larger groups
# save passes over x: (10, 9, 8) was the fastest plan measured at 2^24 on
# the H100 (tools/torch_stage_group_ab.py; PERF.md).  Any plan gives
# identical output bits.
KB = 10
KU = 9
PT = 8

_UM = 0x0000FFFF
_VM = u32(0xFFFF0000)


def _bit_masks(constants, offset: int, count: int) -> np.ndarray:
    """mask[i] = sum_m bit_i(constants[offset+m]) << m   (shape (128,))."""
    out = np.zeros(W, dtype=np.uint32)
    for m in range(count):
        c = int(constants[offset + m])
        for i in range(W):
            if (c >> i) & 1:
                out[i] |= np.uint32(1 << m)
    return out


def plan_groups(log_nb: int) -> list[tuple[int, int, bool]]:
    """Split batch-index bits into (t0, k, include_low) groups, bottom-up:
    a bottom group of at most KB bits, then ceil(rest / KU) upper groups
    of near-equal size."""
    groups = [(0, min(log_nb, KB), True)]
    rem = log_nb - groups[0][1]
    if rem > 0:
        n = -(-rem // KU)
        t0 = groups[0][1]
        for i in range(n):
            k = rem // n + (1 if i < rem % n else 0)
            groups.append((t0, k, False))
            t0 += k
    return groups


def _dtable(constants, offset: int, cnt: int, log_d: int) -> np.ndarray:
    """Doubling table of the 128-bit indicator contributions of the device
    bits: row d = XOR over the set bits m of d of constants[offset + m], as
    (2^log_d, 4) uint32 words (bits beyond cnt contribute nothing)."""
    tab = np.zeros((1, IPV), dtype=np.uint32)
    for m in range(max(cnt, 0)):
        c = int(constants[offset + m])
        cw = np.array([(c >> (32 * i)) & 0xFFFFFFFF for i in range(IPV)],
                      dtype=np.uint32)
        tab = np.concatenate([tab, tab ^ cw[None]])
    return np.tile(tab, (1 << (log_d - max(cnt, 0)), 1))


def make_group_tables_sharded(rows, log_h: int, log_rate: int, t0: int,
                              k: int, include_low: bool, log_d: int):
    """Mask tables for one LOCAL stage group of a transform whose batches
    are block-sharded over 2^log_d shards.

    rows: precompute_subspace_evals(log_h, log_rate, 7) (python ints).
    Shard d holds batches [d nb_l, (d+1) nb_l); a local stage s = 5+t0+r
    sees the indicator coset << (log_h-1-s) | d << (m0+pre_bits_l) | p <<
    m0 | tile bits (p the local pre index).  mtile is the single-device
    one; minst packs the p part at q bits [0, pre_bits_l) and the coset
    part above it (the kernel numbers a local instance q = coset <<
    pre_bits_l | p); the d bits, GF(2)-linear like the rest, become a
    per-shard correction looked up in the (n_stages, 2^log_d, 4) doubling
    table dtab and XORed into every stage's twiddle (stage_group's
    ``dplanes``).

    Returns numpy (mtile, minst, lanes, zero_flags, dtab): mtile/minst
    (n_stages, 128) uint32 in execution order (high stages descending, then
    low 4..0), lanes (5, 128) or None, zero_flags marking stages whose
    twiddle is zero on every shard (dtab included).
    """
    log_nb_l = log_h - 5 - log_d
    pre_bits_l = log_nb_l - t0 - k
    mtile, minst, dtab = [], [], []

    def masks_split(s, base_off):
        nbits = log_h + log_rate - 1 - s
        p_cnt = max(min(pre_bits_l, nbits - base_off), 0)
        d_off = base_off + pre_bits_l
        d_cnt = max(min(log_d, nbits - d_off), 0)
        c_off = d_off + log_d
        c_cnt = max(nbits - c_off, 0)
        mi = (_bit_masks(rows[s], base_off, p_cnt)
              | (_bit_masks(rows[s], c_off, c_cnt) << np.uint32(pre_bits_l)))
        return mi, _dtable(rows[s], d_off, d_cnt, log_d)

    for r in range(k - 1, -1, -1):
        s = 5 + t0 + r
        m0 = k - 1 - r
        nbits = log_h + log_rate - 1 - s
        mtile.append(_bit_masks(rows[s], 0, min(m0, nbits)))
        mi, dt = masks_split(s, m0)
        minst.append(mi)
        dtab.append(dt)
    lanes = None
    if include_low:
        lane_list = []
        for s in range(min(log_h - 1, 4), -1, -1):
            nbits = log_h + log_rate - 1 - s
            lane_bits = min(4 - s, nbits)
            mtile.append(_bit_masks(rows[s], lane_bits,
                                    min(k, max(nbits - lane_bits, 0))))
            mi, dt = masks_split(s, lane_bits + k)
            minst.append(mi)
            dtab.append(dt)
            vals = [0] * 32
            for j in range(32):
                v = 0
                jj = j >> (s + 1)
                for m in range(lane_bits):
                    if (jj >> m) & 1:
                        v ^= rows[s][m]
                vals[j] = v
            # the out-shuffle loop: at iteration i = 4-s the word bits have
            # been rotated i times (content pos -> rotl5(pos)), so physical
            # bit p holds element rotr5^i(p)
            perm = list(range(32))
            for _ in range(4 - s):
                perm = [((j >> 1) | ((j & 1) << 4)) & 31 for j in perm]
            planes = np.zeros(W, dtype=np.uint32)
            for i in range(W):
                acc = 0
                for p in range(32):
                    acc |= ((vals[perm[p]] >> i) & 1) << p
                planes[i] = acc
            lane_list.append(planes)
        lanes = np.stack(lane_list)
    mtile = np.stack(mtile)
    minst = np.stack(minst)
    dtab = np.stack(dtab)
    zero = []
    for st in range(mtile.shape[0]):
        # a stage whose only nonzero twiddle part is the device bits' is
        # live on every shard but shard 0
        z = (not mtile[st].any() and not minst[st].any()
             and not dtab[st].any())
        if st >= k and lanes is not None:
            z = z and not lanes[st - k].any()
        zero.append(z)
    return mtile, minst, lanes, tuple(zero), dtab


def make_group_tables(rows, log_h: int, log_rate: int, t0: int, k: int,
                      include_low: bool):
    """Mask tables for one stage group of a single-device transform:
    :func:`make_group_tables_sharded` at log_d = 0, whose device table is
    zero.  Returns
    numpy (mtile, minst, lanes, zero_flags) as
    :func:`make_group_tables_sharded` does."""
    return make_group_tables_sharded(rows, log_h, log_rate, t0, k,
                                     include_low, 0)[:4]


def subfield_tables(mtile, minst, lanes, dtab=None) -> bool:
    """True when no plane >= 32 of the numpy tables is set (for a sharded
    group's device table dtab, no word 1..3 of its values): every twiddle
    they make lies in GF(2^32), and the kernel may take its CHUNK32 route.
    Holds for every domain of at most 2^32 points, whose subspace
    polynomials stay in that subfield."""
    return not (any(np.asarray(t)[:, SUB_PLANES:].any()
                    for t in (mtile, minst, lanes) if t is not None)
                or (dtab is not None
                    and np.asarray(dtab)[..., SUB_PLANES // 32:].any()))


def build_tables(rows, log_h: int, log_rate: int, device=None):
    """Per-group tables, ordered for execution (top group first): a tuple of
    (t0, k, include_low, mtile, minst, lanes, zero_flags, chunk32) with
    int32 tensors on ``device``; chunk32 is :func:`subfield_tables`."""
    out = []
    for (t0, k, include_low) in reversed(plan_groups(log_h - 5)):
        mtile, minst, lanes, zero_flags = make_group_tables(
            rows, log_h, log_rate, t0, k, include_low)
        out.append((t0, k, include_low, to_torch(mtile, device),
                    to_torch(minst, device),
                    None if lanes is None else to_torch(lanes, device),
                    zero_flags, subfield_tables(mtile, minst, lanes)))
    return tuple(out)


def build_tables_sharded(rows, log_h: int, log_rate: int, log_d: int,
                         device=None):
    """Per-LOCAL-group tables of a transform block-sharded over 2^log_d
    shards, ordered for execution (top group first): a tuple of (t0, k,
    include_low, mtile, minst, lanes, zero_flags, chunk32, dtab) with
    int32 tensors on ``device``; dtab is (n_stages, 2^log_d, 4) compact
    words, and chunk32 :func:`subfield_tables` of all four tables.  Shard
    d's ``dplanes`` are dtab's row d expanded into bit-planes
    (parallel/ntt128_sharded.shard_dplanes)."""
    out = []
    for (t0, k, include_low) in reversed(plan_groups(log_h - 5 - log_d)):
        mtile, minst, lanes, zero_flags, dtab = make_group_tables_sharded(
            rows, log_h, log_rate, t0, k, include_low, log_d)
        out.append((t0, k, include_low, to_torch(mtile, device),
                    to_torch(minst, device),
                    None if lanes is None else to_torch(lanes, device),
                    zero_flags, subfield_tables(mtile, minst, lanes, dtab),
                    to_torch(dtab, device)))
    return tuple(out)


def chunk32_cols(k: int, post: int) -> int:
    """Tile columns a CHUNK32 block covers: the most, up to min(PT, post),
    whose 2^k * cols chunk slots keep within CHUNK32_SMEM_TARGET bytes,
    and at least one.  Raises when one column exceeds CHUNK32_SMEM_LIMIT."""
    if (SUB_PLANES * 4) << k > CHUNK32_SMEM_LIMIT:
        raise ValueError(f"stage_group: the CHUNK32 route keeps a tile "
                         f"column of 2^{k} rows in shared memory, more than "
                         f"{CHUNK32_SMEM_LIMIT} bytes")
    cols = min(PT, post)
    while cols > 1 and (SUB_PLANES * 4 * cols) << k > CHUNK32_SMEM_TARGET:
        cols >>= 1
    return cols


def _parity_planes(idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """All-ones planes where parity(idx & mask), zeros elsewhere."""
    x = idx & mask
    for s in (16, 8, 4, 2, 1):
        x = x ^ lsr(x, s)
    return -(x & 1)


def _outshuffle(x: torch.Tensor) -> torch.Tensor:
    # bit p = b*16 + j -> 2j + b (rotl of the 5-bit position index)
    for m, sh in ((0x0000FF00, 8), (0x00F000F0, 4),
                  (0x0C0C0C0C, 2), (0x22222222, 1)):
        t = (lsr(x, sh) ^ x) & m
        x = x ^ t ^ (t << sh)
    return x


def _group_geometry(x, mtile, minst, lanes, t0, k, include_low,
                    dplanes=None):
    """Validate a stage_group call; return (n_inst, post)."""
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[2] != W:
        raise ValueError(f"stage_group: x must be (cosets, nb, {W}) int32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stage_group: x must be contiguous")
    cosets, nb, _ = x.shape
    post = 1 << t0
    if k < 1 or nb % ((1 << k) * post):
        raise ValueError(f"stage_group: nb={nb} does not hold tiles of "
                         f"2^{k} x {post} batches")
    n_stages = k + (5 if include_low else 0)
    for name, t, rows_ in (("mtile", mtile, n_stages),
                           ("minst", minst, n_stages),
                           ("lanes", lanes, 5 if include_low else None),
                           ("dplanes", dplanes,
                            None if dplanes is None else n_stages)):
        if rows_ is None:
            continue
        if (t is None or t.dtype != torch.int32
                or tuple(t.shape) != (rows_, W) or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"stage_group: {name} must be a contiguous "
                             f"({rows_}, {W}) int32 tensor on {x.device}")
    if include_low and post != 1:
        raise ValueError("stage_group: the bottom group has t0 = 0")
    return cosets * nb // ((1 << k) * post), post


def stage_group_plain(x, mtile, minst, lanes, *, t0: int, k: int,
                      include_low: bool, zero_flags: tuple = (),
                      dplanes=None):
    """Plain torch version of :func:`stage_group`, on any device.

    Whole-tensor ops over every instance at once, with the general
    GF(2^128) multiply of fields/bitsliced.py on either route, so that
    holding the CHUNK32 kernel to it checks the chunk decomposition.
    Works in place like the kernel: x is updated and returned.
    Zero-flagged stages are computed like any other (their twiddle is 0, so
    the product is 0).  ``dplanes`` (n_stages, 128), when given, is XORed
    into every stage's twiddle, as the reference body does.
    """
    n_inst, post = _group_geometry(x, mtile, minst, lanes, t0, k,
                                   include_low, dplanes)
    kk = 1 << k
    x5 = x.view(n_inst, kk, post, W)
    q = torch.arange(n_inst, dtype=torch.int32, device=x.device)
    for st in range(k):
        p = k - 1 - st
        xv = x5.view(n_inst, 1 << st, 2, 1 << p, post, W)
        u, v = xv[:, :, 0], xv[:, :, 1]
        blk = torch.arange(1 << st, dtype=torch.int32, device=x.device)
        w = (_parity_planes(blk[None, :, None], mtile[st])
             ^ _parity_planes(q[:, None, None], minst[st]))
        if dplanes is not None:
            w = w ^ dplanes[st]
        u2 = u ^ bitsliced.multiply(w[:, :, None, None, :], v, HEIGHT)
        v2 = u2 ^ v
        u.copy_(u2)
        v.copy_(v2)

    if include_low:
        xf = x5.view(n_inst, kk, W)
        t = torch.arange(kk, dtype=torch.int32, device=x.device)
        for i in range(5):
            st = k + i
            x0, x1 = xf[:, 0::2], xf[:, 1::2]
            wrow = (_parity_planes(t[None, :, None], mtile[st])
                    ^ _parity_planes(q[:, None, None], minst[st])
                    ^ lanes[i])
            if dplanes is not None:
                wrow = wrow ^ dplanes[st]
            w0, w1 = wrow[:, 0::2], wrow[:, 1::2]
            # even row's v-lanes into the u-slots, odd row's stay in v-slots
            comp = (lsr(x0, 16) & _UM) | (x1 & _VM)
            wcmp = (w0 & _UM) | ((w1 & _UM) << 16)
            prod = bitsliced.multiply(wcmp, comp, HEIGHT)
            un0 = x0 ^ (prod & _UM)
            un1 = x1 ^ lsr(prod & _VM, 16)
            y0 = (un0 & _UM) | ((x0 ^ (un0 << 16)) & _VM)
            y1 = (un1 & _UM) | ((x1 ^ (un1 << 16)) & _VM)
            x0.copy_(_outshuffle(y0))
            x1.copy_(_outshuffle(y1))
    return x


def stage_group(x, mtile, minst, lanes, *, t0: int, k: int,
                include_low: bool, zero_flags: tuple = (),
                chunk32: bool = False, dplanes=None):
    """Run one stage group over x: (cosets, nb, 128) int32, IN PLACE.

    Covers high stages 5+t0+k-1 .. 5+t0 and, if include_low, the in-word
    stages 4..0.  x is updated in place (the reference's
    input_output_aliases) and returned.  ``dplanes``: a sharded caller's
    (n_stages, 128) int32 twiddle correction
    (parallel/ntt128_sharded.shard_dplanes), XORed
    into every stage's twiddle; x is then the shard's local batches.  A
    CPU tensor runs :func:`stage_group_plain`; a CUDA tensor launches the
    kernel of csrc/stage_group.cu or raises: its CHUNK32 instantiation if
    ``chunk32`` (the tables' :func:`subfield_tables`, which the caller
    vouches for), else the general one.  ``launches`` counts every launch,
    ``route_launches`` each route's, ``dplanes_launches`` those given
    ``dplanes``.  Each call is an ``ntt.stage_group`` span (utils/timing.py)
    with the group's t0, k, include_low and whether it has dplanes.
    """
    with span("ntt.stage_group", x.device, t0=t0, k=k,
              include_low=include_low, dplanes=dplanes is not None):
        if x.device.type == "cpu":
            return stage_group_plain(x, mtile, minst, lanes, t0=t0, k=k,
                                     include_low=include_low,
                                     zero_flags=zero_flags, dplanes=dplanes)
        if x.device.type != "cuda":
            raise ValueError(f"stage_group: unsupported device {x.device}")
        n_inst, post = _group_geometry(x, mtile, minst, lanes, t0, k,
                                       include_low, dplanes)
        cols = chunk32_cols(k, post) if chunk32 else min(PT, post)
        zero_mask = sum(1 << st for st, z in enumerate(zero_flags) if z)
        lib = _build.library()
        with torch.cuda.device(x.device):
            rc = lib.bntt_stage_group(
                x.data_ptr(), mtile.data_ptr(), minst.data_ptr(),
                lanes.data_ptr() if include_low else None,
                None if dplanes is None else dplanes.data_ptr(), n_inst, k,
                post, cols, int(include_low), zero_mask, int(chunk32),
                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "stage_group")
    stage_group.launches += 1
    stage_group.route_launches["chunk32" if chunk32 else "general"] += 1
    stage_group.dplanes_launches += dplanes is not None
    return x


stage_group.launches = 0
stage_group.route_launches = {"chunk32": 0, "general": 0}
stage_group.dplanes_launches = 0


def coset_copy(data, log_rate: int):
    """The transform's in-place working buffer: data (..., nb, 128), one
    column or a batch, copied once per coset into a fresh (..., cosets*nb,
    128) tensor (the stages work in place, so a broadcast view would
    alias the cosets), in an ``ntt.coset_copy`` span."""
    with span("ntt.coset_copy", data.device):
        return data.repeat(*(1,) * (data.dim() - 2), 1 << log_rate, 1)


def apply_fused(data, tables, *, log_rate: int):
    """Full transform: data (nb, 128) bit-sliced -> (cosets*nb, 128), or a
    batch of B columns (B, nb, 128) -> (B, cosets*nb, 128).

    tables: build_tables() output, top group first (DIT: high stages
    first).  The input is copied into a fresh tensor (:func:`coset_copy`);
    ``data`` itself is not modified.  A batch is one (B * cosets, nb, 128)
    tensor, and each group one launch over it: its instance q = (b cosets
    + coset) pre + p puts the column b above the bits the minst masks
    read, so column b's twiddles are column 0's.
    """
    x = coset_copy(data, log_rate)
    groups = x.view(-1, data.shape[-2], W)
    for (t0, k, include_low, mtile, minst, lanes, zero_flags,
         chunk32) in tables:
        stage_group(groups, mtile, minst, lanes, t0=t0, k=k,
                    include_low=include_low, zero_flags=zero_flags,
                    chunk32=chunk32)
    return x
