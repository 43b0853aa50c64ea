"""Per-stage GF(2^128) butterflies and the standalone bit-sliced multiply:
CUDA kernels and their plain versions.

Port of binius_ntt_tpu/ntt/pallas_kernels.py:

  * ``butterfly_high`` / ``butterfly_low`` (csrc/butterfly.cu): one stage
    of the per-stage path of ``AdditiveNTT128``, in place on the (R, 128)
    working buffer of C cosets of nb batches (R = C * nb).  A high stage
    s >= 5 pairs the rows of each block of 2^(s-4) rows across its middle,
    one twiddle per block; a low stage s < 5 pairs lanes inside each row,
    with the twiddle of a lane split into a batch part (per row) and a lane
    part (per stage).  Twiddles arrive compact, 4 words a value, and the
    kernels expand them into bit-planes themselves.  Each has two routes:
    CHUNK32 when the stage's twiddles lie in GF(2^32) (:func:`high_subfield`,
    :func:`low_subfield`, decided once by the caller from the tables), four
    GF(2^32) chunk products a row pair (at a low stage the u lanes of two
    rows packed into one word), else one GF(2^128) product a row pair or
    row.
  * ``mul_tiles`` (csrc/mul_tiles.cu): the standalone GF(2^128) multiply,
    as the nine GF(2^32) leaves of csrc/tower_leaf32.cuh spread over the
    warps of persistent blocks that walk prefetched tiles of 32 rows.

The plain versions are the reference's jnp branch
(additive_bitsliced.py:239-244, 260-265) in torch over
``fields/bitsliced.multiply``.  They work in place like the kernels and go
over the rows in chunks, so that the stacked Karatsuba's level
intermediates (3^7 / 2^7 = 17 times the operands) stay a few GB at 2^24.

Dispatch is by the tensor's device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import torch

from .. import _build
from ..fields import bitsliced
from .cuda_fused import SUB_PLANES
from ..fields.tower_simd import MASKS
from ..utils.bits import lsr, u32

__all__ = ["HEIGHT", "W", "PLAIN_CHUNK", "butterfly_high",
           "butterfly_high_plain", "butterfly_low", "butterfly_low_plain",
           "high_subfield", "low_subfield", "mul_tiles", "mul_tiles_plain"]

HEIGHT = 7
W = 1 << HEIGHT
IPV = W // 32

# rows (high stage: row pairs) per chunk of the plain versions: ~0.6 GB
# for each stacked Karatsuba operand
PLAIN_CHUNK = 1 << 16


def _expand_bits(w4: torch.Tensor) -> torch.Tensor:
    """(..., 4) compact words -> (..., 128) all-ones/zeros bit-planes:
    plane 32 j + b is -((w4[..., j] >> b) & 1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=w4.device)
    bits = (w4[..., :, None] >> shifts) & 1          # (..., 4, 32)
    return -bits.reshape(w4.shape[:-1] + (W,))


def _check_words(name: str, t: torch.Tensor, shape: tuple,
                 device: torch.device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {shape} int32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(**tensors) -> None:
    """The kernels read rows and twiddles with 16-byte loads."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _high_geometry(x: torch.Tensor, w4: torch.Tensor) -> int:
    """Validate a high-stage call; return log2 of the pair distance db."""
    if x.dim() != 2 or w4.dim() != 2 or w4.shape[0] == 0:
        raise ValueError(f"butterfly_high: expected x (R, {W}) and w4 "
                         f"(G, {IPV}), got {tuple(x.shape)} and "
                         f"{tuple(w4.shape)}")
    rows, blocks = x.shape[0], w4.shape[0]
    two_db = rows // blocks
    if rows % blocks or two_db < 2 or two_db & (two_db - 1):
        raise ValueError(f"butterfly_high: {rows} rows do not split into "
                         f"{blocks} blocks of 2 * 2^k rows")
    _check_words("x", x, (rows, W), x.device)
    _check_words("w4", w4, (blocks, IPV), x.device)
    return two_db.bit_length() - 2


def _low_geometry(x: torch.Tensor, a4: torch.Tensor,
                  lane_planes: torch.Tensor, stage: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"butterfly_low: expected x (R, {W}), got "
                         f"{tuple(x.shape)}")
    if stage not in range(5):
        raise ValueError(f"butterfly_low: stage {stage} not in 0..4")
    _check_words("x", x, (x.shape[0], W), x.device)
    _check_words("a4", a4, (x.shape[0], IPV), x.device)
    _check_words("lane_planes", lane_planes, (W,), x.device)


def high_subfield(w4: torch.Tensor) -> bool:
    """True when every twiddle of a high stage lies in GF(2^32): words 1..3
    of w4 are zero, so that :func:`butterfly_high` may take its CHUNK32
    route.  Holds for every domain of at most 2^32 points.  Reads the table
    (a sync on a CUDA tensor): decide it once, at set-up."""
    return not bool(w4[:, 1:].any())


def low_subfield(a4: torch.Tensor, lane_planes: torch.Tensor) -> bool:
    """True when every twiddle of a low stage lies in GF(2^32): words 1..3
    of the batch parts a4 and lane planes 32..127 are zero, so that
    :func:`butterfly_low` may take its CHUNK32 route.  Holds for every
    domain of at most 2^32 points.  Reads the tables (a sync on a CUDA
    tensor): decide it once, at set-up."""
    return not (bool(a4[:, 1:].any()) or bool(lane_planes[SUB_PLANES:].any()))


def butterfly_high_plain(x: torch.Tensor, w4: torch.Tensor,
                         chunk32: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`butterfly_high`, on any device:
    u' = u ^ w v, v' = u' ^ v in every block, in place; returns x.  It has
    one route, the general GF(2^128) multiply, whatever ``chunk32`` (the
    kernel's route) says."""
    log_db = _high_geometry(x, w4)
    db = 1 << log_db
    x4 = x.view(-1, 2, db, W)
    wp = _expand_bits(w4)[:, None, :]                    # (G, 1, 128)
    per = max(1, PLAIN_CHUNK // db)                     # blocks per chunk
    span = min(db, PLAIN_CHUNK)                         # pairs per block
    for b0 in range(0, x4.shape[0], per):
        for d0 in range(0, db, span):
            u = x4[b0:b0 + per, 0, d0:d0 + span]
            v = x4[b0:b0 + per, 1, d0:d0 + span]
            u ^= bitsliced.multiply(wp[b0:b0 + per], v, HEIGHT)
            v ^= u
    return x


def butterfly_low_plain(x: torch.Tensor, a4: torch.Tensor,
                        lane_planes: torch.Tensor, stage: int,
                        chunk32: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`butterfly_low`, on any device:
    un = x ^ w (x >> 2^s), x' = (un & umask) | ((x ^ (un << 2^s)) & vmask)
    with w = expand(a4) ^ lane_planes, in place; returns x.  It has one
    route, the general GF(2^128) multiply, whatever ``chunk32`` (the
    kernel's route) says."""
    _low_geometry(x, a4, lane_planes, stage)
    shift = 1 << stage
    umask = MASKS[stage]                     # the even lanes
    vmask = u32(umask << shift)              # 0xFFFF0000 at stage 4
    for r0 in range(0, x.shape[0], PLAIN_CHUNK):
        xc = x[r0:r0 + PLAIN_CHUNK]
        wp = _expand_bits(a4[r0:r0 + PLAIN_CHUNK]) ^ lane_planes
        un = xc ^ bitsliced.multiply(wp, lsr(xc, shift), HEIGHT)
        xc.copy_((un & umask) | ((xc ^ (un << shift)) & vmask))
    return x


def butterfly_high(x: torch.Tensor, w4: torch.Tensor,
                   chunk32: bool = False) -> torch.Tensor:
    """One high stage, IN PLACE: x (R, 128) int32 rows in blocks of 2 db
    (db = R / (2 G), a power of two), w4 (G, 4) int32, one compact
    twiddle per block.  Returns x.  A CPU tensor runs
    :func:`butterfly_high_plain`; a CUDA tensor launches the kernel of
    csrc/butterfly.cu or raises: its CHUNK32 route if ``chunk32`` (the
    table's :func:`high_subfield`, which the caller vouches for), else the
    general one.  ``launches`` counts every launch, ``route_launches``
    each route's."""
    if x.device.type == "cpu":
        return butterfly_high_plain(x, w4)
    if x.device.type != "cuda":
        raise ValueError(f"butterfly_high: unsupported device {x.device}")
    log_db = _high_geometry(x, w4)
    _check_aligned(x=x, w4=w4)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.bntt_butterfly_high(x.data_ptr(), w4.data_ptr(), x.shape[0],
                                     log_db, int(chunk32),
                                     torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "butterfly_high")
    butterfly_high.launches += 1
    butterfly_high.route_launches["chunk32" if chunk32 else "general"] += 1
    return x


butterfly_high.launches = 0
butterfly_high.route_launches = {"chunk32": 0, "general": 0}


def butterfly_low(x: torch.Tensor, a4: torch.Tensor, lane_planes: torch.Tensor,
                  stage: int, chunk32: bool = False) -> torch.Tensor:
    """One low (in-word) stage 0..4, IN PLACE: x (R, 128) int32 rows, a4
    (R, 4) int32 the batch part of each row's twiddle, lane_planes (128,)
    int32 the stage's lane part as bit-planes.  Returns x.  A CPU tensor
    runs :func:`butterfly_low_plain`; a CUDA tensor launches the kernel of
    csrc/butterfly.cu or raises: its CHUNK32 route if ``chunk32`` (the
    tables' :func:`low_subfield`, which the caller vouches for), else the
    general one.  ``launches`` counts every launch, ``route_launches``
    each route's."""
    if x.device.type == "cpu":
        return butterfly_low_plain(x, a4, lane_planes, stage)
    if x.device.type != "cuda":
        raise ValueError(f"butterfly_low: unsupported device {x.device}")
    _low_geometry(x, a4, lane_planes, stage)
    _check_aligned(x=x, a4=a4)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.bntt_butterfly_low(x.data_ptr(), a4.data_ptr(),
                                    lane_planes.data_ptr(), x.shape[0], stage,
                                    int(chunk32),
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "butterfly_low")
    butterfly_low.launches += 1
    butterfly_low.route_launches["chunk32" if chunk32 else "general"] += 1
    return x


butterfly_low.launches = 0
butterfly_low.route_launches = {"chunk32": 0, "general": 0}


def mul_tiles_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the stacked Karatsuba of fields/bitsliced.py."""
    return bitsliced.multiply(a, b, HEIGHT)


def _check_rows(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != W:
        raise ValueError(f"{name}: expected (N, {W}) int32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mul_tiles(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[n] = a[n] * b[n] for (N, 128) int32 bit-sliced rows.  On the
    card the kernel moves 16-byte vectors, so an operand that does not
    start on 16 bytes is copied first."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_tiles_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"mul_tiles: unsupported device {a.device}")
    _check_rows("a", a, a.device)
    _check_rows("b", b, a.device)
    if a.shape != b.shape:
        raise ValueError(f"mul_tiles: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    a, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, b))
    out = torch.empty_like(a)
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.bntt_mul_tiles(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                a.shape[0],
                                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mul_tiles")
    mul_tiles.launches += 1
    return out


mul_tiles.launches = 0
