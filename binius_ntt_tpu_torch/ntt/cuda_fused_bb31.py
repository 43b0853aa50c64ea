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
columns in shared memory, at most 2^TILE_LOG words, runs the group's k
stages on it with a barrier between stages, and reads each twiddle from
the compact table by index.  The plan (``plan_groups_r2``) cuts the
log_n stages into groups of KB, then KU: at 2^24 three launches.
"""

from __future__ import annotations

import torch

from .. import _build
from ..fields import baby_bear as bb

__all__ = ["KB", "KU", "TILE_LOG", "plan_groups_r2", "tile_columns",
           "bit_reverse_indices", "stage_group_r2", "stage_group_r2_plain",
           "apply_fused_r2"]

# A block's tile: 2^TILE_LOG words (16 KB of shared memory).  The first
# group takes 2^KB consecutive words; an upper group takes 2^KU rows of
# 2^(TILE_LOG - KU) consecutive columns, 64 bytes, so its loads and stores
# stay whole sectors.  Any plan gives identical output bits.
TILE_LOG = 12
KB = 12
KU = 8


def plan_groups_r2(log_n: int) -> list[tuple[int, int]]:
    """Split the stages 0 .. log_n-1 into (s0, k) groups, in execution
    order (DIF ascends)."""
    groups = []
    s0 = 0
    while s0 < log_n:
        k = min(log_n - s0, KB if s0 == 0 else KU)
        groups.append((s0, k))
        s0 += k
    return groups


def tile_columns(s0: int, k: int) -> int:
    """log2 of the consecutive columns a block of the kernel takes for the
    group (s0, k): as many as fill the tile, at most 2^s0."""
    return max(min(TILE_LOG - k, s0), 0)


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
    flags = int(encode_in) | int(decode_out) << 1 | int(src is not None) << 2
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.bntt_stage_group_r2(
            x.data_ptr(), (x if src is None else src).data_ptr(),
            tw.data_ptr(), log_n, s0, k, tile_columns(s0, k), flags,
            torch.cuda.current_stream().cuda_stream)
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
