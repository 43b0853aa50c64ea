"""Classical radix-2 DIF NTT over a 32-bit prime field (BB31) — torch.

Port of binius_ntt_tpu/ntt/radix2.py: the same transform as the
reference's ``NTT<BB31>`` (src/ulvt/ntt/gpuntt.cuh:126-209):

  * twiddles: n/2 powers of omega = g^(2^(log_group_order - log_n)), stored
    in bit-reversed order (gpuntt.cuh:139-143, 186-204), in the field's
    internal form (Montgomery for BB31);
  * input is bit-reversed if IN_ORDER (gpuntt.cuh:163-168);
  * stages ascend 0 .. log_n-1; at stage s the butterflies pair (i, i + 2^s)
    within blocks of 2^(s+1), block b taking twiddle tw[b]
    (gpuntt.cuh:54-63, 111-118);
  * butterfly U = u + v ; V = (u - v) * w (gpuntt.cuh:39-44).

Words are int32 tensors with uint32 bits (utils/bits.py).  ``FieldOps``
makes the transform generic over any prime field below 2^32, as the
reference's ``NTT<E>`` template is; its device ops take and return int32
words.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..fields import baby_bear as bb
from ..utils.bits import to_torch
from ..utils.capabilities import default_device
from . import cuda_fused_bb31
from .cuda_fused_bb31 import bit_reverse_indices
from .nttdata import DataOrder, NTTData

__all__ = ["NTTRadix2", "FieldOps", "BB31_OPS", "make_modp_ops",
           "bit_reverse_indices"]


class FieldOps(NamedTuple):
    """Field-op bundle making NTTRadix2 generic over any <= 32-bit prime
    field — the analogue of the reference's ``NTT<E>`` template parameter
    (gpuntt.cuh:126-131, ``sizeof(E) <= 4``).  Device ops act on the
    field's *internal* representation (Montgomery form for BB31) as int32
    words; encode/decode convert canonical words <-> internal."""

    p: int                        # field modulus
    add: Callable                 # device: internal x internal -> internal
    sub: Callable
    mul: Callable
    encode: Callable              # device: canonical -> internal
    decode: Callable              # device: internal -> canonical
    encode_host: Callable         # numpy: canonical -> internal
    pow_host: Callable            # python ints: x^n mod p


BB31_OPS = FieldOps(p=bb.P, add=bb.add, sub=bb.sub, mul=bb.mont_mul,
                    encode=bb.encode, decode=bb.decode,
                    encode_host=bb.encode_host, pow_host=bb.pow_host)


def make_modp_ops(p: int) -> FieldOps:
    """Plain modular FieldOps for a small odd prime p < 2^16 (no Montgomery
    form: the internal representation is the canonical residue).  The
    bound is the reference's, which keeps every product inside uint32; the
    port computes in int64 either way.  Instantiates the radix-2 NTT over
    toy 2-adic fields in tests; BB31 remains the only fused
    configuration."""
    if not 2 < p < (1 << 16):
        raise ValueError("make_modp_ops is for toy primes < 2^16")

    def wide(a):
        return a.to(torch.int64) & 0xFFFFFFFF

    def add(a, b):
        return ((wide(a) + wide(b)) % p).to(torch.int32)

    def sub(a, b):
        return ((wide(a) - wide(b)) % p).to(torch.int32)

    def mul(a, b):
        return (wide(a) * wide(b) % p).to(torch.int32)

    def encode(x):
        return (wide(x) % p).to(torch.int32)   # wraps like BB31's ctor

    def decode(x):
        return x

    def pow_host(x: int, n: int) -> int:
        return pow(int(x), int(n), p)

    def encode_host(v):
        return np.asarray(v, dtype=np.uint32) % np.uint32(p)

    return FieldOps(p=p, add=add, sub=sub, mul=mul, encode=encode,
                    decode=decode, encode_host=encode_host,
                    pow_host=pow_host)


def _geometric_powers(base: int, count: int, p: int) -> np.ndarray:
    """[1, base, base^2, ...] mod p, vectorised by doubling."""
    out = np.array([1], dtype=np.uint64)
    step = base % p
    while out.size < count:
        out = np.concatenate([out, (out * np.uint64(step)) % np.uint64(p)])
        step = (step * step) % p
    return out[:count].astype(np.uint32)


class NTTRadix2(torch.nn.Module):
    """Radix-2 NTT over a 32-bit prime field (BB31 by default) with
    generator ``generator`` of order 2^log_group_order.

    The twiddle table is a buffer of this module, made on ``device``
    (default ``cuda:0``; off the card pass ``device="cpu"``); every call
    runs on that device.  ``field_ops`` injects the field (cf. the
    reference's ``NTT<E>`` template, gpuntt.cuh:126-131).

    Two paths, chosen by the field and the device, never by a failure:

      * fused: the stage groups of ``cuda_fused_bb31.apply_fused_r2``,
        encode and bit reversal folded into the first group and decode
        into the last.  On a CUDA device the default BB31 field always
        takes it, and each group launches the kernel of
        csrc/stage_group_r2.cu, which takes every log_n.  On the CPU the
        groups run their plain torch version, where the reference's gate
        (radix2.py:147-150) chooses this path: ``log_n >= 7`` with the
        default field, unless ``use_fused=False``.
      * per-stage: an injected field on any device, or the rest of the CPU
        cases — one whole-tensor butterfly stage at a time with the field's
        ops (``cuda_fused_bb31.stage_group_r2_plain`` over all log_n
        stages), the reference's own non-kernel configuration.  No kernel
        exists for an injected field.

    Left out: the reference's ``per_stage_jit`` and its transposed
    small-span stages (radix2.py:179-183, 203-225), which work around XLA
    compile times and padding.

    ``apply`` is the transform (it shadows ``nn.Module.apply``, which this
    module, having no submodules, does not need).
    """

    def __init__(self, generator: int, log_group_order: int, log_n: int,
                 use_fused: bool | None = None,
                 field_ops: FieldOps | None = None, device=None):
        super().__init__()
        # validation mirrors NTTConfRad2 (nttconf.cuh:32-39)
        if not 1 <= log_n <= 27:
            raise ValueError("log_n must be in [1, 27]")
        if not log_group_order >= log_n:
            raise ValueError("log_group_order must be >= log_n")
        device = default_device(device)
        self.log_n = log_n
        n = 1 << log_n
        ops = BB31_OPS if field_ops is None else field_ops
        self._ops = ops

        omega = ops.pow_host(generator, 1 << (log_group_order - log_n))
        tw = _geometric_powers(omega, n // 2, ops.p)
        # bit-reverse with idx_size = log_n - 1 (gpuntt.cuh:141-142)
        if log_n > 1:
            tw = tw[bit_reverse_indices(log_n - 1, "cpu").numpy()]
        self.register_buffer("tw", to_torch(ops.encode_host(tw), device))
        self.use_fused = ops is BB31_OPS and (
            device.type != "cpu" or (use_fused is not False and log_n >= 7))

    @property
    def device(self) -> torch.device:
        return self.tw.device

    def apply(self, x, input_bit_reversed: bool = False):
        """x: (2^log_n,) canonical words (numpy uint32, or an int32 tensor
        on the module's device) -> int32 tensor of the IN_ORDER transform
        output, on the module's device.  ``x`` is left as it is.

        ``input_bit_reversed=False`` matches DataOrder::IN_ORDER (the
        transform bit-reverses first, gpuntt.cuh:163-168).  An NTTData
        wrapper is accepted in place of the flag and returned with the
        output's order (always IN_ORDER — gpuntt.cuh:180 labels it so)."""
        if isinstance(x, NTTData):
            out = self.apply(
                x.data,
                input_bit_reversed=(x.order is DataOrder.BIT_REVERSED))
            return NTTData(out, DataOrder.IN_ORDER)
        n = 1 << self.log_n
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.int32 or x.device != self.device:
                raise ValueError(f"apply: expected int32 words on "
                                 f"{self.device}, got {x.dtype} on "
                                 f"{x.device}")
        else:
            x = to_torch(np.asarray(x, dtype=np.uint32), self.device)
        if tuple(x.shape) != (n,):
            raise ValueError(f"apply: input shape {tuple(x.shape)} != "
                             f"(2^log_n,) = ({n},)")
        x = x.contiguous()
        if self.use_fused:
            return cuda_fused_bb31.apply_fused_r2(
                x, self.tw, log_n=self.log_n,
                input_bit_reversed=input_bit_reversed)
        if input_bit_reversed:
            out, src = x.clone(), None
        else:
            out, src = torch.empty_like(x), x
        return cuda_fused_bb31.stage_group_r2_plain(
            out, self.tw, s0=0, k=self.log_n, log_n=self.log_n,
            encode_in=True, decode_out=True, src=src, ops=self._ops)
