"""Additive NTT over GF(2^128), bit-sliced, on one device (torch).

Port of binius_ntt_tpu/ntt/additive_bitsliced.py::AdditiveNTT128, both of
its paths:

  * an element batch is 32 GF(2^128) values as 128 bit-planes (bit j of
    plane i = bit i of element j) — shape (batches, 128), int32 words with
    uint32 bits (utils/bits.py);
  * stages descend log_h-1 .. 0 (DIT), butterfly u' = u + w*v, v' = u' + v;
  * the input is replicated into 2^log_rate coset rows, giving the
    rate-1/2^log_rate Reed–Solomon extension.

Fused path (log_h >= 6): the host builds the twiddle rows (ntt/additive.py)
and the per-group parity-mask tables (ntt/cuda_fused.py) once, and each
transform runs one stage_group kernel per group.

Per-stage path (log_h = 5, or ``use_fused=False``): one kernel launch per
stage on a (C * nb, 128) working buffer, ``cuda_kernels.butterfly_high``
for the stages s >= 5 that pair whole batches and
``cuda_kernels.butterfly_low`` for the five in-word stages.  The stage
tables are the reference's: for s >= 5 the doubling table of compact
128-bit twiddles in indicator order (one per block), for s < 5 the
doubling table of each row's batch part and the stage's lane part as
bit-planes.  The twiddles stay compact (4 words a value); the kernels
expand them.  Each stage's route (``cuda_kernels.high_subfield`` and
``low_subfield``: its twiddles lie in GF(2^32)) is decided once, when the
tables are made.

Capacity route of ``apply``: the whole-array layout transforms make
several array-sized temporaries (layout/bitslicing.py), so where the peak
they would reach (:func:`whole_array_peak`, from a factor measured on the
card) passes the device's budget (:func:`capacity_budget`), ``apply``
transposes and untransposes in chunks of rows instead
(:func:`streams`).  The reference's gate (a fixed 14e9 bytes, sized for a
15.75 GB TPU) is not carried over.

Not ported: ``use_pallas`` (the tensor's device picks kernel or plain
version).
"""

from __future__ import annotations

import numpy as np
import torch

from ..layout.bitslicing import (CHUNK_ROWS, _pick_chunk,
                                 bitslice_transpose,
                                 bitslice_transpose_streamed,
                                 bitslice_untranspose)
from ..utils.bits import to_torch
from ..utils.capabilities import default_device
from . import cuda_fused, cuda_kernels
from .additive import precompute_subspace_evals
from .nttdata import DataOrder, NTTData

__all__ = ["AdditiveNTT128", "per_stage_tables", "routes",
           "per_stage_steps", "apply_per_stage", "whole_array_peak",
           "capacity_budget", "streams"]

HEIGHT = 7
W = 1 << HEIGHT            # 128 bit-planes
IPV = W // 32              # 4 words per compact value

# Device peak of the whole-array apply from host words
# (max_memory_allocated over the call: the uploaded input and the
# transposes' temporaries, then the output and its untranspose's) over the
# larger of its input and output buffers.  Measured 4.500 at 2^24, 2^26,
# 2^27 and 2^28 r0 and at 2^26 r2, and 4.50 at 2^29 r0
# (tools/torch_capacity.py --checks peaks and chip_smoke.py phase 26, on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit).
WHOLE_ARRAY_PEAK_FACTOR = 4.5
# Rows of a chunk on the capacity route (128 MiB of words).
STREAM_CHUNK_ROWS = CHUNK_ROWS
# Device memory the capacity gate leaves to the caller and the allocator:
# what the caller holds beside the transform (its own input on the device,
# for one) and the caching allocator's fragmentation.
CAPACITY_MARGIN_BYTES = 8 << 30


def whole_array_peak(log_h: int, log_rate: int) -> int:
    """Predicted device peak in bytes of the whole-array ``apply`` at
    (log_h, log_rate): WHOLE_ARRAY_PEAK_FACTOR times the larger of its
    input (2^log_h values of 16 bytes) and its output (2^log_rate times
    that)."""
    return int(WHOLE_ARRAY_PEAK_FACTOR * (16 << (log_h + log_rate)))


def capacity_budget(device) -> float:
    """Bytes a transform on ``device`` may reach: a CUDA device's
    total_memory less CAPACITY_MARGIN_BYTES; unbounded on the CPU, where
    the plain path takes the whole-array route."""
    device = torch.device(device)
    if device.type != "cuda":
        return float("inf")
    total = torch.cuda.get_device_properties(device).total_memory
    return total - CAPACITY_MARGIN_BYTES


def streams(log_h: int, log_rate: int, budget_bytes: float) -> bool:
    """The capacity gate: True when the whole-array peak would pass the
    budget, and ``apply`` streams its layout transforms."""
    return whole_array_peak(log_h, log_rate) > budget_bytes


def _stage_twiddles_multiword(constants_row, num_bits: int) -> np.ndarray:
    """Doubling-construction twiddle table of 128-bit values: (2^bits, 4)."""
    table = np.zeros((1, IPV), dtype=np.uint32)
    for k in range(num_bits):
        c = np.array(
            [(constants_row[k] >> (32 * i)) & 0xFFFFFFFF for i in range(IPV)],
            dtype=np.uint32,
        )
        table = np.concatenate([table, table ^ c[None, :]])
    return table


def per_stage_tables(rows, log_h: int, log_rate: int, device=None,
                     stages=None):
    """The per-stage path's tables, as the reference builds them
    (additive_bitsliced.py:119-146): dicts keyed by stage of int32 tensors
    on ``device`` — high[s] (2^bits, 4) for s >= 5, low_batch[s]
    (2^(bits - lane_bits), 4) and low_lanes[s] (128,) for s < 5, where
    bits = log_h + log_rate - 1 - s.  ``stages``: the stages to build
    (default all)."""
    high, low_batch, low_lanes = {}, {}, {}
    for s in range(log_h) if stages is None else stages:
        bits = log_h + log_rate - 1 - s
        if s >= 5:
            high[s] = to_torch(_stage_twiddles_multiword(rows[s], bits),
                               device)
            continue
        # indicator = coset<<(log_h-1-s) | k<<(4-s) | (j>>(s+1)); lane part:
        # bits m < 4-s from j, batch part: the rest
        lane_bits = min(4 - s, bits)
        lane_vals = np.zeros((32, IPV), dtype=np.uint32)
        for j in range(32):
            v = 0
            jj = j >> (s + 1)
            for m in range(lane_bits):
                if (jj >> m) & 1:
                    v ^= rows[s][m]
            for i in range(IPV):
                lane_vals[j, i] = (v >> (32 * i)) & 0xFFFFFFFF
        low_lanes[s] = bitslice_transpose(to_torch(lane_vals.reshape(W),
                                                   device))
        low_batch[s] = to_torch(_stage_twiddles_multiword(
            rows[s][lane_bits:], bits - lane_bits), device)
    return high, low_batch, low_lanes


def routes(high, low_batch, low_lanes) -> dict:
    """Each stage's route flag, keyed by stage: cuda_kernels.high_subfield
    of a high stage's table, low_subfield of a low stage's (reads the
    tables: a sync on the card)."""
    flags = {s: cuda_kernels.high_subfield(w4) for s, w4 in high.items()}
    flags.update({s: cuda_kernels.low_subfield(low_batch[s], low_lanes[s])
                  for s in low_batch})
    return flags


def per_stage_steps(high, low_batch, low_lanes, *, nb: int, log_rate: int,
                    chunk32: dict | None = None):
    """The per-stage path's launches in order, for nb batches a coset:
    (stage, kernel, plain version, arguments after the working buffer),
    high stages log_h-1 .. 5, then the low stages 4 .. 0.  ``chunk32``:
    the stages' route flags by stage (:func:`routes`, computed here from
    the tables when not given); every stage's arguments end with its
    flag."""
    if chunk32 is None:
        chunk32 = routes(high, low_batch, low_lanes)
    log_h = nb.bit_length() + 4
    cosets = 1 << log_rate
    for s in range(log_h - 1, 4, -1):
        groups = nb >> (s - 4)
        # indicator = coset << (log_h-1-s) | group: the doubling table is in
        # indicator order, one twiddle per block of 2 db rows
        if high[s].shape[0] != cosets * groups:
            raise AssertionError("twiddle table layout mismatch")
        yield (s, cuda_kernels.butterfly_high,
               cuda_kernels.butterfly_high_plain, (high[s], chunk32[s]))
    for s in range(min(log_h - 1, 4), -1, -1):
        # batch part of the indicator: coset << (log_h-1-s-lane_bits) | k
        if low_batch[s].shape[0] != cosets * nb:
            raise AssertionError("twiddle table layout mismatch")
        yield (s, cuda_kernels.butterfly_low, cuda_kernels.butterfly_low_plain,
               (low_batch[s], low_lanes[s], s, chunk32[s]))


def apply_per_stage(data, high, low_batch, low_lanes, *, log_rate: int,
                    chunk32: dict | None = None):
    """Per-stage transform (the reference's ``_apply128``): data (nb, 128)
    bit-sliced -> (cosets * nb, 128).

    The input is copied once per coset into a fresh working buffer, which
    every stage updates in place; ``data`` itself is not modified.  Each
    stage launches its kernel on a CUDA tensor and runs the plain version on
    the CPU.  ``chunk32`` as in :func:`per_stage_steps`.
    """
    x = data.repeat(1 << log_rate, 1)
    for _, kernel, _, args in per_stage_steps(
            high, low_batch, low_lanes, nb=data.shape[0], log_rate=log_rate,
            chunk32=chunk32):
        kernel(x, *args)
    return x


class AdditiveNTT128(torch.nn.Module):
    """Additive NTT over GF(2^128), bit-sliced layout.

    The tables are buffers of this module, made on ``device`` (default
    ``cuda:0``; off the card pass ``device="cpu"``); every call runs on that
    device.  On a CUDA device each group or stage runs its CUDA kernel, on
    the CPU its plain torch version.

    ``use_fused``: None takes the fused path where it applies (log_h >= 6)
    and the per-stage path at log_h = 5; False takes the per-stage path at
    every log_h; True needs log_h >= 6.

    ``apply`` is the transform (it shadows ``nn.Module.apply``, which this
    module, having no submodules, does not need).
    """

    def __init__(self, log_h: int, log_rate: int = 0,
                 use_fused: bool | None = None, device=None):
        super().__init__()
        if not log_h >= 5:
            raise ValueError("log_h must be >= 5 (at least one 32-elem batch)")
        if not 0 <= log_rate <= 4:
            raise ValueError("log_rate must be in [0, 4]")
        if use_fused and log_h < 6:
            raise ValueError("use_fused needs log_h >= 6 (a tile of two "
                             "32-element batches)")
        self.log_h = log_h
        self.log_rate = log_rate
        self.use_fused = log_h >= 6 if use_fused is None else bool(use_fused)
        device = default_device(device)
        rows = precompute_subspace_evals(log_h, log_rate, HEIGHT)
        self._groups = []
        self.chunk32 = {}          # the per-stage path's routes by stage
        if self.use_fused:
            tables = cuda_fused.build_tables(rows, log_h, log_rate, device)
            for g, (t0, k, low, mtile, minst, lanes, zero,
                    chunk32) in enumerate(tables):
                self.register_buffer(f"mtile{g}", mtile)
                self.register_buffer(f"minst{g}", minst)
                self.register_buffer(f"lanes{g}", lanes)
                self._groups.append((t0, k, low, zero, chunk32))
            return
        high, low_batch, low_lanes = per_stage_tables(rows, log_h, log_rate,
                                                      device)
        for s, t in high.items():
            self.register_buffer(f"high{s}", t)
        for s in low_batch:
            self.register_buffer(f"low_batch{s}", low_batch[s])
            self.register_buffer(f"low_lanes{s}", low_lanes[s])
        # decided here so that no transform reads a table on the device
        self.chunk32 = routes(high, low_batch, low_lanes)

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    @property
    def tables(self):
        """The fused path's per-group tables in cuda_fused.build_tables()
        form (empty on the per-stage path)."""
        return tuple(
            (t0, k, low, getattr(self, f"mtile{g}"),
             getattr(self, f"minst{g}"), getattr(self, f"lanes{g}"), zero,
             chunk32)
            for g, (t0, k, low, zero, chunk32) in enumerate(self._groups))

    @property
    def stage_tables(self):
        """The per-stage path's tables (high, low_batch, low_lanes), dicts
        keyed by stage as per_stage_tables() gives them (empty on the fused
        path)."""
        if self.use_fused:
            return {}, {}, {}
        lows = range(min(self.log_h, 5))
        return ({s: getattr(self, f"high{s}")
                 for s in range(5, self.log_h)},
                {s: getattr(self, f"low_batch{s}") for s in lows},
                {s: getattr(self, f"low_lanes{s}") for s in lows})

    def stage_steps(self):
        """The per-stage path's launches in order, as per_stage_steps()
        gives them for this module's tables."""
        if self.use_fused:
            raise ValueError("stage_steps: this transform takes the fused "
                             "path")
        return per_stage_steps(*self.stage_tables,
                               nb=(1 << self.log_h) // 32,
                               log_rate=self.log_rate,
                               chunk32=self.chunk32)

    def apply_sliced(self, data: torch.Tensor) -> torch.Tensor:
        """data: (2^log_h/32, 128) int32 bit-sliced IN_ORDER input on the
        module's device, left unchanged.  Returns (2^(log_h+log_rate)/32,
        128)."""
        nb = (1 << self.log_h) // 32
        if (data.dtype != torch.int32 or tuple(data.shape) != (nb, W)
                or data.device != self.device):
            raise ValueError(
                f"apply_sliced: expected ({nb}, {W}) int32 on "
                f"{self.device}, got {tuple(data.shape)} {data.dtype} on "
                f"{data.device}")
        if self.use_fused:
            return cuda_fused.apply_fused(data.contiguous(), self.tables,
                                          log_rate=self.log_rate)
        return apply_per_stage(data, *self.stage_tables,
                               log_rate=self.log_rate,
                               chunk32=self.chunk32)

    def apply(self, x_words):
        """Compact interface: (2^log_h * 4,) words, little-endian
        element-major (numpy uint32 or an int32 tensor) -> int32 tensor of
        (2^(log_h+log_rate) * 4,) words on the module's device.

        Accepts an NTTData wrapper (IN_ORDER required)."""
        if isinstance(x_words, NTTData):
            if x_words.order is not DataOrder.IN_ORDER:
                raise ValueError("AdditiveNTT128.apply requires IN_ORDER "
                                 "input")
            return NTTData(self.apply(x_words.data), DataOrder.IN_ORDER)
        n = 1 << self.log_h
        if isinstance(x_words, torch.Tensor):
            if x_words.dtype != torch.int32:
                raise ValueError(f"apply: expected int32 words, got "
                                 f"{x_words.dtype}")
            x = x_words
        else:
            x = to_torch(np.asarray(x_words, dtype=np.uint32))
        if tuple(x.shape) != (n * IPV,):
            raise ValueError(
                f"apply: input shape {tuple(x.shape)} != (2^log_h * {IPV},) "
                f"= ({n * IPV},)")
        x = x.reshape(n // 32, W)
        if streams(self.log_h, self.log_rate, capacity_budget(self.device)):
            return self._apply_streamed(x)
        sliced = bitslice_transpose(x.to(self.device))
        out = self.apply_sliced(sliced)
        del sliced
        return bitslice_untranspose(out).reshape(-1)

    def _apply_streamed(self, x: torch.Tensor) -> torch.Tensor:
        """The capacity route: x (2^log_h/32, 128) unbitsliced rows, on
        the host or the device, is uploaded and transposed chunk by chunk
        into the sliced input; the sliced input is dropped once the
        transform has run; the output is untransposed chunk by chunk in its
        own buffer (each row is its own 32 x 128 transpose), so no second
        output-sized tensor is made."""
        sliced = bitslice_transpose_streamed(x, STREAM_CHUNK_ROWS,
                                             device=self.device)
        out = self.apply_sliced(sliced)
        del sliced
        chunk = _pick_chunk(out.shape[0], STREAM_CHUNK_ROWS)
        for i in range(0, out.shape[0], chunk):
            out[i:i + chunk] = bitslice_untranspose(out[i:i + chunk])
        return out.reshape(-1)
