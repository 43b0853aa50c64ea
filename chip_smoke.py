#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (binius_ntt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one Hopper GPU (sm_90) and
the CUDA toolkit.  Phases, one line each, in order; any failure ends the
run with a non-zero exit and no result line:

  1. device   — a CUDA device of capability (9, 0), its name and power limit;
  2. build    — the kernels of binius_ntt_tpu_torch/csrc built by nvcc,
     then the stack frame, spills and registers of the sumcheck kernels,
     of every butterfly_high_kernel, butterfly_low_kernel,
     stage_group32_kernel and mul_compact_kernel instantiation and of
     stage_group_r2_kernel, bitslice_lane_groups_kernel and
     mul_tiles_kernel as ptxas reports them, a line each;
  3. mul_tiles   — (on the sharded path of phase 24) kernel vs its plain
     torch version on the card at 2^18 + 5
     rows (a partial last tile), 2^18 and 2^19 rows, word-equal; then the
     last two timed with CUDA events (one call, and a call in a run of 10
     back to back) beside the plain version and the bound;
  4. stage_group — kernel vs plain, group by group, at log_h 16 (rates 0
     and 2, production plan) and at (9, 1) and (12, 0) with a forced
     multi-group plan (KB = KU = PT = 2), all on the CHUNK32 route; then
     each instantiation through a whole plan of random tables at (16, 0)
     and at (12, 0) under the forced plan: the general one with planes
     >= 32 set, CHUNK32 with random GF(2^32) twiddles;
  5. main path — AdditiveNTT128(24, r).apply on mt19937 input for r = 0, 2,
     held to the native oracle's golden MD5 digests, with every launch
     counter reset just before and read just after; every group must take
     the CHUNK32 route, and the launches per route are printed;
  6. timing   — stage groups at 2^24, rates 0 and 2: first the kernel vs
     plain, group by group on the chain's input, at the main path's shapes;
     then with CUDA events the kernel on its CHUNK32 route (the chain and
     each group alone), the
     general instantiation on the earlier default plan (8, 8, 8), the
     kernel before the CHUNK32 route, held word-equal to it, apply_sliced,
     and at rate 0 the plain version;
  7. sumcheck_kernels — the sumcheck round and fold kernels vs their plain
     versions at every round of num_vars 12 and 20, C = 2, 3, 4: every
     live row count, then the in-word rounds (rows = 1, lanes 32 .. 1);
  8. sumcheck_main — the second path: Sumcheck(mt19937 words, C, 24) for
     C = 2, 3, 4 through all 24 rounds, every transcript held to the
     verifier's checks, with every launch counter reset just before and
     read just after; at C = 2 the same protocol through the plain
     versions must give the same transcript; then the num_vars-20
     transcripts against the digests the JAX package minted
     (tests/test_torch_sumcheck_golden.py);
  9. sumcheck_timing — the first round's round and fold at 2^24, each held
     word-equal to its plain version on the same input and then timed
     beside it (CUDA events), and the whole protocol from device-resident
     input (host clock with a synchronise), C = 2, 3, 4;
 10. ntt32_kernels — the GF(2^32) NTT's kernels vs their plain versions:
     bitslice_lane_groups on 2^17 random rows (and its own inverse), and
     stage_group32 group by group at (16, 0) and (16, 2) under the
     production plan and at (7, 0), (7, 2), (11, 4) and (13, 2) under a
     forced multi-group plan (KB = KU = 2), each chained output held
     to the upstream golden MD5 where one exists;
 11. ntt32_main — the third path: AdditiveNTT(24, r).apply on mt19937
     input for r = 0, 2, held to the upstream golden MD5 digests
     (tests/golden_hashes.py), with every launch counter reset just before
     and read just after;
 12. ntt32_timing — at 2^24, input on the device: first, for r = 0 and
     2, both kernels held word-equal to their plain versions at the main
     path's shapes (the lane-group transpose on the 2^17 input rows and on
     the cosets * 2^17 output rows, stage_group32 group by group); then,
     with CUDA events, the stage-group chain, kernel vs plain, and each
     group alone, at r = 0 and 2; apply at r = 0 and 2; the lane-group
     transpose alone on 2^17 and 2^19 random rows (the input's and the
     rate-2 output's), each held word-equal to plain, then kernel vs plain
     timed, with its share of the bound;
     and the compact torch path (use_fused=False) as the whole-transform
     plain figure;
 13. bb31_kernels — the BB31 NTT's stage_group_r2 vs its plain version group
     by group at log_n 1 .. 6 and 16 under the production plan and at log_n
     7, 10 and 13 under a forced small plan (KB = KU = 2), each chained
     output held to the upstream golden MD5 (tests/golden_hashes.py);
 14. bb31_main — the fourth path: NTTRadix2(137, 27, 24).apply and
     NTTRadix2(137, 27, 27).apply on the upstream mt19937 inputs, held to
     the golden MD5 digests, then the forward/inverse round trip at 2^24
     (inverse with 137^-1, then 1/n) giving back the input mod P, with
     every launch counter reset just before and read just after;
 15. bb31_timing — first the kernel held word-equal to plain group by
     group at every shape of the main path (its 2^24 and 2^27 inputs and
     plans); then at 2^24, input on the device, with CUDA events: the
     chain, kernel vs plain; apply from device words; the first group with
     and without its bit-reversing load; and the per-stage torch path (one
     plain group over all 24 stages) as the whole-transform plain figure;
     then the 2^27 chain and each of its groups alone, each beside its
     bound;
 16. qm31_kernels — the QM31 sumcheck round and fold kernels vs their plain
     versions at every live row count of num_vars 12 and 20;
 17. qm31_main — the fifth path: PrimeFieldSumcheck on 2 x 2^24 mt19937 QM31
     values mod P through all 24 rounds, every round held to the host
     check, with every launch counter reset just before and read just
     after; the same protocol through the plain versions must give the
     same transcript; then the num_vars-20 transcript against the digest
     the JAX package minted (tests/test_torch_prime_sumcheck_golden.py);
 18. qm31_timing — the first round's round and fold at 2^24, each held
     word-equal to its plain version on the timed input and then timed
     beside it (CUDA events), and the whole protocol from device-resident
     state (host clock with a synchronise per round, median of 3);
 19. butterfly_kernels — the per-stage GF(2^128) NTT's butterfly_high and
     butterfly_low vs their plain versions stage by stage, word-equal after
     every stage, at log_h 5 with rates 0..4 (the size only this path
     takes; one row at rate 0) and at (12, 0), (12, 2) and (16, 2); each
     chained output held to the golden MD5 where the table has one, else
     (log_h 5 at rates 1, 3, 4) to the scalar oracle (ntt/reference.py);
     then butterfly_high on both routes on random rows and tables at
     (rows, db) = (2, 1), (6, 1), (48, 8), (32, 16), (64, 32), (4096,
     1024) and (65536, 2), and butterfly_low on both routes at every stage
     on random rows (1, 2, 3 and 4096) and random tables, GF(2^32) ones
     for the CHUNK32 routes and ones with every plane set for the general
     routes;
 20. per_stage_main — the sixth path: AdditiveNTT128(24, r,
     use_fused=False).apply on the mt19937 inputs of phase 5 for r = 0, 2,
     held to the golden MD5 digests, and AdditiveNTT128(5, r).apply with
     the default device and use_fused for r = 0..4, held to the digest or
     the scalar oracle; every launch counter reset just before each call
     and read just after (19 butterfly_high and 5 butterfly_low launches
     at log_h 24, none of stage_group), every stage on the CHUNK32
     route;
 21. per_stage_timing — at 2^24, input on the device, r = 0 and 2, CUDA
     events: every stage of the per-stage chain alone (each printed with
     its route and its share of the bound), the whole chain
     (apply_sliced), the fused apply_sliced on the same input, and the top
     high stage and the top low stage each held word-equal to its plain
     version on its chain input and then timed beside it (the plain
     versions go over the rows in chunks of 2^16, cuda_kernels.PLAIN_CHUNK,
     so their Karatsuba intermediates stay near 2 GB);
 22. compact_mul — the compact tower multiply: mul_compact_tiles at N = 2^24
     elements for heights 5, 6 and 7 (the seventh path, with the counters
     reset just before and read just after), each word-equal to
     mul_compact on the card and held on 4096 sampled products to the
     scalar oracle, the reference's 128-bit vector, then kernel vs plain
     timed with CUDA events, with the kernel's share of the bound;
 23. sharded_kernels — stage_group with every shard's dplanes (the device
     bits' part of each twiddle) vs its plain version, group by group on
     each shard's block of the mt19937 input, for every shard of 4 and 8,
     at log_h 16 (rates 0 and 2, production plan) and at (12, 0) under the
     forced plan; both routes with random tables and random corrections;
     mul_tiles at the cross-device stages' shapes vs plain;
 24. sharded_main — the eighth path, parallel/ on LocalMesh(4) on the card:
     ShardedAdditiveNTT128(24, r) for r = 0, 2 on phase 5's inputs, held
     to the golden MD5 digests, with every launch counter reset just
     before and read just after (every stage_group launch with dplanes on
     the CHUNK32 route, mul_tiles on the cross-device stages);
     ShardedSumcheck at 2^24 for C = 2, 3, 4, each transcript through the
     verifier and equal to phase 8's, and at num_vars 20 against the JAX
     digests; ShardedPrimeFieldSumcheck at 2^24 equal to phase 17's
     transcript; ShardedAdditiveNTT(24, 0) against the upstream golden
     digest; dryrun_multichip(8) on the card; then the NTT128 at r = 0, 2
     through a real world-size-1 NCCL process group (a file:// store),
     held to the digests;
 25. sharded_timing — CUDA events at 2^24, r = 0 and 2, on LocalMesh(4):
     the sharded apply_sliced beside the single-device one on the same
     input, the shards' local stage-group chains with and without dplanes,
     and the cross-device stages alone;
 26. capacity — the first 2^31-word buffers: AdditiveNTT128(29, 0).apply
     on 2^31 mt19937 words from the native oracle (utils/native_oracle.py,
     built with g++; the phase fails if it does not build), through the
     capacity gate of ntt/additive_bitsliced.py, with every launch counter
     reset just before and read just after (every stage_group launch on
     the CHUNK32 route), held to the golden MD5 fed chunk by chunk from
     device slices; then the same input through the streamed transforms
     (bitslice_transpose_streamed, apply_sliced,
     bitslice_untranspose_streamed), word-equal to apply's output; one line
     each for the gate's route, the device's peak memory over apply, and a
     PhaseTimer report (input, apply, hash, streamed, compare).

Then three lines: the kernels as JSON, the card's name and power limit
from nvidia-smi, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Every comparison is exact word equality (finite-field arithmetic has no
rounding).  Each kernel's bound_ms is the larger of its operations over
their peak rate (the int32 pipe for the GF(2) circuits, counted as
three-input LOP3 operations; the card's instruction rate for the
prime-field kernels) and its bytes (each input read once, each output
written once) over the memory rate, from the shapes of the timed call.
The operations are those of the cheapest formulation the repo has: a
GF(2^128) product by a twiddle in GF(2^32) is four GF(2^32) products (every
twiddle of these transforms lies there), a low butterfly stage needs only
the products of the lanes that reach its output, half of them, as a high
stage does, and a compact product costs the bit-sliced multiply plus the
32 x 32 transposes of its operands and result into and out of the
bit-sliced layout.  No
single PyTorch call computes any of these functions, so library_ms is null.
The script imports no JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from binius_ntt_tpu_torch import (  # noqa: E402
    AdditiveNTT, AdditiveNTT128, NTTRadix2, PrimeFieldSumcheck, Sumcheck,
    _build)
from binius_ntt_tpu_torch.fields import baby_bear as bb  # noqa: E402
from binius_ntt_tpu_torch.fields import tower_compact as tc  # noqa: E402
from binius_ntt_tpu_torch.fields import tower_scalar as ts  # noqa: E402
from binius_ntt_tpu_torch.layout.bitslicing import (  # noqa: E402
    bitslice_transpose, bitslice_transpose_streamed, bitslice_untranspose,
    bitslice_untranspose_streamed)
from binius_ntt_tpu_torch.ntt import additive_bitsliced as ab  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_fused as cf  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_fused32 as cf32  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_fused_bb31 as cfb  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck  # noqa: E402
from binius_ntt_tpu_torch.ntt.additive import (  # noqa: E402
    precompute_subspace_evals)
from binius_ntt_tpu_torch.ntt.reference import (  # noqa: E402
    additive_ntt_scalar)
from binius_ntt_tpu_torch.entry import dryrun_multichip  # noqa: E402
from binius_ntt_tpu_torch.parallel.mesh import (  # noqa: E402
    DistMesh, initialize_distributed, make_mesh, shutdown_distributed)
from binius_ntt_tpu_torch.parallel.ntt128_sharded import (  # noqa: E402
    ShardedAdditiveNTT128, shard_dplanes)
from binius_ntt_tpu_torch.parallel.ntt_sharded import (  # noqa: E402
    ShardedAdditiveNTT)
from binius_ntt_tpu_torch.parallel.prime_sharded import (  # noqa: E402
    ShardedPrimeFieldSumcheck)
from binius_ntt_tpu_torch.parallel.sumcheck_sharded import (  # noqa: E402
    ShardedSumcheck)
from binius_ntt_tpu_torch.sumcheck import (  # noqa: E402
    cuda_prime_round as cpr)
from binius_ntt_tpu_torch.sumcheck import cuda_round as cr  # noqa: E402
from binius_ntt_tpu_torch.sumcheck import verifier  # noqa: E402
from binius_ntt_tpu_torch.sumcheck.prime_field import (  # noqa: E402
    check_transcript)
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch  # noqa: E402
from binius_ntt_tpu_torch.utils.capabilities import (  # noqa: E402
    check_capabilities)
from binius_ntt_tpu_torch.utils import native_oracle  # noqa: E402
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream  # noqa: E402
from binius_ntt_tpu_torch.utils.timing import PhaseTimer  # noqa: E402

SEED = 0xDEADBEEF
W = 128
SUMCHECK_SEED = 0x5C0024        # the 2^24 sumcheck inputs and challenges
COMPS = (2, 3, 4)               # the reference's composition sizes
QM31_SEED = 0x3131024            # the 2^24 QM31 inputs and challenges
# stage-group chain of the single-device 2^24 transform at rates 0 and 2,
# ms, as recorded before the dplanes operand (PERF.md §6, row 1), printed
# beside phase 6's times
EARLIER_CHAIN_MS = {0: 3.418, 2: 13.611}
COUNTED = (ck.mul_tiles, cf.stage_group, cr.round_kernel, cr.fold_kernel,
           cf32.bitslice_lane_groups, cf32.stage_group32, cfb.stage_group_r2,
           cpr.round_kernel, cpr.fold_kernel, ck.butterfly_high,
           ck.butterfly_low, tc.mul_compact_tiles)
# ptxas's entry names of the GF(2^128) sumcheck kernels: a template's name
# with the start of its mangled arguments (ILb0E: the fold's <false>, row
# folds; ILb1E: <true>, in-word folds)
SUMCHECK_KERNELS = ("sumcheck_round_kernel", "sumcheck_fold_kernelILb0E",
                    "sumcheck_fold_kernelILb1E")
# and of butterfly_low_kernel<S, CHUNK32> (ILi4ELb1E: <4, true>), the
# CHUNK32 route's five first
BUTTERFLY_LOW_KERNELS = tuple(f"butterfly_low_kernelILi{s}ELb{c}E"
                              for c in (1, 0) for s in range(4, -1, -1))
# and of butterfly_high_kernel<CHUNK32>, the CHUNK32 route's first
BUTTERFLY_HIGH_KERNELS = ("butterfly_high_kernelILb1E",
                          "butterfly_high_kernelILb0E")
# and of stage_group32_kernel<LOW>: the upper groups', the bottom group's
STAGE_GROUP32_KERNELS = ("stage_group32_kernelILb0E",
                         "stage_group32_kernelILb1E")
# and of mul_compact_kernel<H> (ILi7E: <7>), and the lane-group transpose
MUL_COMPACT_KERNELS = tuple(f"mul_compact_kernelILi{h}E" for h in (5, 6, 7))
# and of stage_group_kernel<CHUNK32, DPL> (ILb1ELb0E: <true, false>, the
# single-device CHUNK32 route; DPL: with the sharded path's dplanes)
STAGE_GROUP_KERNELS = tuple(f"stage_group_kernelILb{c}ELb{d}E"
                            for c in (1, 0) for d in (0, 1))
LANES_KERNEL = "bitslice_lane_groups_kernel"
MUL_TILES_KERNEL = "mul_tiles_kernel"

# The card's peaks for bound_ms (data-sheet estimates at 1.98 GHz): integer
# logic on the int32 pipe (132 SMs x 64 lanes), the rate of the GF(2)
# circuits' AND and XOR; the instruction rate (132 SMs x 4 warp
# instructions a clock x 32 lanes), the ceiling of the prime-field
# kernels' mixed work, whose integer multiplies run on the FMA pipe beside
# the int32 pipe; and HBM3 bytes per second.
INT_OPS_PER_S = 1.67e13
INSTR_OPS_PER_S = 3.35e13
BYTES_PER_S = 3.35e12


def tower_mul_ops(h: int) -> int:
    """Operations of one bit-sliced GF(2^(2^h)) multiply (32 products) as
    the card issues them.  The circuit of csrc/tower_mul.cuh, two-input AND
    and XOR gates (13,448 at h = 7, 1,388 at h = 5), is covered by
    three-input LOP3 operations: a gate folds into a gate that reads it
    while the fold still reads at most three values, and a gate is issued
    only if an output or an issued gate reads it.  The cover is greedy: the
    card can reach the count, which is not proven least."""
    n_in, gates = 2 << h, []

    def gate(a, b):
        gates.append((a, b))
        return n_in + len(gates) - 1

    def alpha(x):                       # tower::mul_alpha
        if len(x) == 1:
            return list(x)
        half = len(x) // 2
        t = alpha(x[half:])
        return x[half:] + [gate(x[i], t[i]) for i in range(half)]

    def mul(a, b):                      # tower::mul_body
        if len(a) == 1:
            return [gate(a[0], b[0])]
        half = len(a) // 2
        sa = [gate(a[i], a[half + i]) for i in range(half)]
        sb = [gate(b[i], b[half + i]) for i in range(half)]
        z0, z2 = mul(a[:half], b[:half]), mul(a[half:], b[half:])
        zm, z2a = mul(sa, sb), alpha(z2)
        lo = [gate(z0[i], z2[i]) for i in range(half)]
        return lo + [gate(gate(zm[i], lo[i]), z2a[i]) for i in range(half)]

    w = 1 << h
    out = mul(list(range(w)), list(range(w, 2 * w)))
    reads = []                          # what each gate's LOP3 reads
    for a, b in gates:
        r = {a, b}
        for c in (a, b):
            if c >= n_in and c in r:
                folded = (r - {c}) | reads[c - n_in]
                if len(folded) <= 3:
                    r = folded
        reads.append(r)
    issued, todo = set(), [g for g in out if g >= n_in]
    while todo:
        g = todo.pop()
        if g not in issued:
            issued.add(g)
            todo.extend(c for c in reads[g - n_in] if c >= n_in)
    return len(issued)


# Word operations per unit of work: a bit-sliced multiply of 32 GF(2^128)
# or of 32 GF(2^32) values (tower_mul_ops); a BB31 butterfly (a modular add
# and subtract, three operations each, and a Montgomery product of nine:
# the wide multiply, two more multiplies, two adds, the carry test and the
# conditional subtract); a QM31 Karatsuba product (9 M31 products of 10
# operations, 29 modular adds and subtracts of 3); a 32 x 32 bit transpose
# of 32 words (5 levels x 32 words x a shift and one LOP3; the shuffles
# move no data through the int32 pipe and are not counted).
MUL128_OPS, MUL32_OPS = tower_mul_ops(7), tower_mul_ops(5)
TRANSPOSE32_OPS = 5 * 32 * 2
BB31_ADD_OPS, BB31_MUL_OPS = 3, 9
QM31_MUL_OPS = 9 * 10 + 29 * 3


def bound(ops: float, nbytes: float, rate: float = INT_OPS_PER_S) -> dict:
    """The least time the card could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = ops / rate, nbytes / BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def sumcheck_bounds(comp: int, batches: int) -> dict:
    """Bounds of the GF(2^128) sumcheck's first round and fold over
    ``batches`` live batches: a round multiplies (C - 1) * (C + 1) times a
    row pair and reads C rows of each half; a fold multiplies C times a row
    pair and writes C rows."""
    return {
        "round": bound(batches // 2 * (comp - 1) * (comp + 1) * MUL128_OPS,
                       comp * batches * W * 4),
        "fold": bound(comp * batches // 2 * MUL128_OPS,
                      comp * batches * W * 4 + comp * batches // 2 * W * 4)}


def run_time(fn, *args, calls: int = 10) -> float:
    """Seconds a call of fn(*args) in a run of ``calls`` back to back: the
    host's share of a short launch (the wrapper between the events of a
    single call) is hidden behind the calls before it."""
    def run():
        for _ in range(calls):
            fn(*args)
    return device_time(run) / calls


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over the words read as uint32 (0 iff equal)."""
    da = a.to(torch.int64) & 0xFFFFFFFF
    db = b.to(torch.int64) & 0xFFFFFFFF
    return int((da - db).abs().max().item())


def md5_words(t: torch.Tensor) -> str:
    return hashlib.md5(to_numpy(t).astype("<u4").tobytes()).hexdigest()


def md5_chunked(t: torch.Tensor, chunk: int = 1 << 26) -> str:
    """md5_words of a large device tensor, fed a host copy of ``chunk``
    words (256 MiB) at a time."""
    flat, h = t.reshape(-1), hashlib.md5()
    for i in range(0, flat.numel(), chunk):
        h.update(memoryview(to_numpy(flat[i:i + chunk])))
    return h.hexdigest()


def load_test_file(name: str):
    """A JAX-free module of tests/, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def golden_table():
    return load_test_file("golden_hashes_oracle").ADDITIVE_NTT128_HASHES


def golden32_table():
    return load_test_file("golden_hashes").ADDITIVE_NTT_HASHES


def reset_counts() -> None:
    for wrapper in COUNTED:
        wrapper.launches = 0
    cf.stage_group.route_launches = {"chunk32": 0, "general": 0}
    cf.stage_group.dplanes_launches = 0
    ck.butterfly_high.route_launches = {"chunk32": 0, "general": 0}
    ck.butterfly_low.route_launches = {"chunk32": 0, "general": 0}


def mul_ops(subfield: bool) -> int:
    """Operations of 32 GF(2^128) products by twiddles: four GF(2^32)
    products when the twiddles lie in that subfield, else one GF(2^128)
    product."""
    return 4 * MUL32_OPS if subfield else MUL128_OPS


def subfield_step(args) -> bool:
    """True when every twiddle of a per-stage launch lies in GF(2^32):
    words 1..3 of the compact twiddles and lane planes 32..127 are zero."""
    return not any(bool((t[:, 1:] if t.dim() == 2 else t[32:]).any())
                   for t in args if torch.is_tensor(t))


def sliced_input(log_h: int, log_rate: int, device) -> torch.Tensor:
    words = mt19937_stream(SEED + log_h + log_rate, (1 << log_h) * 4)
    return bitslice_transpose(to_torch(words, device).reshape(-1, W))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device() -> str:
    caps = check_capabilities()
    smi = nvidia_smi_line()
    say("device", f"{caps.device_kind} capability={caps.capability} "
        f"count={caps.num_devices} memory={caps.memory_bytes} | {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    wall = time.perf_counter() - t0
    usage = [ln.strip() for ln in _build.build_info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    say("build", f"nvcc {_build.build_info['seconds']:.1f} s "
        f"(load {wall:.1f} s); ptxas: {' | '.join(usage)}")
    for name in (STAGE_GROUP_KERNELS + SUMCHECK_KERNELS
                 + BUTTERFLY_HIGH_KERNELS
                 + BUTTERFLY_LOW_KERNELS + STAGE_GROUP32_KERNELS
                 + ("stage_group_r2_kernel", LANES_KERNEL)
                 + MUL_COMPACT_KERNELS + (MUL_TILES_KERNEL,)):
        say("build", f"{name}: ptxas "
            f"{_build.kernel_usage(name) or 'not reported'}")


def phase_mul_tiles(dev) -> dict:
    """mul_tiles vs its plain version at 2^18 + 5 rows (a partial last
    tile) and at the timed 2^18 and 2^19 rows, then each timed size with
    CUDA events (one call, and a call in a run of 10 back to back) beside
    the plain version and its bound."""
    rng = np.random.default_rng(SEED)
    worst, by_rows = 0, {}
    for rows in ((1 << 18) + 5, 1 << 18, 1 << 19):
        a, b = (to_torch(rng.integers(0, 1 << 32, (rows, W), dtype=np.uint32),
                         dev) for _ in range(2))
        got = ck.mul_tiles(a, b)
        want = ck.mul_tiles_plain(a, b)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"mul_tiles differs from its plain version on "
                f"{rows} rows ({err})")
        worst = max(worst, err)
        del got, want
        if rows & (rows - 1):           # the tail size: checked, not timed
            say("mul_tiles", f"{rows} rows word-equal to plain (max_abs_err "
                f"{err}, tolerance exact)")
            continue
        ms = device_time(ck.mul_tiles, a, b) * 1e3
        run_ms = run_time(ck.mul_tiles, a, b) * 1e3
        plain_ms = device_time(ck.mul_tiles_plain, a, b, warmup=1,
                               reps=3) * 1e3
        t = {"ms": ms, "run_ms": run_ms, "plain_ms": plain_ms,
             **bound(rows * MUL128_OPS, 3 * rows * W * 4)}
        by_rows[f"2^{rows.bit_length() - 1}"] = t
        say("mul_tiles", f"{rows} rows word-equal to plain (max_abs_err "
            f"{err}, tolerance exact); kernel {ms:.3f} ms ({run_ms:.3f} ms "
            f"a call back to back), plain {plain_ms:.3f} ms, bound "
            f"{t['bound_ms']:.3f} ms by {t['bound_by']} "
            f"({t['bound_ms'] / ms:.0%} of it)")
        del a, b
    return {"name": "mul_tiles", "route": "cuda",
            "source": "binius_ntt_tpu_torch/csrc/mul_tiles.cu",
            "replaces": "binius_ntt_tpu/ntt/pallas_kernels.py:200",
            "max_abs_err": worst,
            "shape": "2^18 rows of 128 words (2^23 products); by_rows has "
                     "2^19 rows too",
            "by_rows": by_rows,
            **{k: by_rows["2^18"][k] for k in ("ms", "run_ms", "plain_ms",
                                               "bound_ms", "bound_by",
                                               "library_ms")}}


def _groups_vs_plain(x, tables, where: str):
    """Kernel (CHUNK32) vs plain for every group of one transform, each on
    the previous group's output, starting from a copy of x; returns the
    kernel's output and the max err."""
    worst = 0
    for (t0, k, low, mtile, minst, lanes, zero, chunk32) in tables:
        require(chunk32, f"{where} group (t0={t0}, k={k}) is not flagged "
                f"CHUNK32")
        kw = dict(t0=t0, k=k, include_low=low, zero_flags=zero)
        got = cf.stage_group(x.clone(), mtile, minst, lanes, chunk32=chunk32,
                             **kw)
        want = cf.stage_group_plain(x.clone(), mtile, minst, lanes, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"stage_group (t0={t0}, k={k}, low={low}) at "
                f"{where} differs from plain ({err})")
        worst = max(worst, err)
        del want
        x = got
    return x, worst


def _check_groups(log_h: int, log_rate: int, dev, golden) -> int:
    """Kernel vs plain for every group of one transform; returns max err."""
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    tables = cf.build_tables(rows, log_h, log_rate, dev)
    data = sliced_input(log_h, log_rate, dev)
    x, worst = _groups_vs_plain(
        data.repeat(1 << log_rate, 1).view(1 << log_rate, -1, W), tables,
        f"({log_h}, {log_rate})")
    digest = md5_words(bitslice_untranspose(x.view(-1, W)).reshape(-1))
    want_digest = golden.get(log_rate, {}).get(log_h)
    if want_digest is not None:
        require(digest == want_digest,
                f"({log_h}, {log_rate}) golden digest mismatch")
    say("stage_group", f"({log_h}, {log_rate}) plan "
        f"{[(t0, k, low) for (t0, k, low, *_) in tables]} CHUNK32, "
        f"word-equal to plain (max_abs_err {worst}, tolerance exact); digest "
        f"{'golden' if want_digest else 'not in the golden table'}")
    return worst


def _check_random_tables(log_h: int, log_rate: int, dev) -> int:
    """Each instantiation through a whole plan of random tables, group by
    group against plain; returns max err."""
    random_group_tables = load_test_file(
        "torch_stage_group_tables").random_group_tables
    worst = 0
    plan = list(reversed(cf.plan_groups(log_h - 5)))
    for width, route in ((W, "general"), (cf.SUB_PLANES, "chunk32")):
        rng = np.random.default_rng(SEED + log_h + width)
        x = to_torch(rng.integers(0, 1 << 32, (1 << log_rate,
                                               (1 << log_h) // 32, W),
                                  dtype=np.uint32), dev)
        before = cf.stage_group.route_launches[route]
        for t0, k, low in plan:
            mtile, minst, lanes = random_group_tables(rng, k, low, width,
                                                      dev)
            kw = dict(t0=t0, k=k, include_low=low)
            want = cf.stage_group_plain(x.clone(), mtile, minst, lanes, **kw)
            cf.stage_group(x, mtile, minst, lanes,
                           chunk32=route == "chunk32", **kw)
            torch.cuda.synchronize()
            err = max_abs_err(x, want)
            require(err == 0, f"stage_group ({route}, t0={t0}, k={k}) on "
                    f"random tables at ({log_h}, {log_rate}) differs from "
                    f"plain ({err})")
            worst = max(worst, err)
        require(cf.stage_group.route_launches[route] == before + len(plan),
                f"the {route} route was not taken")
    say("stage_group", f"({log_h}, {log_rate}) plan "
        f"{[(t0, k, low) for (t0, k, low) in plan]} on random tables: "
        f"general (planes 0..127) and CHUNK32 (planes 0..31) word-equal to "
        f"plain (max_abs_err {worst}, tolerance exact)")
    return worst


@contextlib.contextmanager
def forced_plan(kb: int, ku: int, pt: int):
    """cuda_fused's group plan (KB, KU, PT) inside the block."""
    saved = (cf.KB, cf.KU, cf.PT)
    cf.KB, cf.KU, cf.PT = kb, ku, pt
    try:
        yield
    finally:
        cf.KB, cf.KU, cf.PT = saved


def phase_stage_group(dev, golden) -> int:
    worst = max(_check_groups(16, 0, dev, golden),
                _check_groups(16, 2, dev, golden),
                _check_random_tables(16, 0, dev))
    with forced_plan(2, 2, 2):           # multi-group seams and cosets
        worst = max(worst, _check_groups(9, 1, dev, golden),
                    _check_groups(12, 0, dev, golden),
                    _check_random_tables(12, 0, dev))
    return worst


def phase_main_path(dev, golden):
    log_h = 24
    t0 = time.perf_counter()
    runs = []
    for log_rate in (0, 2):
        ntt = AdditiveNTT128(log_h, log_rate, device=dev)
        words = mt19937_stream(SEED + log_h + log_rate, (1 << log_h) * 4)
        runs.append((log_rate, ntt, words))
    say("main", f"set-up (twiddles, tables, inputs) "
        f"{time.perf_counter() - t0:.1f} s host")

    reset_counts()
    outs = []
    for log_rate, ntt, words in runs:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ntt.apply(words)
        torch.cuda.synchronize()
        outs.append((log_rate, out, time.perf_counter() - t1))
    launches = {"stage_group": cf.stage_group.launches,
                "mul_tiles": ck.mul_tiles.launches}
    routes = dict(cf.stage_group.route_launches)

    for log_rate, out, sec in outs:
        n_out = (1 << (log_h + log_rate)) * 4
        require(tuple(out.shape) == (n_out,), f"output shape {out.shape}")
        digest = md5_words(out)
        require(digest == golden[log_rate][log_h],
                f"(24, {log_rate}) digest {digest} != golden "
                f"{golden[log_rate][log_h]}")
        say("main", f"AdditiveNTT128(24, {log_rate}).apply: golden MD5 "
            f"{digest} matches; {sec:.3f} s host clock incl. upload and "
            f"layout")
    require(launches["stage_group"] > 0, "stage_group never launched")
    require(all(chunk32 for _, ntt, _ in runs
                for *_, chunk32 in ntt.tables)
            and routes == {"chunk32": launches["stage_group"], "general": 0},
            f"every main-path group must take the CHUNK32 route: {routes}")
    say("main", f"launches {launches}; stage_group by route {routes}")
    launches["stage_group_routes"] = routes
    return launches, runs


def phase_timing(runs, dev) -> dict:
    """runs: phase 5's (log_rate, transform, words)."""
    out = {}
    for log_rate, ntt, _ in runs:
        sliced = sliced_input(ntt.log_h, log_rate, dev)
        x = sliced.repeat(1 << log_rate, 1).view(1 << log_rate, -1, W)
        tables = ntt.tables
        # the kernel held to plain at the main path's shapes
        plan = [(t0, k, low) for (t0, k, low, *_) in tables]
        _, plain_err = _groups_vs_plain(x, tables,
                                        f"2^{ntt.log_h} rate {log_rate}")
        say("timing", f"2^{ntt.log_h} rate {log_rate} stage groups {plan}: "
            f"kernel (CHUNK32) word-equal to plain group by group (max_abs_err "
            f"{plain_err}, tolerance exact)")
        # the kernel before the CHUNK32 route: the general one on the
        # earlier default plan
        with forced_plan(8, 8, 8):
            general = [g[:7] + (False,) for g in cf.build_tables(
                precompute_subspace_evals(ntt.log_h, log_rate, 7),
                ntt.log_h, log_rate, dev)]

        def groups(fn, tabs=tables, x=x):
            for (t0, k, low, mtile, minst, lanes, zero, chunk32) in tabs:
                fn(x, mtile, minst, lanes, t0=t0, k=k, include_low=low,
                   zero_flags=zero, chunk32=chunk32)

        def plain(*args, chunk32, **kw):
            return cf.stage_group_plain(*args, **kw)

        # both give the same words on the same input
        x0 = x.clone()
        groups(cf.stage_group)
        got = x.clone()
        x.copy_(x0)
        with forced_plan(8, 8, 8):
            groups(cf.stage_group, general)
            err = max_abs_err(x, got)
            require(err == 0, f"2^24 rate {log_rate}: the general route "
                    f"differs from CHUNK32 ({err})")
            general_ms = device_time(groups, cf.stage_group, general) * 1e3
        del x0, got
        t = {"err": plain_err, "ms": device_time(groups, cf.stage_group) * 1e3,
             "general_ms": general_ms,
             "apply_ms": device_time(ntt.apply_sliced, sliced) * 1e3,
             "group_ms": [device_time(
                 lambda g=g: cf.stage_group(
                     x, *g[3:6], t0=g[0], k=g[1], include_low=g[2],
                     zero_flags=g[6], chunk32=g[7])) * 1e3 for g in tables]}
        # every live stage's products (four GF(2^32) ones a butterfly on
        # the CHUNK32 route); x read and written
        n_pairs = x.numel() // W // 2
        t.update(bound(sum(sum(not z for z in zero) * n_pairs
                           * mul_ops(chunk32)
                           for *_, zero, chunk32 in tables),
                       2 * x.numel() * 4))
        msg = (f"2^{ntt.log_h} rate {log_rate} stage groups {plan}: kernel "
               f"{t['ms']:.3f} ms (CHUNK32, null dplanes; before dplanes: "
               f"{EARLIER_CHAIN_MS[log_rate]} ms), general route on the "
               f"earlier "
               f"plan (8, 8, 8) {t['general_ms']:.3f} ms (word-equal); groups "
               f"alone "
               f"{[round(g, 3) for g in t['group_ms']]} ms; bound "
               f"{t['bound_ms']:.3f} ms by {t['bound_by']}; apply_sliced "
               f"{t['apply_ms']:.3f} ms")
        if log_rate == 0:
            torch.cuda.reset_peak_memory_stats()
            t["plain_ms"] = device_time(groups, plain, warmup=1,
                                        reps=3) * 1e3
            peak = torch.cuda.max_memory_allocated()
            msg += (f"; plain {t['plain_ms']:.3f} ms (peak "
                    f"{peak / 2**30:.1f} GiB)")
        say("timing", msg)
        out[log_rate] = t
        del x, sliced
    return out


def phase_sumcheck_kernels(dev, num_vars_list=(12, 20)) -> dict:
    """Kernel vs plain at every live row count of a protocol; returns the
    largest error of each kernel."""
    rng = np.random.default_rng(SEED)
    worst = {"round": 0, "fold": 0}
    for num_vars in num_vars_list:
        for comp in COMPS:
            b = (1 << num_vars) // 32
            x = to_torch(rng.integers(0, 1 << 32, (comp, b, W),
                                      dtype=np.uint32), dev)
            # (rows, lanes) of every round: rows b .. 2, then in-word
            live = [(b >> k, 32) for k in range(b.bit_length() - 1)]
            live += [(1, 32 >> k) for k in range(6)]
            for rows, lanes in live:
                got = cr.round_kernel(x, rows, comp + 1, lanes)
                want = cr.round_plain(x, rows, comp + 1, lanes)
                err_r = max_abs_err(got, want)
                err_f = 0
                if rows * lanes >= 2:             # the last round has no fold
                    ch = rng.integers(0, 1 << 32, 4, dtype=np.uint32)
                    folded = cr.fold_kernel(x.clone(), ch, rows, lanes)
                    want_folded = cr.fold_plain(x.clone(), ch, rows, lanes)
                    err_f = max_abs_err(folded, want_folded)
                    x = folded
                require(err_r == 0 and err_f == 0,
                        f"sumcheck kernels differ from plain at num_vars "
                        f"{num_vars}, C={comp}, rows={rows}, lanes={lanes} "
                        f"(round {err_r}, fold {err_f})")
                worst["round"] = max(worst["round"], err_r)
                worst["fold"] = max(worst["fold"], err_f)
            say("sumcheck_kernels", f"num_vars {num_vars}, C={comp}: round "
                f"and fold word-equal to plain at every live row count "
                f"{b}..2 and in-word lanes 32..1 (max_abs_err 0, tolerance "
                f"exact)")
    return worst


@contextlib.contextmanager
def plain_sumcheck():
    """The prover's round and fold calls go to the plain versions."""
    saved = cr.round_kernel, cr.fold_kernel
    cr.round_kernel, cr.fold_kernel = cr.round_plain, cr.fold_plain
    try:
        yield
    finally:
        cr.round_kernel, cr.fold_kernel = saved


def same_transcript(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(sa, sb) and np.array_equal(pa, pb)
        for (sa, pa), (sb, pb) in zip(a, b))


def phase_sumcheck_main(dev, sc, num_vars=24, golden_num_vars=20):
    t0 = time.perf_counter()
    # one stream serves every C: column c of the C = 4 input is column c
    # of the others
    words = mt19937_stream(SUMCHECK_SEED, 4 * (1 << num_vars) * max(COMPS))
    challenges = mt19937_stream(SUMCHECK_SEED + 1,
                                4 * num_vars).reshape(num_vars, 4)
    say("sumcheck_main", f"set-up (mt19937 inputs, {words.size} words) "
        f"{time.perf_counter() - t0:.1f} s host")

    reset_counts()
    runs = []
    for comp in COMPS:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prover = Sumcheck(words[:4 * (1 << num_vars) * comp], comp,
                          num_vars, device=dev)
        messages = sc.transcript(prover, challenges)
        torch.cuda.synchronize()
        runs.append((comp, messages, time.perf_counter() - t1))
    launches = {"sumcheck_round": cr.round_kernel.launches,
                "sumcheck_fold": cr.fold_kernel.launches}

    for comp, messages, sec in runs:
        verifier.check_transcript(messages, challenges, comp + 1)
        say("sumcheck_main", f"Sumcheck(2^{num_vars} evaluations, "
            f"C={comp}): {num_vars} rounds pass the verifier's checks "
            f"(sum = p(0) + p(1), sum = the previous claim, final sum = "
            f"the last claim); "
            f"{sec:.3f} s host clock incl. upload and layout; transcript "
            f"MD5 {sc.transcript_md5(messages)}")
    require(launches["sumcheck_round"] > 0 and launches["sumcheck_fold"] > 0,
            f"the sumcheck kernels were not launched: {launches}")
    say("sumcheck_main", f"launches {launches}")

    with plain_sumcheck():
        plain = sc.transcript(Sumcheck(words[:4 * (1 << num_vars) * 2], 2,
                                       num_vars, device=dev), challenges)
    require(same_transcript(plain, runs[0][1]),
            "the C = 2 transcript differs from the plain versions'")
    say("sumcheck_main", "C=2 transcript equals the plain versions' on the "
        "card")

    for comp in COMPS:
        nv = golden_num_vars
        w, ch = sc.protocol_inputs(nv, comp, mt19937_stream)
        messages = sc.transcript(Sumcheck(w, comp, nv, device=dev), ch)
        verifier.check_transcript(messages, ch, comp + 1)
        digest = sc.transcript_md5(messages)
        want = sc.SUMCHECK_TRANSCRIPT_MD5[nv][comp]
        require(digest == want, f"num_vars {nv}, C={comp}: transcript MD5 "
                f"{digest} != the JAX package's {want}")
        say("sumcheck_main", f"num_vars {nv}, C={comp}: transcript MD5 "
            f"{digest} matches the JAX package's")
    return launches, words, challenges, {c: m for c, m, _ in runs}


def timed_protocol(prover, challenges) -> list[float]:
    """Host-clock seconds of every round (messages, then the fold, then a
    synchronise), and last of the final round_messages."""
    seconds = []
    for ch in challenges:
        t0 = time.perf_counter()
        prover.round_messages()
        prover.move_to_next_round(ch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    prover.round_messages()
    seconds.append(time.perf_counter() - t0)
    return seconds


def phase_sumcheck_timing(dev, words, challenges, worst,
                          num_vars=24) -> dict:
    """Times at 2^24; first holds each kernel to its plain version on the
    timed input (the largest grid of the protocol), raising ``worst`` to
    what it finds."""
    b = (1 << num_vars) // 32
    out = {}
    for comp in COMPS:
        sliced = bitslice_transpose(
            to_torch(words[:4 * (1 << num_vars) * comp], dev).view(comp, b,
                                                                  W))
        x = sliced.clone()
        err_r = max_abs_err(cr.round_kernel(x, b, comp + 1),
                            cr.round_plain(x, b, comp + 1))
        err_f = max_abs_err(cr.fold_kernel(x.clone(), challenges[0], b),
                            cr.fold_plain(x.clone(), challenges[0], b))
        require(err_r == 0 and err_f == 0,
                f"sumcheck kernels differ from plain at 2^{num_vars}, "
                f"C={comp} (round {err_r}, fold {err_f})")
        worst["round"] = max(worst["round"], err_r)
        worst["fold"] = max(worst["fold"], err_f)
        t = {"round_ms": device_time(cr.round_kernel, x, b, comp + 1),
             "round_plain_ms": device_time(cr.round_plain, x, b, comp + 1,
                                           warmup=1, reps=3),
             # the fold works in place: each call folds the same rows again
             "fold_ms": device_time(cr.fold_kernel, x, challenges[0], b),
             "fold_plain_ms": device_time(cr.fold_plain, x, challenges[0], b,
                                          warmup=1, reps=3)}
        t = {k: v * 1e3 for k, v in t.items()}
        bounds = sumcheck_bounds(comp, b)
        runs = [timed_protocol(Sumcheck(sliced.clone(), comp, num_vars,
                                        data_is_transposed=True), challenges)
                for _ in range(3)]
        # the last 5 rounds and the final sum are in-word (32 evals or
        # fewer, one thread per launch)
        t["protocol_ms"] = statistics.median(sum(r) for r in runs) * 1e3
        t["in_word_ms"] = statistics.median(sum(r[-6:]) for r in runs) * 1e3
        say("sumcheck_timing", f"2^{num_vars}, C={comp}: round and fold "
            f"word-equal to plain on the timed input (max_abs_err 0); first "
            f"round {t['round_ms']:.3f} ms (plain {t['round_plain_ms']:.3f} "
            f"ms; bound {bounds['round']['bound_ms']:.3f} ms, "
            f"{bounds['round']['bound_ms'] / t['round_ms']:.1%} of it), fold "
            f"{t['fold_ms']:.3f} ms (plain {t['fold_plain_ms']:.3f} ms; "
            f"bound {bounds['fold']['bound_ms']:.3f} ms, "
            f"{bounds['fold']['bound_ms'] / t['fold_ms']:.1%} of it); "
            f"whole protocol from device "
            f"input {t['protocol_ms']:.3f} ms host clock, of it the in-word "
            f"rounds {t['in_word_ms']:.3f} ms (medians of 3)")
        out[comp] = t
    return out


def words32(log_h: int, log_rate: int) -> np.ndarray:
    return mt19937_stream(SEED + log_h + log_rate, 1 << log_h)


def phase_ntt32_kernels(dev, golden32) -> dict:
    """Both GF(2^32) kernels vs their plain versions; returns the largest
    error of each."""
    rng = np.random.default_rng(SEED + 32)
    rows = 1 << 17
    x = to_torch(rng.integers(0, 1 << 32, (rows, W), dtype=np.uint32), dev)
    got = cf32.bitslice_lane_groups(x)
    err_t = max_abs_err(got, cf32.bitslice_lane_groups_plain(x))
    back = max_abs_err(cf32.bitslice_lane_groups(got), x)
    require(err_t == 0 and back == 0, f"bitslice_lane_groups differs from "
            f"its plain version ({err_t}) or from its inverse ({back})")
    say("ntt32_kernels", f"bitslice_lane_groups on {rows} rows word-equal "
        f"to plain and its own inverse (max_abs_err 0, tolerance exact)")

    def check(log_h, log_rate):
        tables = cf32.build_tables32(
            precompute_subspace_evals(log_h, log_rate, 5), log_h, log_rate,
            dev)
        cosets = 1 << log_rate
        packed = cf32.bitslice_lane_groups(
            to_torch(words32(log_h, log_rate), dev).view(-1, W))
        x = packed.repeat(cosets, 1).view(cosets, -1, W)
        worst = 0
        for (t0, k, low, tabs) in tables:
            kw = dict(t0=t0, k=k, include_low=low, cosets=cosets,
                      log_nbr=log_h - 7)
            want = cf32.stage_group32_plain(x.clone(), tabs, **kw)
            cf32.stage_group32(x, tabs, **kw)
            torch.cuda.synchronize()
            err = max_abs_err(x, want)
            require(err == 0, f"stage_group32 (t0={t0}, k={k}, low={low}) "
                    f"at ({log_h}, {log_rate}) differs from plain ({err})")
            worst = max(worst, err)
        digest = md5_words(cf32.bitslice_lane_groups(x.view(-1, W)))
        want_digest = golden32.get(log_rate, {}).get(log_h)
        if want_digest is not None:
            require(digest == want_digest,
                    f"({log_h}, {log_rate}) golden digest mismatch")
        say("ntt32_kernels", f"stage_group32 ({log_h}, {log_rate}) plan "
            f"{[(t0, k, low) for (t0, k, low, _) in tables]} word-equal to "
            f"plain (max_abs_err {worst}, tolerance exact); digest "
            f"{'golden' if want_digest else 'not in the golden table'}")
        return worst

    worst = max(check(16, 0), check(16, 2))
    saved = (cf32.KB, cf32.KU)
    cf32.KB, cf32.KU = 2, 2                  # multi-group seams and cosets
    try:
        for log_h, log_rate in ((7, 0), (7, 2), (11, 4), (13, 2)):
            worst = max(worst, check(log_h, log_rate))
    finally:
        cf32.KB, cf32.KU = saved
    return {"bitslice_lane_groups": max(err_t, back), "stage_group32": worst}


def phase_ntt32_main(dev, golden32):
    log_h = 24
    t0 = time.perf_counter()
    runs = [(r, AdditiveNTT(log_h, r, device=dev), words32(log_h, r))
            for r in (0, 2)]
    say("ntt32_main", f"set-up (twiddles, tables, mt19937 inputs) "
        f"{time.perf_counter() - t0:.1f} s host")

    reset_counts()
    outs = []
    for log_rate, ntt, words in runs:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ntt.apply(words)
        torch.cuda.synchronize()
        outs.append((log_rate, out, time.perf_counter() - t1))
    launches = {"bitslice_lane_groups": cf32.bitslice_lane_groups.launches,
                "stage_group32": cf32.stage_group32.launches}

    for log_rate, out, sec in outs:
        require(tuple(out.shape) == (1 << (log_h + log_rate),),
                f"output shape {tuple(out.shape)}")
        digest = md5_words(out)
        require(digest == golden32[log_rate][log_h],
                f"(24, {log_rate}) digest {digest} != golden "
                f"{golden32[log_rate][log_h]}")
        say("ntt32_main", f"AdditiveNTT(24, {log_rate}).apply: golden MD5 "
            f"{digest} matches; {sec:.3f} s host clock incl. upload")
    n_groups = sum(len(ntt.tables) for _, ntt, _ in runs)
    require(launches["bitslice_lane_groups"] == 4
            and launches["stage_group32"] == n_groups,
            f"expected 4 lane-group and {n_groups} stage-group launches, "
            f"got {launches}")
    say("ntt32_main", f"launches {launches}")
    return launches, runs


def check_ntt32_at_main_shapes(ntt, x_dev) -> dict:
    """Both GF(2^32) kernels vs their plain versions on the main path's
    2^24 input, at the shapes apply gives them: the lane-group transpose
    on the input rows and on the cosets * 2^17 output rows, and
    stage_group32 group by group under the production plan.  Returns the
    largest error of each."""
    cosets = 1 << ntt.log_rate
    rows = x_dev.view(-1, W)
    packed = cf32.bitslice_lane_groups(rows)
    err_in = max_abs_err(packed, cf32.bitslice_lane_groups_plain(rows))
    require(err_in == 0, f"bitslice_lane_groups on the ({ntt.log_h}, "
            f"{ntt.log_rate}) input differs from plain ({err_in})")
    x = packed.repeat(cosets, 1).view(cosets, -1, W)
    x_plain = x.clone()
    worst = 0
    for (t0, k, low, tabs) in ntt.tables:
        kw = dict(t0=t0, k=k, include_low=low, cosets=cosets,
                  log_nbr=ntt.log_h - 7)
        cf32.stage_group32(x, tabs, **kw)
        cf32.stage_group32_plain(x_plain, tabs, **kw)
        err = max_abs_err(x, x_plain)
        require(err == 0, f"stage_group32 (t0={t0}, k={k}, low={low}) at "
                f"({ntt.log_h}, {ntt.log_rate}) differs from plain ({err})")
        worst = max(worst, err)
    del x_plain
    rows_out = x.view(-1, W)
    err_out = max_abs_err(cf32.bitslice_lane_groups(rows_out),
                          cf32.bitslice_lane_groups_plain(rows_out))
    require(err_out == 0, f"bitslice_lane_groups on the ({ntt.log_h}, "
            f"{ntt.log_rate}) output differs from plain ({err_out})")
    say("ntt32_timing", f"({ntt.log_h}, {ntt.log_rate}): bitslice_lane_groups on "
        f"{rows.shape[0]} input and {rows_out.shape[0]} output rows and "
        f"stage_group32 at every group "
        f"{[(t0, k, low) for (t0, k, low, _) in ntt.tables]} word-equal to "
        f"plain (max_abs_err {max(err_in, err_out, worst)}, tolerance "
        f"exact)")
    return {"bitslice_lane_groups": max(err_in, err_out),
            "stage_group32": worst}


def phase_ntt32_timing(dev, runs) -> dict:
    out = {"chain": {}, "apply": {}, "err": {}}
    for log_rate, ntt, words in runs:
        x_dev = to_torch(words, dev)
        cosets = 1 << log_rate
        for name, err in check_ntt32_at_main_shapes(ntt, x_dev).items():
            out["err"][name] = max(out["err"].get(name, 0), err)
        x = cf32.bitslice_lane_groups(x_dev.view(-1, W)).repeat(
            cosets, 1).view(cosets, -1, W)

        def groups(fn):
            for (t0, k, low, tabs) in ntt.tables:
                fn(x, tabs, t0=t0, k=k, include_low=low, cosets=cosets,
                   log_nbr=ntt.log_h - 7)

        ms = device_time(groups, cf32.stage_group32) * 1e3
        group_ms = []
        for (t0, k, low, tabs) in ntt.tables:
            group_ms.append(device_time(
                lambda t0=t0, k=k, low=low, tabs=tabs: cf32.stage_group32(
                    x, tabs, t0=t0, k=k, include_low=low, cosets=cosets,
                    log_nbr=ntt.log_h - 7)) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        plain_ms = device_time(groups, cf32.stage_group32_plain, warmup=1,
                               reps=3) * 1e3
        peak = torch.cuda.max_memory_allocated()
        apply_ms = device_time(ntt.apply, x_dev) * 1e3
        out["chain"][log_rate] = {"ms": ms, "plain_ms": plain_ms,
                                  "group_ms": group_ms}
        out["apply"][log_rate] = apply_ms
        plan = [(t0, k, low) for (t0, k, low, _) in ntt.tables]
        say("ntt32_timing", f"2^24 rate {log_rate} stage groups {plan}: "
            f"kernel {ms:.3f} ms (each group alone "
            f"{', '.join(f'{g:.3f}' for g in group_ms)} ms), plain "
            f"{plain_ms:.3f} ms (peak {peak / 2**30:.1f} GiB); apply from "
            f"device words {apply_ms:.3f} ms")

    # the transpose alone on the input's 2^17 rows and on the rate-2
    # output's 2^19, each held to its plain version first
    rng = np.random.default_rng(SEED + 33)
    out["lanes"] = {}
    for log_rows in (17, 19):
        x = to_torch(rng.integers(0, 1 << 32, (1 << log_rows, W),
                                  dtype=np.uint32), dev)
        plain = cf32.bitslice_lane_groups_plain(x)
        err = max_abs_err(cf32.bitslice_lane_groups(x), plain)
        require(err == 0, f"bitslice_lane_groups on 2^{log_rows} random rows "
                f"differs from plain ({err})")
        del plain
        out["err"]["bitslice_lane_groups"] = max(
            out["err"].get("bitslice_lane_groups", 0), err)
        lanes = {"ms": device_time(cf32.bitslice_lane_groups, x) * 1e3,
                 "run_ms": run_time(cf32.bitslice_lane_groups, x) * 1e3,
                 "plain_ms": device_time(cf32.bitslice_lane_groups_plain, x,
                                         warmup=1, reps=3) * 1e3,
                 **bound(x.numel() * TRANSPOSE32_OPS / 32,
                         2 * x.numel() * 4)}
        out["lanes"][log_rows] = lanes
        say("ntt32_timing", f"bitslice_lane_groups on 2^{log_rows} rows "
            f"({x.numel() * 4 >> 20} MB) word-equal to plain (max_abs_err "
            f"0, tolerance exact): kernel {lanes['ms']:.4f} ms a call, "
            f"{lanes['run_ms']:.4f} ms a call back to back, plain "
            f"{lanes['plain_ms']:.3f} ms, bound {lanes['bound_ms']:.4f} ms "
            f"by {lanes['bound_by']} ({lanes['bound_ms'] / lanes['ms']:.0%} "
            f"and {lanes['bound_ms'] / lanes['run_ms']:.0%} of it)")
        del x
    compact = AdditiveNTT(24, 0, use_fused=False, device=dev)
    out["compact_ms"] = device_time(compact.apply, to_torch(runs[0][2], dev),
                                    warmup=1, reps=3) * 1e3
    say("ntt32_timing", f"compact torch path AdditiveNTT(24, 0, "
        f"use_fused=False).apply {out['compact_ms']:.3f} ms")
    return out


def bb31_groups(fn, out, x, tw, log_n: int) -> None:
    """The chain of stage groups of one BB31 transform through ``fn`` (the
    kernel or the plain version): x (canonical, IN_ORDER) -> out."""
    plan = cfb.plan_groups_r2(log_n)
    for gi, (s0, k) in enumerate(plan):
        fn(out, tw, s0=s0, k=k, log_n=log_n, encode_in=gi == 0,
           decode_out=gi == len(plan) - 1, src=x if gi == 0 else None)


def check_bb31(x, tw, log_n: int, phase: str) -> int:
    """stage_group_r2 vs plain after every group of the current plan on
    input x; returns the largest error and holds the chained output to the
    golden digest."""
    plan = cfb.plan_groups_r2(log_n)
    got, want = torch.empty_like(x), torch.empty_like(x)
    worst = 0
    for gi, (s0, k) in enumerate(plan):
        kw = dict(s0=s0, k=k, log_n=log_n, encode_in=gi == 0,
                  decode_out=gi == len(plan) - 1, src=x if gi == 0 else None)
        cfb.stage_group_r2(got, tw, **kw)
        cfb.stage_group_r2_plain(want, tw, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"stage_group_r2 (s0={s0}, k={k}) at log_n "
                f"{log_n} differs from plain ({err})")
        worst = max(worst, err)
    digest = md5_words(got)
    require(digest == bb31_golden()[log_n], f"BB31 log_n {log_n}: digest "
            f"{digest} != golden")
    say(phase, f"log_n {log_n} plan {plan}: stage_group_r2 word-equal to "
        f"plain after every group (max_abs_err {worst}, tolerance exact); "
        f"golden MD5 matches")
    return worst


def bb31_golden():
    return load_test_file("golden_hashes").BB31_NTT_HASHES


def bb31_input(log_n: int) -> np.ndarray:
    return mt19937_stream(SEED + log_n, 1 << log_n)


def phase_bb31_kernels(dev) -> int:
    def check(log_n):
        ntt = NTTRadix2(137, 27, log_n, device=dev)
        return check_bb31(to_torch(bb31_input(log_n), dev), ntt.tw, log_n,
                          "bb31_kernels")

    # 1 .. 6: one group (0, log_n) under the production plan, below the
    # reference's gate of the fused path, which the card does not keep
    worst = max(check(log_n) for log_n in (*range(1, 7), 16))
    saved = (cfb.KB, cfb.KU)
    cfb.KB, cfb.KU = 2, 2                   # many groups and seams
    try:
        for log_n in (7, 10, 13):
            worst = max(worst, check(log_n))
    finally:
        cfb.KB, cfb.KU = saved
    return worst


def phase_bb31_main(dev, sizes=(24, 27)):
    t0 = time.perf_counter()
    golden = bb31_golden()
    runs = [(log_n, NTTRadix2(137, 27, log_n, device=dev),
             bb31_input(log_n)) for log_n in sizes]
    log_rt = sizes[0]                       # the round trip's size
    inv = NTTRadix2(bb.inv_host(137), 27, log_rt, device=dev)
    x_rt = runs[0][2] % np.uint32(bb.P)
    n_inv = torch.tensor(bb.encode_host(np.array([bb.inv_host(1 << log_rt)]))
                         .view(np.int32), device=dev)
    say("bb31_main", f"set-up (twiddles, mt19937 inputs) "
        f"{time.perf_counter() - t0:.1f} s host")

    reset_counts()
    outs = []
    for log_n, ntt, words in runs:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ntt.apply(words)
        torch.cuda.synchronize()
        outs.append((log_n, out, time.perf_counter() - t1))
    back = bb.mont_mul(inv.apply(runs[0][1].apply(x_rt)), n_inv)
    torch.cuda.synchronize()
    launches = {"stage_group_r2": cfb.stage_group_r2.launches}

    for log_n, out, sec in outs:
        require(tuple(out.shape) == (1 << log_n,),
                f"output shape {tuple(out.shape)}")
        digest = md5_words(out)
        require(digest == golden[log_n], f"BB31 2^{log_n}: digest {digest} "
                f"!= golden {golden[log_n]}")
        say("bb31_main", f"NTTRadix2(137, 27, {log_n}).apply: golden MD5 "
            f"{digest} matches; {sec:.3f} s host clock incl. upload")
    require(np.array_equal(to_numpy(back), x_rt), f"the 2^{log_rt} round "
            f"trip did not give back the input mod P")
    # each size once, then the first twice more for the round trip
    n_groups = (2 * len(cfb.plan_groups_r2(log_rt))
                + sum(len(cfb.plan_groups_r2(log_n)) for log_n in sizes))
    require(launches["stage_group_r2"] == n_groups, f"expected {n_groups} "
            f"stage_group_r2 launches, got {launches}")
    say("bb31_main", f"2^{log_rt} round trip (forward with 137, inverse "
        f"with 137^-1, then 1/n) gives back the input mod P; launches "
        f"{launches}")
    del outs, back
    return launches, runs


def bb31_bound(log_n: int, s0: int = 0, k: int | None = None) -> dict:
    """Bound of the stages s0 .. s0+k-1 of a 2^log_n transform (all of
    them by default): its butterflies (the top stage's without a product),
    the encode in the first group and the decode in the last; the array
    read and written once and the twiddles its stages use read once
    (stage s0's n / 2^(s0+1), the others' a prefix of them)."""
    k = log_n - s0 if k is None else k
    n = 1 << log_n
    top = s0 + k == log_n
    ops = (n // 2 * ((k - top) * (2 * BB31_ADD_OPS + BB31_MUL_OPS)
                     + top * 2 * BB31_ADD_OPS)
           + n * BB31_MUL_OPS * ((s0 == 0) + top))
    return bound(ops, 4 * n + 4 * n + 4 * (n >> (s0 + 1)), INSTR_OPS_PER_S)


def phase_bb31_timing(dev, runs) -> dict:
    # the kernel against plain at every shape the main path gave it: the
    # plans of 2^24 and 2^27, on their own inputs
    worst = max(check_bb31(to_torch(words, dev), ntt.tw, log_n,
                           "bb31_timing") for log_n, ntt, words in runs)
    log_n, ntt, words = runs[0]
    x = to_torch(words, dev)
    tw = ntt.tw
    out = torch.empty_like(x)
    ms = device_time(bb31_groups, cfb.stage_group_r2, out, x, tw,
                     log_n) * 1e3
    plain_ms = device_time(bb31_groups, cfb.stage_group_r2_plain, out, x,
                           tw, log_n, warmup=1, reps=3) * 1e3
    apply_ms = device_time(ntt.apply, x) * 1e3
    plan = cfb.plan_groups_r2(log_n)
    s0, k = plan[0]
    first = {name: device_time(
        lambda src: cfb.stage_group_r2(out, tw, s0=s0, k=k, log_n=log_n,
                                       encode_in=True, src=src),
        src) * 1e3 for name, src in (("with", x), ("without", None))}
    groups_ms = [device_time(lambda s0=s0, k=k: cfb.stage_group_r2(
        out, tw, s0=s0, k=k, log_n=log_n)) * 1e3 for s0, k in plan[1:]]
    # the per-stage torch path: one plain group over every stage
    per_stage_ms = device_time(
        lambda: cfb.stage_group_r2_plain(
            out, tw, s0=0, k=log_n, log_n=log_n, encode_in=True,
            decode_out=True, src=x), warmup=1, reps=3) * 1e3
    b = bb31_bound(log_n)
    say("bb31_timing", f"2^{log_n} plan {plan}: chain kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (bound {b['bound_ms']:.3f} ms by "
        f"{b['bound_by']}); apply from device words {apply_ms:.3f} ms; first "
        f"group {first['with']:.3f} ms with its bit-reversing load, "
        f"{first['without']:.3f} ms without; upper groups {groups_ms} ms; "
        f"per-stage torch path {per_stage_ms:.3f} ms")
    del x, out
    # the largest transform: its chain and each group alone, beside their
    # bounds
    log_big, ntt_big, words_big = runs[-1]
    x = to_torch(words_big, dev)
    out = torch.empty_like(x)
    plan_big = cfb.plan_groups_r2(log_big)
    big = {"log_n": log_big, "plan": plan_big,
           "ms": device_time(bb31_groups, cfb.stage_group_r2, out, x,
                             ntt_big.tw, log_big) * 1e3,
           "bound_ms": bb31_bound(log_big)["bound_ms"],
           "groups": [{"group": [s0, k], "ms": device_time(
               lambda s0=s0, k=k, gi=gi: cfb.stage_group_r2(
                   out, ntt_big.tw, s0=s0, k=k, log_n=log_big,
                   encode_in=gi == 0, decode_out=gi == len(plan_big) - 1,
                   src=x if gi == 0 else None)) * 1e3,
               "bound_ms": bb31_bound(log_big, s0, k)["bound_ms"]}
               for gi, (s0, k) in enumerate(plan_big)]}
    say("bb31_timing", f"2^{log_big} plan {plan_big}: chain kernel "
        f"{big['ms']:.3f} ms (bound {big['bound_ms']:.3f} ms); groups "
        + ", ".join(f"{tuple(g['group'])} {g['ms']:.3f} ms (bound "
                    f"{g['bound_ms']:.3f})" for g in big["groups"]))
    del x, out
    return {"ms": ms, "plain_ms": plain_ms, "apply_ms": apply_ms,
            "first_group_ms": first, "upper_groups_ms": groups_ms,
            "per_stage_ms": per_stage_ms, "max_abs_err": worst,
            "largest": big, **b}


def phase_qm31_kernels(dev, num_vars_list=(12, 20)) -> dict:
    rng = np.random.default_rng(SEED + 31)
    worst = {"round": 0, "fold": 0}
    for num_vars in num_vars_list:
        x = to_torch(rng.integers(0, cpr.P, (2, 1 << num_vars, 4),
                                  dtype=np.uint32), dev)
        rows = 1 << num_vars
        while rows >= 2:
            err_r = max_abs_err(cpr.round_kernel(x, rows),
                                cpr.round_plain(x, rows))
            ch = rng.integers(0, cpr.P, 4, dtype=np.uint32)
            folded = cpr.fold_kernel(x.clone(), ch, rows)
            err_f = max_abs_err(folded, cpr.fold_plain(x.clone(), ch, rows))
            require(err_r == 0 and err_f == 0, f"QM31 kernels differ from "
                    f"plain at num_vars {num_vars}, rows {rows} (round "
                    f"{err_r}, fold {err_f})")
            worst["round"] = max(worst["round"], err_r)
            worst["fold"] = max(worst["fold"], err_f)
            x = folded
            rows //= 2
        say("qm31_kernels", f"num_vars {num_vars}: round and fold word-equal "
            f"to plain at every live row count {1 << num_vars}..2 "
            f"(max_abs_err 0, tolerance exact)")
    return worst


@contextlib.contextmanager
def plain_prime():
    """The QM31 prover's round and fold calls go to the plain versions."""
    saved = cpr.round_kernel, cpr.fold_kernel
    cpr.round_kernel, cpr.fold_kernel = cpr.round_plain, cpr.fold_plain
    try:
        yield
    finally:
        cpr.round_kernel, cpr.fold_kernel = saved


def phase_qm31_main(dev, pg, num_vars=24, golden_num_vars=20):
    t0 = time.perf_counter()
    vals = mt19937_stream(QM31_SEED, (8 << num_vars) + 4 * num_vars) \
        % np.uint32(cpr.P)
    evals = vals[:8 << num_vars].reshape(2, 1 << num_vars, 4)
    challenges = vals[8 << num_vars:].reshape(num_vars, 4)
    say("qm31_main", f"set-up (mt19937 inputs, {vals.size} words) "
        f"{time.perf_counter() - t0:.1f} s host")

    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    messages = pg.transcript(PrimeFieldSumcheck(evals, device=dev),
                             challenges)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    launches = {"prime_round": cpr.round_kernel.launches,
                "prime_fold": cpr.fold_kernel.launches}
    check_transcript(messages[:-1], challenges, messages[-1])
    say("qm31_main", f"PrimeFieldSumcheck(2 x 2^{num_vars} QM31 values): "
        f"{num_vars} rounds pass the host check (p(0) + p(1) = the claim, "
        f"the next claim by interpolation, the final product = the last "
        f"claim); {sec:.3f} s host clock incl. upload; transcript MD5 "
        f"{pg.transcript_md5(messages)}")
    require(launches == {"prime_round": num_vars, "prime_fold": num_vars},
            f"expected {num_vars} round and fold launches, got {launches}")
    say("qm31_main", f"launches {launches}")

    with plain_prime():
        plain = pg.transcript(PrimeFieldSumcheck(evals, device=dev),
                              challenges)
    require(len(plain) == len(messages) and all(
        np.array_equal(a, b) for a, b in zip(plain, messages)),
        "the QM31 transcript differs from the plain versions'")
    say("qm31_main", "transcript equals the plain versions' on the card")

    ev, ch = pg.protocol_inputs(golden_num_vars, mt19937_stream)
    gm = pg.transcript(PrimeFieldSumcheck(ev, device=dev), ch)
    check_transcript(gm[:-1], ch, gm[-1])
    digest = pg.transcript_md5(gm)
    want = pg.PRIME_TRANSCRIPT_MD5[golden_num_vars]
    require(digest == want, f"QM31 num_vars {golden_num_vars}: transcript "
            f"MD5 {digest} != the JAX package's {want}")
    say("qm31_main", f"num_vars {golden_num_vars}: transcript MD5 {digest} "
        f"matches the JAX package's")
    return launches, evals, challenges, messages


def phase_qm31_timing(dev, evals, challenges, worst, num_vars=24) -> dict:
    rows = 1 << num_vars
    x = to_torch(evals, dev)
    err_r = max_abs_err(cpr.round_kernel(x, rows), cpr.round_plain(x, rows))
    err_f = max_abs_err(cpr.fold_kernel(x.clone(), challenges[0], rows),
                        cpr.fold_plain(x.clone(), challenges[0], rows))
    require(err_r == 0 and err_f == 0, f"QM31 kernels differ from plain at "
            f"2^{num_vars} (round {err_r}, fold {err_f})")
    worst["round"] = max(worst["round"], err_r)
    worst["fold"] = max(worst["fold"], err_f)
    t = {"round_ms": device_time(cpr.round_kernel, x, rows),
         "round_plain_ms": device_time(cpr.round_plain, x, rows, warmup=1,
                                       reps=3),
         # the fold works in place: each call folds the same rows again
         "fold_ms": device_time(cpr.fold_kernel, x, challenges[0], rows),
         "fold_plain_ms": device_time(cpr.fold_plain, x, challenges[0],
                                      rows, warmup=1, reps=3)}
    t = {k: v * 1e3 for k, v in t.items()}
    state = to_torch(evals, dev)
    runs = []
    for _ in range(3):
        prover = PrimeFieldSumcheck(state)
        torch.cuda.synchronize()
        seconds = []
        for ch in challenges:
            t0 = time.perf_counter()
            prover.round_messages()
            prover.fold(ch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        runs.append(seconds)
        del prover
    t["protocol_ms"] = statistics.median(sum(r) for r in runs) * 1e3
    half = rows // 2
    t["round_bound"] = bound(half * (3 * QM31_MUL_OPS + 8 * 2 * 3 + 12 * 2),
                             2 * rows * 16, INSTR_OPS_PER_S)
    t["fold_bound"] = bound(2 * half * (QM31_MUL_OPS + 8 * 3),
                            2 * rows * 16 + 2 * half * 16, INSTR_OPS_PER_S)
    say("qm31_timing", f"2^{num_vars}: round and fold word-equal to plain "
        f"on the timed input (max_abs_err 0); first round "
        f"{t['round_ms']:.3f} ms (plain {t['round_plain_ms']:.3f} ms, bound "
        f"{t['round_bound']['bound_ms']:.3f} ms by "
        f"{t['round_bound']['bound_by']}), fold {t['fold_ms']:.3f} ms (plain "
        f"{t['fold_plain_ms']:.3f} ms, bound "
        f"{t['fold_bound']['bound_ms']:.3f} ms by "
        f"{t['fold_bound']['bound_by']}); whole protocol from device state "
        f"{t['protocol_ms']:.3f} ms host clock (median of 3)")
    return t


def live_steps(ntt) -> int:
    """Stages whose twiddles are not all zero (the bound counts only these;
    the kernels multiply at every stage)."""
    return sum(any(bool(t.any()) for t in args if torch.is_tensor(t))
               for _, _, _, args in ntt.stage_steps())


def words_to_ints(words: np.ndarray, ipv: int) -> list[int]:
    return [int.from_bytes(w.astype("<u4").tobytes(), "little")
            for w in words.reshape(-1, ipv)]


def hold_ntt128_output(out, words, log_h: int, log_rate: int,
                       golden) -> str:
    """Hold a transform's output words to the golden digest, or, where the
    table has none, to the scalar oracle (small sizes only); return which."""
    want = golden.get(log_rate, {}).get(log_h)
    if want is not None:
        digest = md5_words(out)
        require(digest == want, f"({log_h}, {log_rate}) digest {digest} != "
                f"golden {want}")
        return "golden MD5"
    ref = additive_ntt_scalar(words_to_ints(words, 4), log_h, log_rate, 7)
    require(words_to_ints(to_numpy(out), 4) == ref,
            f"({log_h}, {log_rate}) differs from the scalar oracle")
    return "scalar oracle"


def phase_butterfly_kernels(dev, golden, sizes=(
        (5, 0), (5, 1), (5, 2), (5, 3), (5, 4), (12, 0), (12, 2),
        (16, 2))) -> dict:
    worst = {"butterfly_high": 0, "butterfly_low": 0}
    for log_h, log_rate in sizes:
        ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device=dev)
        words = mt19937_stream(SEED + log_h + log_rate, (1 << log_h) * 4)
        x = bitslice_transpose(to_torch(words, dev).reshape(-1, W)).repeat(
            1 << log_rate, 1)
        for s, kernel, plain, args in ntt.stage_steps():
            name = kernel.__name__
            want = plain(x.clone(), *args)
            kernel(x, *args)
            torch.cuda.synchronize()
            err = max_abs_err(x, want)
            require(err == 0, f"{name} at stage {s} of ({log_h}, "
                    f"{log_rate}) differs from plain ({err})")
            worst[name] = max(worst[name], err)
        held = hold_ntt128_output(bitslice_untranspose(x).reshape(-1), words,
                                  log_h, log_rate, golden)
        say("butterfly_kernels", f"({log_h}, {log_rate}): {log_h - 5} high "
            f"and 5 low stages ({x.shape[0]} rows; high routes "
            f"{step_routes(ntt, ck.butterfly_high)}, low routes "
            f"{step_routes(ntt, ck.butterfly_low)}) word-equal to plain "
            f"after every stage (max_abs_err {max(worst.values())}, "
            f"tolerance exact); chained output matches the {held}")
    worst["butterfly_high"] = max(worst["butterfly_high"],
                                  check_high_routes(dev))
    worst["butterfly_low"] = max(worst["butterfly_low"],
                                 check_low_routes(dev))
    return worst


def step_route(args) -> str:
    """The route a per-stage step's arguments ask for (its flag is the
    last argument)."""
    return "chunk32" if args[-1] else "general"


def step_routes(ntt, kernel) -> list[str]:
    """The route of each stage of a per-stage transform that ``kernel``
    runs, in the transform's order."""
    return [step_route(args) for _, k, _, args in ntt.stage_steps()
            if k is kernel]


def check_high_routes(dev, shapes=((2, 1), (6, 1), (48, 8), (32, 16),
                                   (64, 32), (4096, 1024),
                                   (65536, 2))) -> int:
    """butterfly_high vs plain on both routes, on random rows and tables
    at (rows, db): the general route with every word of w4 random, CHUNK32
    with random GF(2^32) twiddles (word 0); partial tiles (2, 6 and 48
    rows), several blocks a tile (db < 16), one block over several tiles
    (db >= 16), more tiles than resident blocks (65536 rows)."""
    rng = np.random.default_rng(SEED + 191)
    worst = 0
    for rows, db in shapes:
        for chunk32 in (True, False):
            w4 = rng.integers(0, 1 << 32, (rows // (2 * db), 4),
                              dtype=np.uint32)
            if chunk32:
                w4[:, 1:] = 0
            w4 = to_torch(w4, dev)
            require(subfield_step((w4,)) == chunk32,
                    "random table on the wrong side of the subfield test")
            x = to_torch(rng.integers(0, 1 << 32, (rows, W),
                                      dtype=np.uint32), dev)
            want = ck.butterfly_high_plain(x.clone(), w4)
            ck.butterfly_high(x, w4, chunk32)
            torch.cuda.synchronize()
            err = max_abs_err(x, want)
            route = "chunk32" if chunk32 else "general"
            require(err == 0, f"butterfly_high ({route}) differs from plain "
                    f"on {rows} random rows at db {db} ({err})")
            worst = max(worst, err)
    say("butterfly_kernels", f"butterfly_high on random tables, (rows, db) "
        f"{list(shapes)}: both routes word-equal to plain (max_abs_err "
        f"{worst})")
    return worst


def check_low_routes(dev, rows=(1, 2, 3, 4096)) -> int:
    """butterfly_low vs plain at every stage on both routes, on random
    rows and tables: the general one with every plane of a4 and the lane
    planes random, CHUNK32 with random GF(2^32) twiddles (a4 word 0 and
    lane planes 0..31); odd row counts leave a row without a partner."""
    rng = np.random.default_rng(SEED + 19)
    worst = 0
    for n in rows:
        for chunk32 in (True, False):
            a4 = rng.integers(0, 1 << 32, (n, 4), dtype=np.uint32)
            lanes = rng.integers(0, 1 << 32, W, dtype=np.uint32)
            if chunk32:
                a4[:, 1:] = 0
                lanes[32:] = 0
            a4, lanes = to_torch(a4, dev), to_torch(lanes, dev)
            require(subfield_step((a4, lanes)) == chunk32,
                    "random tables on the wrong side of the subfield test")
            route = "chunk32" if chunk32 else "general"
            for s in range(5):
                x = to_torch(rng.integers(0, 1 << 32, (n, W),
                                          dtype=np.uint32), dev)
                want = ck.butterfly_low_plain(x.clone(), a4, lanes, s)
                ck.butterfly_low(x, a4, lanes, s, chunk32)
                torch.cuda.synchronize()
                err = max_abs_err(x, want)
                require(err == 0, f"butterfly_low ({route}) differs from "
                        f"plain on {n} random rows at stage {s} ({err})")
                worst = max(worst, err)
    say("butterfly_kernels", f"butterfly_low on random tables, rows "
        f"{list(rows)}, stages 4..0: both routes word-equal to plain "
        f"(max_abs_err {worst})")
    return worst


def phase_per_stage_main(dev, golden, runs):
    """runs: phase 5's (log_rate, fused transform, mt19937 words)."""
    log_h = (runs[0][2].size // 4).bit_length() - 1
    t0 = time.perf_counter()
    big = [(log_rate, AdditiveNTT128(log_h, log_rate, use_fused=False,
                                     device=dev), words)
           for log_rate, _, words in runs]
    small = [(log_rate, AdditiveNTT128(5, log_rate),
              mt19937_stream(SEED + 5 + log_rate, 32 * 4))
             for log_rate in range(5)]
    say("per_stage_main", f"set-up (stage tables) "
        f"{time.perf_counter() - t0:.1f} s host")
    total = {"butterfly_high": 0, "butterfly_low": 0}
    for (log_rate, ntt, words), lh in ([(r, log_h) for r in big]
                                       + [(r, 5) for r in small]):
        require(ntt.device == dev and not ntt.use_fused,
                f"({lh}, {log_rate}) is not the per-stage path on {dev}")
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ntt.apply(words)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        counts = {"butterfly_high": ck.butterfly_high.launches,
                  "butterfly_low": ck.butterfly_low.launches}
        others = sum(w.launches for w in COUNTED) - sum(counts.values())
        require(counts == {"butterfly_high": lh - 5, "butterfly_low": 5}
                and others == 0, f"({lh}, {log_rate}): expected {lh - 5} "
                f"butterfly_high and 5 butterfly_low launches and no other, "
                f"got {counts} and {others} others")
        routes = {"high": dict(ck.butterfly_high.route_launches),
                  "low": dict(ck.butterfly_low.route_launches)}
        require(routes == {"high": {"chunk32": lh - 5, "general": 0},
                           "low": {"chunk32": 5, "general": 0}},
                f"({lh}, {log_rate}): every stage must take the CHUNK32 "
                f"route, got {routes}")
        for name in total:
            total[name] += counts[name]
        require(tuple(out.shape) == ((1 << (lh + log_rate)) * 4,),
                f"output shape {tuple(out.shape)}")
        held = hold_ntt128_output(out, words, lh, log_rate, golden)
        say("per_stage_main", f"AdditiveNTT128({lh}, {log_rate}"
            f"{', use_fused=False' if lh > 5 else ''}).apply: {held} "
            f"matches; launches {counts} (routes {routes}), "
            f"stage_group 0; {sec:.3f} s host clock incl. upload and layout")
    say("per_stage_main", f"launches {total}")
    return total, big


def phase_per_stage_timing(dev, runs, big) -> dict:
    """runs: phase 5's (log_rate, fused transform, words); big: phase
    20's per-stage transforms on the same inputs."""
    out = {"err": {"butterfly_high": 0, "butterfly_low": 0}}
    for (log_rate, fused, words), (_, ntt, _) in zip(runs, big):
        sliced = bitslice_transpose(to_torch(words, dev).reshape(-1, W))
        x = sliced.repeat(1 << log_rate, 1)
        steps = list(ntt.stage_steps())
        stage_ms, held = [], {}
        alone = {"butterfly_high": [], "butterfly_low": []}
        for s, kernel, plain, args in steps:
            name = kernel.__name__
            # R / 2 multiplies of 32 products: a high stage's row pairs, a
            # low stage's lanes that reach the output (the u lanes of un;
            # the v lanes are rebuilt from them); x read and written, the
            # tables read
            stage_bound = bound(
                x.shape[0] // 2 * mul_ops(subfield_step(args)),
                2 * x.numel() * 4 + sum(t.numel() * 4 for t in args
                                        if torch.is_tensor(t)))
            if name not in held:       # the top stage of each kernel
                got = kernel(x.clone(), *args)
                err = max_abs_err(got, plain(x.clone(), *args))
                require(err == 0, f"{name} at stage {s} of ({ntt.log_h}, "
                        f"{log_rate}) differs from plain on the timed input "
                        f"({err})")
                out["err"][name] = max(out["err"][name], err)
                xt = x.clone()
                torch.cuda.reset_peak_memory_stats()
                plain_ms = device_time(plain, xt, *args, warmup=1,
                                       reps=3) * 1e3
                peak = torch.cuda.max_memory_allocated()
                held[name] = {"stage": s, "plain_ms": plain_ms,
                              "plain_peak_gib": peak / 2**30,
                              "ms": device_time(kernel, xt, *args) * 1e3,
                              **stage_bound}
                del xt
                stage_ms.append(held[name]["ms"])
            else:
                stage_ms.append(device_time(kernel, x.clone(), *args) * 1e3)
            alone[name].append({
                "stage": s, "ms": stage_ms[-1], "route": step_route(args),
                "bound_ms": stage_bound["bound_ms"],
                "share_of_bound": stage_bound["bound_ms"] / stage_ms[-1]})
            kernel(x, *args)                    # advance the chain
        chain_ms = device_time(ntt.apply_sliced, sliced) * 1e3
        fused_ms = device_time(fused.apply_sliced, sliced) * 1e3
        torch.cuda.synchronize()
        out[log_rate] = {"chain_ms": chain_ms, "fused_ms": fused_ms,
                         "stage_ms": stage_ms,
                         "high_stages": alone["butterfly_high"],
                         "low_stages": alone["butterfly_low"], **held}
        # the transform's bound, as the fused one counts it: the live
        # stages' multiplies, the input read and the output written
        live = live_steps(ntt)
        out[log_rate]["chain_bound"] = bound(
            live * (x.shape[0] // 2)
            * mul_ops(all(subfield_step(a) for *_, a in steps)),
            (sliced.numel() + x.numel()) * 4)
        say("per_stage_timing", f"2^{ntt.log_h} rate {log_rate}: per-stage "
            f"chain (apply_sliced, {len(steps)} launches) {chain_ms:.3f} ms "
            f"(bound {out[log_rate]['chain_bound']['bound_ms']:.3f} ms, "
            f"live stages {live}), fused apply_sliced {fused_ms:.3f} ms; "
            f"stages {steps[0][0]}..0 alone "
            f"{[round(t, 3) for t in stage_ms]} ms")
        for name, stages in alone.items():
            say("per_stage_timing", f"rate {log_rate} {name}, every stage "
                f"alone: " + ", ".join(
                    f"s={t['stage']} {t['route']} {t['ms']:.3f} ms "
                    f"({100 * t['share_of_bound']:.1f}% of its bound "
                    f"{t['bound_ms']:.3f} ms)" for t in stages))
        for name, t in held.items():
            say("per_stage_timing", f"rate {log_rate} {name} stage "
                f"{t['stage']} word-equal to plain on its chain input "
                f"(max_abs_err 0): kernel {t['ms']:.3f} ms, plain "
                f"{t['plain_ms']:.3f} ms (chunks of {ck.PLAIN_CHUNK} rows, "
                f"peak {t['plain_peak_gib']:.1f} GiB), bound "
                f"{t['bound_ms']:.3f} ms by {t['bound_by']}")
    return out


def phase_compact_mul(dev, n=1 << 24) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ops = {}
    for h in (5, 6, 7):
        shape = (n, 1 << (h - 5))
        ops[h] = tuple(torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                                     device=dev, generator=gen)
                       for _ in range(2))
    reset_counts()
    outs = {h: tc.mul_compact_tiles(a, b, h) for h, (a, b) in ops.items()}
    torch.cuda.synchronize()
    launches = tc.mul_compact_tiles.launches
    require(launches == 3, f"expected 3 mul_compact_tiles launches, got "
            f"{launches}")
    rng = np.random.default_rng(SEED + 128)
    out = {"launches": launches, "max_abs_err": 0}
    for h, (a, b) in ops.items():
        err = max_abs_err(outs[h], tc.mul_compact(a, b, h))
        require(err == 0, f"mul_compact_tiles at height {h} differs from "
                f"mul_compact ({err})")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        idx = torch.from_numpy(rng.choice(n, 4096, replace=False)).to(dev)
        sa, sb, sz = (to_numpy(t[idx]) for t in (a, b, outs[h]))
        nl = 1 << (h - 5)
        for x, y, z in zip(words_to_ints(sa, nl), words_to_ints(sb, nl),
                           words_to_ints(sz, nl)):
            require(z == ts.multiply(x, y, h), f"mul_compact_tiles at "
                    f"height {h} differs from the scalar oracle")
        ms = device_time(tc.mul_compact_tiles, a, b, h) * 1e3
        run_ms = run_time(tc.mul_compact_tiles, a, b, h) * 1e3
        plain_ms = device_time(tc.mul_compact, a, b, h, warmup=1,
                               reps=3) * 1e3
        # the bit-sliced multiply and the transposes of a, b and the
        # product (nl words an element each), per element
        per = tower_mul_ops(h) / 32 + 3 * nl * TRANSPOSE32_OPS / 32
        out[h] = {"ms": ms, "run_ms": run_ms, "plain_ms": plain_ms,
                  **bound(n * per, 3 * n * nl * 4)}
        say("compact_mul", f"height {h}, {n} elements of {nl} limbs: "
            f"word-equal to mul_compact (max_abs_err 0, tolerance exact), "
            f"4096 sampled products equal the scalar oracle; kernel "
            f"{ms:.3f} ms ({run_ms:.3f} ms a call back to back), plain "
            f"{plain_ms:.3f} ms, bound "
            f"{out[h]['bound_ms']:.3f} ms by {out[h]['bound_by']} "
            f"({per:.1f} operations a product in the bit-sliced form; "
            f"{out[h]['bound_ms'] / ms:.0%} of it)")
    del ops, outs
    a = 0x0123456789ABCDEF0011223344556677
    b = 0xFEDCBA9876543210AABBCCDDEEFF0099
    limbs = [to_torch(np.frombuffer(v.to_bytes(16, "little"),
                                    dtype=np.uint32).reshape(1, 4), dev)
             for v in (a, b)]
    got = words_to_ints(to_numpy(tc.mul_compact_tiles(*limbs, 7)), 4)[0]
    require(got == ts.multiply(a, b, 7), "the 128-bit vector differs")
    say("compact_mul", f"launches {launches}; the reference's 128-bit vector "
        f"matches the scalar oracle")
    return out

# ---- the sharded paths (phases 23-25) ----

SHARDS = 4                      # LocalMesh shards of the sharded main path


def _sharded_groups_vs_plain(log_h: int, log_rate: int, log_d: int,
                             dev) -> int:
    """Every shard's local groups, kernel with its dplanes vs plain, group
    by group on the shard's block of the mt19937 input; returns max err."""
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    tables = cf.build_tables_sharded(rows, log_h, log_rate, log_d, dev)
    data = sliced_input(log_h, log_rate, dev)
    sb = data.shape[0] >> log_d
    worst, before = 0, cf.stage_group.dplanes_launches
    for d in range(1 << log_d):
        x = data[d * sb:(d + 1) * sb].repeat(1 << log_rate, 1).view(
            1 << log_rate, sb, W)
        for (t0, k, low, mtile, minst, lanes, zero, chunk32,
             dtab) in tables:
            require(chunk32, f"sharded ({log_h}, {log_rate}) group (t0={t0}, "
                    f"k={k}) is not flagged CHUNK32")
            kw = dict(t0=t0, k=k, include_low=low, zero_flags=zero,
                      dplanes=shard_dplanes(dtab, d))
            want = cf.stage_group_plain(x.clone(), mtile, minst, lanes, **kw)
            cf.stage_group(x, mtile, minst, lanes, chunk32=chunk32, **kw)
            torch.cuda.synchronize()
            err = max_abs_err(x, want)
            require(err == 0, f"stage_group with dplanes (t0={t0}, k={k}) "
                    f"on shard {d} of {1 << log_d} at ({log_h}, {log_rate}) "
                    f"differs from plain ({err})")
            worst = max(worst, err)
            del want
    n = len(tables) << log_d
    require(cf.stage_group.dplanes_launches == before + n,
            "a group ran without its dplanes")
    say("sharded_kernels", f"({log_h}, {log_rate}) on {1 << log_d} shards, "
        f"plan {[(t0, k, low) for (t0, k, low, *_) in tables]} CHUNK32: "
        f"every shard's groups with its dplanes word-equal to plain "
        f"(max_abs_err {worst}, tolerance exact)")
    return worst


def _sharded_random_tables(log_h: int, log_d: int, dev) -> int:
    """Both routes on random tables and random corrections, each shard's
    local plan; returns max err."""
    random_group_tables = load_test_file(
        "torch_stage_group_tables").random_group_tables
    worst = 0
    plan = list(reversed(cf.plan_groups(log_h - 5 - log_d)))
    nb_l = (1 << log_h) // 32 >> log_d
    for width, route in ((W, "general"), (cf.SUB_PLANES, "chunk32")):
        rng = np.random.default_rng(SEED + 7 * log_h + width)
        before = cf.stage_group.route_launches[route]
        for d in range(1 << log_d):
            x = to_torch(rng.integers(0, 1 << 32, (2, nb_l, W),
                                      dtype=np.uint32), dev)
            for t0, k, low in plan:
                mtile, minst, lanes = random_group_tables(rng, k, low, width,
                                                          dev)
                dpl = np.zeros((k + 5 * low, W), np.uint32)
                dpl[:, :width] = rng.integers(0, 1 << 32, (k + 5 * low,
                                                           width),
                                              dtype=np.uint32)
                kw = dict(t0=t0, k=k, include_low=low,
                          dplanes=to_torch(dpl, dev))
                want = cf.stage_group_plain(x.clone(), mtile, minst, lanes,
                                            **kw)
                cf.stage_group(x, mtile, minst, lanes,
                               chunk32=route == "chunk32", **kw)
                torch.cuda.synchronize()
                err = max_abs_err(x, want)
                require(err == 0, f"stage_group ({route}) with random "
                        f"dplanes (t0={t0}, k={k}, shard {d}) differs from "
                        f"plain ({err})")
                worst = max(worst, err)
        require(cf.stage_group.route_launches[route]
                == before + (len(plan) << log_d),
                f"the {route} route was not taken")
    say("sharded_kernels", f"({log_h}, 1) on {1 << log_d} shards, plan "
        f"{plan} on random tables and corrections: general (planes 0..127) "
        f"and CHUNK32 (planes 0..31) word-equal to plain (max_abs_err "
        f"{worst}, tolerance exact)")
    return worst


def _cross_stage_products(dev) -> int:
    """mul_tiles at the cross-device stages' shapes of the 2^24 transform
    on SHARDS shards (a twiddle a coset, broadcast over a shard's half)
    vs plain; returns max err."""
    rng = np.random.default_rng(SEED + 23)
    worst = 0
    for log_rate in (0, 2):
        cosets = 1 << log_rate
        half = (1 << 19) // SHARDS // 2          # batches in a shard half
        w4 = rng.integers(0, 1 << 32, (cosets, 4), dtype=np.uint32)
        w4[:, 1:] = 0                            # twiddles in GF(2^32)
        w = ck._expand_bits(to_torch(w4, dev))
        a = w[:, None, :].expand(cosets, half, W).reshape(-1, W).contiguous()
        b = to_torch(rng.integers(0, 1 << 32, (cosets * half, W),
                                  dtype=np.uint32), dev)
        err = max_abs_err(ck.mul_tiles(a, b), ck.mul_tiles_plain(a, b))
        require(err == 0, f"mul_tiles at the cross-device shape (rate "
                f"{log_rate}, {cosets * half} rows) differs from plain "
                f"({err})")
        worst = max(worst, err)
        say("sharded_kernels", f"mul_tiles at the cross-device stage's "
            f"shape, rate {log_rate}: {cosets * half} rows, word-equal to "
            f"plain (max_abs_err {err}, tolerance exact)")
    return worst


def phase_sharded_kernels(dev) -> dict:
    worst = 0
    for log_d in (2, 3):
        for log_rate in (0, 2):
            worst = max(worst, _sharded_groups_vs_plain(16, log_rate, log_d,
                                                        dev))
    with forced_plan(2, 2, 2):           # multi-group seams, shard-local
        for log_d in (2, 3):
            worst = max(worst, _sharded_groups_vs_plain(12, 0, log_d, dev))
        worst = max(worst, _sharded_random_tables(12, 3, dev))
    return {"stage_group": worst, "mul_tiles": _cross_stage_products(dev)}


def prime_transcript(prover, challenges) -> list:
    """The QM31 transcript of tests/test_torch_prime_sumcheck_golden.py
    (every round's points, then the two values left), for a sharded
    prover, whose last values are in its tail's state."""
    messages = []
    for ch in challenges:
        messages.append(np.asarray(prover.round_messages()))
        prover.fold(ch)
    d = prover.state_dict()
    evals = d["evals"] if d["evals"] is not None else d["tail"]["evals"]
    messages.append(np.asarray(evals)[:, 0])
    return messages


def phase_sharded_main(dev, golden, golden32, sc, sc_words, sc_challenges,
                       sc_messages, pg, q_evals, q_challenges, q_messages):
    """The eighth path: every sharded class on LocalMesh(SHARDS) on the
    card, the counters reset just before each drive and read just after."""
    log_h = 24
    mesh = make_mesh(SHARDS, dev)
    t0 = time.perf_counter()
    ntts = [(r, ShardedAdditiveNTT128(log_h, r, mesh)) for r in (0, 2)]
    inputs = {r: sliced_input(log_h, r, dev) for r in (0, 2)}
    say("sharded_main", f"set-up (twiddles, sharded tables, inputs) "
        f"{time.perf_counter() - t0:.1f} s host")

    def check_ntt(r, out, where):
        require(tuple(out.shape) == ((1 << (log_h + r)) // 32, W),
                f"{where} output shape {tuple(out.shape)}")
        digest = md5_words(bitslice_untranspose(out).reshape(-1))
        require(digest == golden[r][log_h], f"{where} ({log_h}, {r}) digest "
                f"{digest} != golden {golden[r][log_h]}")
        return digest

    reset_counts()
    outs = [(r, ntt.apply_sliced(inputs[r])) for r, ntt in ntts]
    torch.cuda.synchronize()
    launches = {"stage_group": cf.stage_group.launches,
                "stage_group_dplanes": cf.stage_group.dplanes_launches,
                "stage_group_routes": dict(cf.stage_group.route_launches),
                "mul_tiles": ck.mul_tiles.launches}
    for r, out in outs:
        digest = check_ntt(r, out, "ShardedAdditiveNTT128")
        say("sharded_main", f"ShardedAdditiveNTT128({log_h}, {r}, LocalMesh("
            f"{SHARDS}, cuda)).apply_sliced: golden MD5 {digest} matches")
    del outs
    n_sg = launches["stage_group"]
    require(n_sg > 0 and launches["stage_group_dplanes"] == n_sg
            and launches["stage_group_routes"] == {"chunk32": n_sg,
                                                   "general": 0},
            f"every sharded group must launch with dplanes on the CHUNK32 "
            f"route: {launches}")
    require(launches["mul_tiles"] > 0, "mul_tiles never launched")
    say("sharded_main", f"launches: stage_group {n_sg} (with dplanes "
        f"{launches['stage_group_dplanes']}, by route "
        f"{launches['stage_group_routes']}), mul_tiles "
        f"{launches['mul_tiles']}")

    reset_counts()
    for comp in COMPS:
        t1 = time.perf_counter()
        messages = sc.transcript(ShardedSumcheck(
            sc_words[:4 * (1 << log_h) * comp], comp, log_h, mesh),
            sc_challenges)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        verifier.check_transcript(messages, sc_challenges, comp + 1)
        require(same_transcript(messages, sc_messages[comp]),
                f"sharded sumcheck C={comp} transcript differs from phase "
                f"8's single-device one")
        say("sharded_main", f"ShardedSumcheck(2^24, C={comp}, LocalMesh("
            f"{SHARDS})): passes the verifier and equals phase 8's "
            f"single-device transcript; {sec:.3f} s host clock")
    launches.update({"sumcheck_round": cr.round_kernel.launches,
                     "sumcheck_fold": cr.fold_kernel.launches})
    for comp in COMPS:
        w, ch = sc.protocol_inputs(20, comp, mt19937_stream)
        digest = sc.transcript_md5(sc.transcript(
            ShardedSumcheck(w, comp, 20, mesh), ch))
        require(digest == sc.SUMCHECK_TRANSCRIPT_MD5[20][comp],
                f"sharded num_vars 20, C={comp}: transcript MD5 {digest} != "
                f"the JAX package's")
    say("sharded_main", "ShardedSumcheck num_vars 20, C = 2, 3, 4: "
        "transcript MD5s match the JAX package's")

    reset_counts()
    qm = prime_transcript(ShardedPrimeFieldSumcheck(q_evals, mesh),
                          q_challenges)
    launches.update({"prime_round": cpr.round_kernel.launches,
                     "prime_fold": cpr.fold_kernel.launches})
    require(len(qm) == len(q_messages) and all(
        np.array_equal(a, b) for a, b in zip(qm, q_messages)),
        "the sharded QM31 transcript differs from phase 17's")
    check_transcript(qm[:-1], q_challenges, qm[-1])
    say("sharded_main", f"ShardedPrimeFieldSumcheck(2 x 2^24, LocalMesh("
        f"{SHARDS})): equals phase 17's transcript, MD5 "
        f"{pg.transcript_md5(qm)}")
    require(min(launches[k] for k in ("sumcheck_round", "sumcheck_fold",
                                      "prime_round", "prime_fold")) > 0,
            f"a sumcheck kernel was not launched: {launches}")

    out32 = ShardedAdditiveNTT(log_h, 0, mesh).apply(words32(log_h, 0))
    digest = md5_words(out32)
    require(digest == golden32[0][log_h], f"ShardedAdditiveNTT(24, 0) "
            f"digest {digest} != golden")
    say("sharded_main", f"ShardedAdditiveNTT(24, 0, LocalMesh({SHARDS})): "
        f"golden MD5 {digest} matches")
    del out32

    dryrun_multichip(8, dev)
    say("sharded_main", "dryrun_multichip(8, cuda) passed")

    # the transform through a real process group: one rank, NCCL
    with tempfile.TemporaryDirectory() as tmp:
        require(initialize_distributed(f"file://{tmp}/store", 1, 0,
                                       backend="nccl"),
                "no process group was set up")
        try:
            dmesh = make_mesh(device=dev)
            require(isinstance(dmesh, DistMesh), "not a DistMesh")
            for r in (0, 2):
                digest = check_ntt(r, ShardedAdditiveNTT128(
                    log_h, r, dmesh).apply_sliced(inputs[r]), "NCCL")
                say("sharded_main", f"ShardedAdditiveNTT128(24, {r}) on a "
                    f"world-size-1 NCCL group: golden MD5 {digest} matches")
        finally:
            shutdown_distributed()
    say("sharded_main", f"launches {launches}")
    return launches, ntts, inputs


def phase_sharded_timing(smi, ntt_runs, ntts, inputs) -> dict:
    """CUDA events at 2^24 on LocalMesh(SHARDS): the sharded apply_sliced
    beside the single-device one, the shards' local stage-group chain with
    and without dplanes, and the cross-device stages alone."""
    single = {r: ntt for r, ntt, _ in ntt_runs}
    out = {}
    for r, sh in ntts:
        sliced = inputs[r]
        xs = sh.shard_input(sliced)

        def chain(dplanes: bool):
            for d, x in xs.items():
                for g, dpl in zip(sh.groups, sh.dplanes[d]):
                    cf.stage_group(x, *g[3:6], t0=g[0], k=g[1],
                                   include_low=g[2], zero_flags=g[6],
                                   chunk32=g[7],
                                   dplanes=dpl if dplanes else None)

        t = {"apply_ms": device_time(sh.apply_sliced, sliced),
             "single_apply_ms": device_time(single[r].apply_sliced, sliced),
             "chain_dplanes_ms": device_time(chain, True),
             "chain_null_ms": device_time(chain, False),
             "cross_ms": device_time(sh.cross_stages, xs)}
        t = {k: v * 1e3 for k, v in t.items()}
        say("sharded_timing", f"2^24 rate {r}, LocalMesh({SHARDS}) on one "
            f"card ({smi}): sharded apply_sliced {t['apply_ms']:.3f} ms "
            f"(single-device fused {t['single_apply_ms']:.3f} ms); the "
            f"shards' local stage-group chains {t['chain_dplanes_ms']:.3f} "
            f"ms with dplanes, {t['chain_null_ms']:.3f} ms with null "
            f"dplanes; the cross-device stages alone {t['cross_ms']:.3f} ms "
            f"(exchanges in memory)")
        out[r] = t
        del xs
    return out


# ---- capacity (phase 26) ----

def phase_capacity(dev, golden, log_h: int = 29, log_rate: int = 0) -> dict:
    """The first 2^31-word buffers: AdditiveNTT128(29, 0).apply through the
    capacity gate, then the explicit streamed transforms on the same
    input."""
    timer = PhaseTimer()
    t0 = time.perf_counter()
    require(native_oracle.available(),
            "the native oracle (tools/native/oracle.cpp) did not build")
    n_words = (1 << log_h) * 4
    with timer.phase("input"):
        words = native_oracle.mt19937_fill(SEED + log_h + log_rate, n_words)
    ntt = AdditiveNTT128(log_h, log_rate, device=dev)
    say("capacity", f"set-up: {n_words} mt19937 words from the native "
        f"oracle in {timer.phases['input']:.1f} s, tables "
        f"{time.perf_counter() - t0 - timer.phases['input']:.1f} s host")
    budget = ab.capacity_budget(dev)
    streamed = ab.streams(log_h, log_rate, budget)
    say("capacity", f"gate: route {'streamed' if streamed else 'whole'} "
        f"(predicted whole-array peak "
        f"{ab.whole_array_peak(log_h, log_rate) / 2**30:.2f} GiB = "
        f"{ab.WHOLE_ARRAY_PEAK_FACTOR} x the larger buffer, budget "
        f"{budget / 2**30:.2f} GiB)")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = []
    with timer.phase("apply", block_on=out):
        out.append(ntt.apply(words))
    launches = {"stage_group": cf.stage_group.launches}
    others = sum(w.launches for w in COUNTED) - launches["stage_group"]
    routes = dict(cf.stage_group.route_launches)
    peak = torch.cuda.max_memory_allocated()
    out = out[0]
    require(launches["stage_group"] > 0 and others == 0,
            f"capacity: stage_group launched {launches['stage_group']} "
            f"times and {others} other launches")
    require(routes == {"chunk32": launches["stage_group"], "general": 0},
            f"capacity: every stage_group launch must take the CHUNK32 "
            f"route: {routes}")
    n_out = n_words << log_rate
    require(tuple(out.shape) == (n_out,), f"capacity: output shape "
            f"{tuple(out.shape)} != ({n_out},)")
    say("capacity", f"peak device memory over apply {peak} B "
        f"({peak / 2**30:.2f} GiB), of it {base} B allocated before (the "
        f"module's tables and earlier phases'); apply's own "
        f"{(peak - base) / (n_out * 4):.2f} x the output buffer")
    with timer.phase("hash"):
        digest = md5_chunked(out)
    want = golden[log_rate][log_h]
    require(digest == want, f"capacity: ({log_h}, {log_rate}) digest "
            f"{digest} != golden {want}")
    say("capacity", f"AdditiveNTT128({log_h}, {log_rate}).apply: golden MD5 "
        f"{digest} matches (fed chunk by chunk from device slices); "
        f"launches {launches}, stage_group by route {routes}")

    with timer.phase("streamed"):
        sliced = bitslice_transpose_streamed(words.reshape(-1, W),
                                             device=dev)
        res = ntt.apply_sliced(sliced)
        del sliced
        host = bitslice_untranspose_streamed(res).reshape(-1)
        del res
    with timer.phase("compare"):
        flat, step, same = out.reshape(-1), 1 << 26, True
        for i in range(0, n_out, step):
            same &= bool(np.array_equal(to_numpy(flat[i:i + step]),
                                        host[i:i + step]))
    require(same, "capacity: the streamed transforms' output differs from "
            "apply's")
    say("capacity", "bitslice_transpose_streamed -> apply_sliced -> "
        "bitslice_untranspose_streamed: word-equal to apply's output")
    say("capacity", "phases: " + timer.report().replace("\n", "; "))
    del out, host, words, ntt
    torch.cuda.empty_cache()
    return {"launches": launches["stage_group"], "route_launches": routes,
            "route": "streamed" if streamed else "whole",
            "peak_bytes": peak, "allocated_before_bytes": base,
            "digest": digest, "phases_ms": {
                k: v * 1e3 for k, v in timer.phases.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an sm_90 "
              "GPU", file=sys.stderr)
        return 1
    golden = golden_table()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    mul = phase_mul_tiles(dev)
    sg_err = phase_stage_group(dev, golden)
    launches, ntt_runs = phase_main_path(dev, golden)
    ntt24 = ntt_runs[0][1]
    timing = phase_timing(ntt_runs, dev)
    sc = load_test_file("test_torch_sumcheck_golden")
    sc_err = phase_sumcheck_kernels(dev)
    sc_launches, words, challenges, sc_messages = phase_sumcheck_main(dev,
                                                                      sc)
    sc_timing = phase_sumcheck_timing(dev, words, challenges, sc_err)
    t32 = time.perf_counter()
    golden32 = golden32_table()
    n32_err = phase_ntt32_kernels(dev, golden32)
    n32_launches, n32_runs = phase_ntt32_main(dev, golden32)
    n32_timing = phase_ntt32_timing(dev, n32_runs)
    say("ntt32_timing", f"phases 10-12 took {time.perf_counter() - t32:.1f} "
        f"s")
    t13 = time.perf_counter()
    r2_err = phase_bb31_kernels(dev)
    r2_launches, r2_runs = phase_bb31_main(dev)
    r2_timing = phase_bb31_timing(dev, r2_runs)
    del r2_runs
    pg = load_test_file("test_torch_prime_sumcheck_golden")
    q_err = phase_qm31_kernels(dev)
    q_launches, q_evals, q_challenges, q_messages = phase_qm31_main(dev, pg)
    q_timing = phase_qm31_timing(dev, q_evals, q_challenges, q_err)
    say("qm31_timing", f"phases 13-18 took {time.perf_counter() - t13:.1f} "
        f"s")
    t19 = time.perf_counter()
    bf_err = phase_butterfly_kernels(dev, golden)
    bf_launches, ps_big = phase_per_stage_main(dev, golden, ntt_runs)
    ps_timing = phase_per_stage_timing(dev, ntt_runs, ps_big)
    del ps_big
    say("per_stage_timing", f"phases 19-21 took "
        f"{time.perf_counter() - t19:.1f} s")
    t22 = time.perf_counter()
    cm = phase_compact_mul(dev)
    say("compact_mul", f"phase 22 took {time.perf_counter() - t22:.1f} s")
    t23 = time.perf_counter()
    sh_err = phase_sharded_kernels(dev)
    sh_launches, sh_ntts, sh_inputs = phase_sharded_main(
        dev, golden, golden32, sc, words, challenges, sc_messages, pg,
        q_evals, q_challenges, q_messages)
    sh_timing = phase_sharded_timing(smi, ntt_runs, sh_ntts, sh_inputs)
    del sh_ntts, sh_inputs
    say("sharded_timing", f"phases 23-25 took "
        f"{time.perf_counter() - t23:.1f} s")
    t26 = time.perf_counter()
    cap = phase_capacity(dev, golden)
    say("capacity", f"phase 26 took {time.perf_counter() - t26:.1f} s")

    # bounds of the earlier kernels, from the shapes of their timed calls:
    # 2^24 points (rate 0) for the NTT chains, the sumcheck's first round
    # at 2^24 evaluations and C = 2, the transpose on 2^17 rows
    def live_stages(zero_flags) -> int:
        return sum(not z for flags in zero_flags for z in flags)

    n24, batches = 1 << 24, (1 << 24) // 32
    sc_bounds = {c: sumcheck_bounds(c, batches) for c in COMPS}
    # rate r: 2^r cosets of 2^24 points, 2^(18+r) products a live stage
    sg32_bounds = {r: bound(
        live_stages(tabs["zero"] for *_, tabs in ntt.tables)
        * (n24 << r) // 64 * MUL32_OPS, 2 * (n24 << r) * 4)
        for r, ntt, _ in n32_runs}
    sg32_bound = sg32_bounds[0]

    def sumcheck_entry(kind: str, line: int) -> dict:
        return {
            "name": f"sumcheck_{kind}", "route": "cuda",
            "source": f"binius_ntt_tpu_torch/csrc/sumcheck_{kind}.cu",
            "replaces": f"binius_ntt_tpu/sumcheck/pallas_round.py:{line}",
            "launches": sc_launches[f"sumcheck_{kind}"],
            "sharded_launches": sh_launches[f"sumcheck_{kind}"],
            "max_abs_err": sc_err[kind],
            "ms": sc_timing[2][f"{kind}_ms"],
            "plain_ms": sc_timing[2][f"{kind}_plain_ms"],
            "shape": "2^24 evaluations, first round; ms and plain_ms at C=2",
            "ms_by_composition": {
                c: sc_timing[c][f"{kind}_ms"] for c in COMPS},
            "plain_ms_by_composition": {
                c: sc_timing[c][f"{kind}_plain_ms"] for c in COMPS},
            "bound_ms_by_composition": {
                c: sc_bounds[c][kind]["bound_ms"] for c in COMPS},
            "share_of_bound_by_composition": {
                c: sc_bounds[c][kind]["bound_ms"] / sc_timing[c][f"{kind}_ms"]
                for c in COMPS},
            **sc_bounds[2][kind]}

    def prime_entry(kind: str, line: int) -> dict:
        return {
            "name": f"prime_{kind}", "route": "cuda",
            "source": f"binius_ntt_tpu_torch/csrc/prime_{kind}.cu",
            "replaces": "binius_ntt_tpu/sumcheck/pallas_prime_round.py:"
                        f"{line}",
            "launches": q_launches[f"prime_{kind}"],
            "sharded_launches": sh_launches[f"prime_{kind}"],
            "max_abs_err": q_err[kind],
            "ms": q_timing[f"{kind}_ms"],
            "plain_ms": q_timing[f"{kind}_plain_ms"],
            "shape": "2 x 2^24 QM31 values, first round",
            "protocol_ms": q_timing["protocol_ms"],
            **q_timing[f"{kind}_bound"]}

    def per_stage_entry(name: str, line: int) -> dict:
        t = ps_timing[0][name]
        kind = name.removeprefix("butterfly_")
        return {
            "name": name, "route": "cuda",
            "source": "binius_ntt_tpu_torch/csrc/butterfly.cu",
            "replaces": f"binius_ntt_tpu/ntt/pallas_kernels.py:{line}",
            "launches": bf_launches[name],
            "max_abs_err": max(bf_err[name], ps_timing["err"][name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "shape": f"stage {t['stage']} of the 2^24 rate-0 per-stage "
                     f"transform, {ntt24.log_h - 5 if line == 131 else 5} "
                     f"such launches a transform; by_rate has rate 2",
            "by_rate": {r: {k: ps_timing[r][name][k] for k in (
                "stage", "ms", "plain_ms", "bound_ms")} for r in (0, 2)},
            f"{kind}_stages_by_rate": {
                r: ps_timing[r][f"{kind}_stages"] for r in (0, 2)},
            "chain_ms_by_rate": {r: ps_timing[r]["chain_ms"]
                                 for r in (0, 2)},
            "chain_bound_ms_by_rate": {
                r: ps_timing[r]["chain_bound"]["bound_ms"] for r in (0, 2)},
            "fused_apply_sliced_ms_by_rate": {r: ps_timing[r]["fused_ms"]
                                              for r in (0, 2)},
            **{k: t[k] for k in ("bound_ms", "bound_by", "library_ms")}}

    # mul_tiles' one path is the sharded NTT128's cross-device stages
    mul["launches"] = sh_launches["mul_tiles"]
    mul["max_abs_err"] = max(mul["max_abs_err"], sh_err["mul_tiles"])
    mul["cross_stages_ms_by_rate"] = {r: t["cross_ms"]
                                      for r, t in sh_timing.items()}
    kernels = {
        "kernels": [{
            "name": "stage_group", "route": "cuda",
            "source": "binius_ntt_tpu_torch/csrc/stage_group.cu",
            "replaces": "binius_ntt_tpu/ntt/pallas_fused.py:341",
            "launches": launches["stage_group"],
            "max_abs_err": max(sg_err, timing[0]["err"], timing[2]["err"],
                               sh_err["stage_group"]),
            "ms": timing[0]["ms"], "plain_ms": timing[0]["plain_ms"],
            "shape": "every group of the 2^24 rate-0 transform (CHUNK32 "
                     "route); by_rate has rate 2",
            "route_launches": launches["stage_group_routes"],
            "by_rate": {r: {k: timing[r][k] for k in (
                "ms", "general_ms", "group_ms", "apply_ms", "bound_ms")}
                for r in (0, 2)},
            "dplanes": {
                "sharded_launches": sh_launches["stage_group"],
                "with_dplanes": sh_launches["stage_group_dplanes"],
                "max_abs_err": sh_err["stage_group"],
                "shape": f"the local groups of the 2^24 transform on "
                         f"LocalMesh({SHARDS}), every shard",
                "chain_ms_by_rate": {r: t["chain_dplanes_ms"]
                                     for r, t in sh_timing.items()},
                "chain_null_dplanes_ms_by_rate": {
                    r: t["chain_null_ms"] for r, t in sh_timing.items()},
                "sharded_apply_ms_by_rate": {
                    r: t["apply_ms"] for r, t in sh_timing.items()},
                "single_apply_ms_by_rate": {
                    r: t["single_apply_ms"] for r, t in sh_timing.items()}},
            "capacity": {
                "launches": cap["launches"],
                "route_launches": cap["route_launches"],
                "shape": "AdditiveNTT128(29, 0).apply, 2^31 words in and "
                         "out",
                "gate_route": cap["route"], "peak_bytes": cap["peak_bytes"],
                "allocated_before_bytes": cap["allocated_before_bytes"],
                "phases_ms": cap["phases_ms"]},
            **{k: timing[0][k] for k in ("bound_ms", "bound_by",
                                         "library_ms")}},
            sumcheck_entry("round", 175), sumcheck_entry("fold", 294),
            {"name": "bitslice_lane_groups", "route": "cuda",
             "source": "binius_ntt_tpu_torch/csrc/bitslice_lane_groups.cu",
             "replaces": "binius_ntt_tpu/ntt/pallas_fused32.py:130",
             "launches": n32_launches["bitslice_lane_groups"],
             "max_abs_err": max(n32_err["bitslice_lane_groups"],
                                n32_timing["err"]["bitslice_lane_groups"]),
             "shape": "2^17 rows of 128 words (2^24 compact words); "
                      "by_rows has 2^19 rows too",
             "by_rows": {f"2^{k}": v for k, v in n32_timing["lanes"].items()},
             **n32_timing["lanes"][17]},
            {"name": "stage_group32", "route": "cuda",
             "source": "binius_ntt_tpu_torch/csrc/stage_group32.cu",
             "replaces": "binius_ntt_tpu/ntt/pallas_fused32.py:400",
             "launches": n32_launches["stage_group32"],
             "max_abs_err": max(n32_err["stage_group32"],
                                n32_timing["err"]["stage_group32"]),
             "ms": n32_timing["chain"][0]["ms"],
             "plain_ms": n32_timing["chain"][0]["plain_ms"],
             "shape": "every group of the 2^24 rate-0 transform; "
                      "by_rate has rate 2",
             "by_rate": n32_timing["chain"],
             "bound_ms_by_rate": {r: b["bound_ms"]
                                  for r, b in sg32_bounds.items()},
             "apply_ms_by_rate": n32_timing["apply"],
             "compact_plain_apply_ms": n32_timing["compact_ms"],
             **sg32_bound},
            {"name": "stage_group_r2", "route": "cuda",
             "source": "binius_ntt_tpu_torch/csrc/stage_group_r2.cu",
             "replaces": "binius_ntt_tpu/ntt/pallas_fused_bb31.py:222",
             "launches": r2_launches["stage_group_r2"],
             "max_abs_err": max(r2_err, r2_timing["max_abs_err"]),
             "ms": r2_timing["ms"], "plain_ms": r2_timing["plain_ms"],
             "shape": "every group of the 2^24 transform, the bit-reversing "
                      "load included",
             "apply_ms": r2_timing["apply_ms"],
             "first_group_ms": r2_timing["first_group_ms"],
             "upper_groups_ms": r2_timing["upper_groups_ms"],
             "per_stage_plain_apply_ms": r2_timing["per_stage_ms"],
             "largest": r2_timing["largest"],
             "bound_ms": r2_timing["bound_ms"],
             "bound_by": r2_timing["bound_by"],
             "library_ms": r2_timing["library_ms"]},
            prime_entry("round", 121), prime_entry("fold", 200),
            per_stage_entry("butterfly_high", 131),
            per_stage_entry("butterfly_low", 168),
            {"name": "mul_compact", "route": "cuda",
             "source": "binius_ntt_tpu_torch/csrc/mul_compact.cu",
             "replaces": "binius_ntt_tpu/fields/tower_compact.py:87",
             "launches": cm["launches"], "max_abs_err": cm["max_abs_err"],
             "ms": cm[7]["ms"], "plain_ms": cm[7]["plain_ms"],
             "shape": "2^24 GF(2^128) products (height 7, 4 limbs); "
                      "by_height has heights 5 and 6",
             "by_height": {h: cm[h] for h in (5, 6, 7)},
             **{k: cm[7][k] for k in ("bound_ms", "bound_by",
                                      "library_ms")}},
            mul],
    }
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
