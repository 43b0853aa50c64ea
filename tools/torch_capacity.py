#!/usr/bin/env python3
"""The port at capacity sizes on one GPU: the checks no other script runs.

    python3 tools/torch_capacity.py [--checks NAME ...] [--out FILE]

Run from the repository root on a machine with one Hopper GPU (80 GB) and
a host compiler (the native oracle makes the mt19937 inputs).  Each check
prints one JSON line (and appends it to the file ``--out`` names, if any)
with its PhaseTimer phases in ms, the device's peak memory
(``max_memory_allocated`` over the check), its wall seconds, whether it
passed, and the card's name and power limit.  Checks:

  peaks     AdditiveNTT128.apply on the whole-array route (the capacity
            gate held off) at 2^24, 2^26, 2^27, 2^28 r0 and 2^26 r2 from
            host mt19937 words: the device peak over the larger of the
            input and output buffers (what WHOLE_ARRAY_PEAK_FACTOR in
            ntt/additive_bitsliced.py is set from), each output held to
            its golden digest (tests/golden_hashes_oracle.py);
  ntt128    AdditiveNTT128 fused, through the capacity gate, at 2^28 r0 and
            2^27 r2, and at 2^28 r0 again on the capacity route (the
            budget set to 0), against the golden digests, with the route
            the gate took and apply_sliced timed on the device;
  per_stage AdditiveNTT128(28, 0, use_fused=False): the first 2^30-word
            buffers through butterfly_high and butterfly_low, against the
            golden digest, every launch on its CHUNK32 route;
  ntt32     the GF(2^32) AdditiveNTT at 2^28 and 2^30 r0 and 2^27 r2 (the
            three-group plans) against the upstream digests
            (tests/golden_hashes.py), the chain and each group timed;
  sumcheck  the 28-variable C = 2 GF(2^128) sumcheck (8.6 GB of state) as
            the reference's stretch run drives it: numpy default_rng(123)
            words, bit-sliced through bitslice_transpose_streamed_cols
            into the device-resident constructor, every round checked
            (sum = claim, p(0) + p(1) = sum), challenges from
            default_rng(7); the first round and the first fold held to
            round_plain and fold_plain over the whole state, in chunks of
            rows, and each timed alone (CUDA events).

The outputs are hashed chunk by chunk from device slices; no output is
copied to the host whole.  Exits non-zero if any check failed.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from binius_ntt_tpu_torch import AdditiveNTT, AdditiveNTT128, Sumcheck  # noqa: E402
from binius_ntt_tpu_torch.layout.bitslicing import (  # noqa: E402
    bitslice_transpose, bitslice_transpose_streamed_cols)
from binius_ntt_tpu_torch.ntt import additive_bitsliced as ab  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_fused as cf  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_fused32 as cf32  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck  # noqa: E402
from binius_ntt_tpu_torch.sumcheck import cuda_round as cr  # noqa: E402
from binius_ntt_tpu_torch.sumcheck import verifier  # noqa: E402
from binius_ntt_tpu_torch.utils import native_oracle  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch  # noqa: E402
from binius_ntt_tpu_torch.utils.timing import PhaseTimer  # noqa: E402
from ab_common import card  # noqa: E402

SEED = 0xDEADBEEF
W = 128
HASH_CHUNK_WORDS = 1 << 26      # 256 MiB of output a host copy
PLAIN_CHUNK_ROWS = 1 << 16      # row pairs a plain sumcheck round or fold
DEV = torch.device("cuda", 0)
# the sizes of each check, (log_h, log_rate)
PEAK_SIZES = ((24, 0), (26, 0), (27, 0), (26, 2), (28, 0))
# (log_h, log_rate, capacity route forced: the budget set to 0)
NTT128_SIZES = ((28, 0, False), (27, 2, False), (28, 0, True))
PER_STAGE_SIZE = (28, 0)
NTT32_SIZES = ((28, 0), (30, 0), (27, 2))
SUMCHECK_VARS, SUMCHECK_COMP = 28, 2


def load_test_file(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def md5_device(t: torch.Tensor) -> str:
    """MD5 of a device tensor's words, little-endian, fed a host copy of
    HASH_CHUNK_WORDS at a time."""
    flat = t.reshape(-1)
    h = hashlib.md5()
    for i in range(0, flat.numel(), HASH_CHUNK_WORDS):
        h.update(memoryview(to_numpy(flat[i:i + HASH_CHUNK_WORDS])))
    return h.hexdigest()


def mt_words(log_h: int, log_rate: int, ipv: int) -> np.ndarray:
    return native_oracle.mt19937_fill(SEED + log_h + log_rate,
                                      (1 << log_h) * ipv)


class Check:
    """One check's record: phases, peak, wall seconds, pass."""

    def __init__(self, args, name: str, **facts):
        self.rec = {"check": name, **facts}
        self.timer = PhaseTimer()
        self.args = args

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        torch.cuda.synchronize()
        self.rec.update(
            wall_s=time.perf_counter() - self.t0,
            peak_bytes=torch.cuda.max_memory_allocated(),
            phases_ms={k: v * 1e3 for k, v in self.timer.phases.items()},
            card=self.args.smi)
        if exc is not None:
            self.rec.update(passed=False, error=f"{exc_type.__name__}: {exc}")
        self.args.results.append(self.rec)
        line = json.dumps(self.rec)
        print(line, flush=True)
        if self.args.out is not None:
            with open(self.args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
        return exc_type is not None and issubclass(exc_type, Exception)


def ntt128_run(c: Check, ntt, words, want: str) -> torch.Tensor:
    out = []
    with c.timer.phase("apply", block_on=out):
        out.append(ntt.apply(words))
    with c.timer.phase("hash"):
        got = md5_device(out[0])
    c.rec.update(md5=got, golden=want, passed=got == want)
    return out[0]


def check_peaks(args):
    gate = ab.capacity_budget
    ab.capacity_budget = lambda device: float("inf")   # whole-array route
    try:
        for log_h, log_rate in PEAK_SIZES:
            with Check(args, "peaks", log_h=log_h, log_rate=log_rate) as c:
                with c.timer.phase("input"):
                    words = mt_words(log_h, log_rate, 4)
                ntt = AdditiveNTT128(log_h, log_rate, device=DEV)
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = ntt128_run(c, ntt, words,
                                 args.golden[log_rate][log_h])
                peak = torch.cuda.max_memory_allocated()
                in_b, out_b = 16 << log_h, 16 << (log_h + log_rate)
                c.rec.update(apply_peak_bytes=peak, tables_bytes=base,
                             in_bytes=in_b, out_bytes=out_b,
                             factor=peak / max(in_b, out_b))
                del out, ntt, words
    finally:
        ab.capacity_budget = gate


def apply_sliced_ms(ntt, log_h: int) -> float:
    """Device ms of apply_sliced (the coset copy and the chain of kernels)
    on a sliced input."""
    x = torch.zeros((1 << log_h) // 32, W, dtype=torch.int32,
                    device=ntt.device)
    ms = device_time(ntt.apply_sliced, x, warmup=1, reps=3) * 1e3
    del x
    return ms


def check_ntt128(args):
    gate = ab.capacity_budget
    for log_h, log_rate, forced in NTT128_SIZES:
        if forced:
            ab.capacity_budget = lambda device: 0
        budget = ab.capacity_budget(DEV)
        with Check(args, "ntt128", log_h=log_h, log_rate=log_rate,
                   fused=True, forced_stream=forced) as c:
            with c.timer.phase("input"):
                words = mt_words(log_h, log_rate, 4)
            ntt = AdditiveNTT128(log_h, log_rate, device=DEV)
            streamed = ab.streams(log_h, log_rate, budget)
            cf.stage_group.route_launches = {"chunk32": 0, "general": 0}
            try:
                out = ntt128_run(c, ntt, words,
                                 args.golden[log_rate][log_h])
            finally:
                ab.capacity_budget = gate
            routes = dict(cf.stage_group.route_launches)
            del out, words
            c.rec.update(route="streamed" if streamed else "whole",
                         predicted_peak_bytes=ab.whole_array_peak(
                             log_h, log_rate),
                         budget_bytes=budget, stage_group_routes=routes,
                         apply_sliced_ms=apply_sliced_ms(ntt, log_h))
            c.rec["passed"] &= routes["general"] == 0 < routes["chunk32"]
            del ntt


def check_per_stage(args):
    log_h, log_rate = PER_STAGE_SIZE
    with Check(args, "per_stage", log_h=log_h, log_rate=log_rate,
               fused=False) as c:
        with c.timer.phase("input"):
            words = mt_words(log_h, log_rate, 4)
        ntt = AdditiveNTT128(log_h, log_rate, use_fused=False, device=DEV)
        for k in (ck.butterfly_high, ck.butterfly_low):
            k.launches = 0
            k.route_launches = {"chunk32": 0, "general": 0}
        out = ntt128_run(c, ntt, words, args.golden[log_rate][log_h])
        del out, words
        launches = {k.__name__: (k.launches, dict(k.route_launches))
                    for k in (ck.butterfly_high, ck.butterfly_low)}
        c.rec.update(launches=launches,
                     apply_sliced_ms=apply_sliced_ms(ntt, log_h))
        c.rec["passed"] &= all(r["general"] == 0 and r["chunk32"] == n > 0
                               for n, r in launches.values())


def check_ntt32(args):
    for log_h, log_rate in NTT32_SIZES:
        with Check(args, "ntt32", log_h=log_h, log_rate=log_rate) as c:
            with c.timer.phase("input"):
                words = mt_words(log_h, log_rate, 1)
            ntt = AdditiveNTT(log_h, log_rate, device=DEV)
            out = []
            with c.timer.phase("apply", block_on=out):
                out.append(ntt.apply(words))
            with c.timer.phase("hash"):
                got = md5_device(out[0])
            want = args.golden32[log_rate][log_h]
            c.rec.update(md5=got, golden=want, passed=got == want,
                         plan=[(t0, k, low) for t0, k, low, _ in ntt.tables])
            out.clear()
            cosets = 1 << log_rate
            x = cf32.bitslice_lane_groups(to_torch(words, DEV).view(
                -1, cf32.W)).repeat(cosets, 1).view(cosets, -1, cf32.W)
            del words

            def group(t0, k, low, tabs):
                cf32.stage_group32(x, tabs, t0=t0, k=k, include_low=low,
                                   cosets=cosets, log_nbr=log_h - 7)

            def chain():
                for g in ntt.tables:
                    group(*g)

            c.rec["chain_ms"] = device_time(chain, warmup=1, reps=3) * 1e3
            c.rec["group_ms"] = [device_time(group, *g, warmup=1, reps=3)
                                 * 1e3 for g in ntt.tables]
            del x, ntt


def plain_round(evals, rows: int, num_points: int) -> torch.Tensor:
    """round_plain over rows [0, rows), PLAIN_CHUNK_ROWS row pairs at a
    time: a round is the XOR of its row pairs' terms."""
    half, acc = rows // 2, None
    for a in range(0, half, PLAIN_CHUNK_ROWS):
        b = min(a + PLAIN_CHUNK_ROWS, half)
        sub = torch.cat([evals[:, a:b], evals[:, half + a:half + b]], dim=1)
        part = cr.round_plain(sub, 2 * (b - a), num_points)
        acc = part if acc is None else acc ^ part
    return acc


def plain_fold(evals, challenge, rows: int) -> torch.Tensor:
    """fold_plain's lower rows [0, rows/2) of evals, row pairs in chunks,
    without touching evals."""
    half = rows // 2
    out = torch.empty_like(evals[:, :half])
    for a in range(0, half, PLAIN_CHUNK_ROWS):
        b = min(a + PLAIN_CHUNK_ROWS, half)
        sub = torch.cat([evals[:, a:b], evals[:, half + a:half + b]], dim=1)
        out[:, a:b] = cr.fold_plain(sub, challenge, 2 * (b - a))[:, :b - a]
    return out


def check_sumcheck(args):
    num_vars, comp = SUMCHECK_VARS, SUMCHECK_COMP
    b = (1 << num_vars) // 32
    with Check(args, "sumcheck", num_vars=num_vars,
               composition=comp) as c:
        with c.timer.phase("input"):
            evals = np.random.default_rng(123).integers(
                0, 2 ** 32, size=(comp, b, W), dtype=np.uint32)
        state = []
        with c.timer.phase("transpose", block_on=state):
            state.append(bitslice_transpose_streamed_cols(evals, device=DEV))
        del evals
        s = Sumcheck(state.pop(), comp, num_vars, data_is_transposed=True)
        rng = np.random.default_rng(7)
        claim, ok, rounds_s = None, True, []
        first = {}
        for rnd in range(num_vars):
            t1 = time.perf_counter()
            if rnd == 0:
                with c.timer.phase("round0_kernel_vs_plain"):
                    got = cr.round_kernel(s._evals, b, comp + 1)
                    want = plain_round(s._evals, b, comp + 1)
                    first["round_equal"] = bool(torch.equal(got, want))
                    del got, want
            with c.timer.phase("rounds"):
                total, pts = s.round_messages()
            t = verifier.words_to_int(total)
            if claim is not None:
                ok = ok and t == claim
            ok = ok and t == (verifier.words_to_int(pts[0])
                              ^ verifier.words_to_int(pts[1]))
            ch = rng.integers(0, 2 ** 32, size=4, dtype=np.uint32)
            claim = verifier.evaluate_univariate_given_points(
                verifier.words_to_int(ch),
                [verifier.words_to_int(p) for p in pts], comp + 1)
            if rnd == 0:
                # the first round's kernels alone, CUDA events; the fold on
                # a copy of the state
                first["round0_ms"] = device_time(
                    cr.round_kernel, s._evals, b, comp + 1, warmup=1,
                    reps=3) * 1e3
                copy = s._evals.clone()
                first["fold0_ms"] = device_time(
                    cr.fold_kernel, copy, ch, b, warmup=1, reps=3) * 1e3
                del copy
                with c.timer.phase("fold0_plain"):
                    want = plain_fold(s._evals, ch, b)
            with c.timer.phase("rounds"):
                s.move_to_next_round(ch)
                torch.cuda.synchronize()
            if rnd == 0:
                first["fold_equal"] = bool(torch.equal(
                    s._evals[:, :b // 2], want))
                del want
            rounds_s.append(time.perf_counter() - t1)
        c.rec.update(passed=bool(ok) and first["round_equal"]
                     and first["fold_equal"],
                     rounds_consistent=bool(ok), **first,
                     round_s=rounds_s)


CHECKS = {"peaks": check_peaks, "ntt128": check_ntt128,
          "per_stage": check_per_stage, "ntt32": check_ntt32,
          "sumcheck": check_sumcheck}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checks", nargs="+", default=list(CHECKS),
                        choices=list(CHECKS))
    parser.add_argument("--out", type=Path, default=None,
                        help="also append each check's JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_capacity: needs a CUDA device", file=sys.stderr)
        return 1
    if not native_oracle.available():
        print("torch_capacity: the native oracle (g++) did not build",
              file=sys.stderr)
        return 1
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
    args.smi = card()
    print(f"[card] {args.smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    args.golden = load_test_file(
        "golden_hashes_oracle").ADDITIVE_NTT128_HASHES
    args.golden32 = load_test_file("golden_hashes").ADDITIVE_NTT_HASHES
    args.results = []
    for name in args.checks:
        CHECKS[name](args)
    failed = [r for r in args.results if not r.get("passed")]
    print(f"[done] {len(args.results)} checks, {len(failed)} failed",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
