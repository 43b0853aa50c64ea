#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (binius_ntt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one Hopper GPU (sm_90) and
the CUDA toolkit.  Phases, one line each, in order; any failure ends the
run with a non-zero exit and no result line:

  1. device   — a CUDA device of capability (9, 0), its name and power limit;
  2. build    — the kernels of binius_ntt_tpu_torch/csrc built by nvcc;
  3. mul_tiles   — kernel vs its plain torch version on the card, 2^18 rows;
  4. stage_group — kernel vs plain, group by group, at log_h 16 (rates 0
     and 2, production plan) and at (9, 1) and (12, 0) with a forced
     multi-group plan (KB = KU = PT = 2);
  5. main path — AdditiveNTT128(24, r).apply on mt19937 input for r = 0, 2,
     held to the native oracle's golden MD5 digests, with every launch
     counter reset just before and read just after;
  6. timing   — stage groups at 2^24 rate 0, kernel vs plain, CUDA events;
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
     with CUDA events, the stage-group chain, kernel vs plain, at r = 0 and
     2; the lane-group transpose, kernel vs plain; apply at r = 0 and 2;
     and the compact torch path (use_fused=False) as the whole-transform
     plain figure.

Then three lines: the kernels as JSON, the card's name and power limit
from nvidia-smi, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Every comparison is exact word equality (GF(2) arithmetic has no rounding).
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
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from binius_ntt_tpu_torch import (  # noqa: E402
    AdditiveNTT, AdditiveNTT128, Sumcheck, _build)
from binius_ntt_tpu_torch.layout.bitslicing import (  # noqa: E402
    bitslice_transpose, bitslice_untranspose)
from binius_ntt_tpu_torch.ntt import cuda_fused as cf  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_fused32 as cf32  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck  # noqa: E402
from binius_ntt_tpu_torch.ntt.additive import (  # noqa: E402
    precompute_subspace_evals)
from binius_ntt_tpu_torch.sumcheck import cuda_round as cr  # noqa: E402
from binius_ntt_tpu_torch.sumcheck import verifier  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch  # noqa: E402
from binius_ntt_tpu_torch.utils.capabilities import (  # noqa: E402
    check_capabilities)
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream  # noqa: E402

SEED = 0xDEADBEEF
W = 128
SUMCHECK_SEED = 0x5C0024        # the 2^24 sumcheck inputs and challenges
COMPS = (2, 3, 4)               # the reference's composition sizes
COUNTED = (ck.mul_tiles, cf.stage_group, cr.round_kernel, cr.fold_kernel,
           cf32.bitslice_lane_groups, cf32.stage_group32)


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


def phase_mul_tiles(dev) -> dict:
    rows = 1 << 18
    rng = np.random.default_rng(SEED)
    a = to_torch(rng.integers(0, 1 << 32, (rows, W), dtype=np.uint32), dev)
    b = to_torch(rng.integers(0, 1 << 32, (rows, W), dtype=np.uint32), dev)
    got = ck.mul_tiles(a, b)
    want = ck.mul_tiles_plain(a, b)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(err == 0, f"mul_tiles differs from its plain version ({err})")
    ms = device_time(ck.mul_tiles, a, b) * 1e3
    plain_ms = device_time(ck.mul_tiles_plain, a, b, warmup=1, reps=3) * 1e3
    say("mul_tiles", f"{rows} rows word-equal to plain (max_abs_err {err}, "
        f"tolerance exact); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"name": "mul_tiles", "route": "cuda",
            "source": "binius_ntt_tpu_torch/csrc/mul_tiles.cu",
            "replaces": "binius_ntt_tpu/ntt/pallas_kernels.py:200",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _check_groups(log_h: int, log_rate: int, dev, golden) -> int:
    """Kernel vs plain for every group of one transform; returns max err."""
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    tables = cf.build_tables(rows, log_h, log_rate, dev)
    data = sliced_input(log_h, log_rate, dev)
    x = data.repeat(1 << log_rate, 1).view(1 << log_rate, -1, W)
    worst = 0
    for (t0, k, low, mtile, minst, lanes, zero) in tables:
        kw = dict(t0=t0, k=k, include_low=low, zero_flags=zero)
        got = cf.stage_group(x.clone(), mtile, minst, lanes, **kw)
        want = cf.stage_group_plain(x.clone(), mtile, minst, lanes, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"stage_group (t0={t0}, k={k}, low={low}) at "
                f"({log_h}, {log_rate}) differs from plain ({err})")
        worst = max(worst, err)
        x = got
    digest = md5_words(bitslice_untranspose(x.view(-1, W)).reshape(-1))
    want_digest = golden.get(log_rate, {}).get(log_h)
    if want_digest is not None:
        require(digest == want_digest,
                f"({log_h}, {log_rate}) golden digest mismatch")
    say("stage_group", f"({log_h}, {log_rate}) plan "
        f"{[(t0, k, low) for (t0, k, low, *_) in tables]} word-equal to "
        f"plain (max_abs_err {worst}, tolerance exact); digest "
        f"{'golden' if want_digest else 'not in the golden table'}")
    return worst


def phase_stage_group(dev, golden) -> int:
    worst = max(_check_groups(16, 0, dev, golden),
                _check_groups(16, 2, dev, golden))
    saved = (cf.KB, cf.KU, cf.PT)
    cf.KB, cf.KU, cf.PT = 2, 2, 2        # multi-group seams and cosets
    try:
        worst = max(worst, _check_groups(9, 1, dev, golden),
                    _check_groups(12, 0, dev, golden))
    finally:
        cf.KB, cf.KU, cf.PT = saved
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
    say("main", f"launches {launches}")
    return launches, runs[0][1]


def phase_timing(ntt, dev) -> dict:
    sliced = sliced_input(24, 0, dev)
    tables = ntt.tables
    x = sliced.clone().view(1, -1, W)

    def groups(fn):
        for (t0, k, low, mtile, minst, lanes, zero) in tables:
            fn(x, mtile, minst, lanes, t0=t0, k=k, include_low=low,
               zero_flags=zero)

    ms = device_time(groups, cf.stage_group) * 1e3
    apply_ms = device_time(ntt.apply_sliced, sliced) * 1e3
    torch.cuda.reset_peak_memory_stats()
    plain_ms = device_time(groups, cf.stage_group_plain, warmup=1,
                           reps=3) * 1e3
    peak = torch.cuda.max_memory_allocated()
    plan = [(t0, k, low) for (t0, k, low, *_) in tables]
    say("timing", f"2^24 rate 0 stage groups {plan}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms (peak {peak / 2**30:.1f} GiB); "
        f"apply_sliced {apply_ms:.3f} ms")
    return {"ms": ms, "plain_ms": plain_ms}


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
    return launches, words, challenges


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
    timed input (the grid-stride loop runs more than one row pair per
    thread only from num_vars 23), raising ``worst`` to what it finds."""
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
            f"ms), fold {t['fold_ms']:.3f} ms (plain "
            f"{t['fold_plain_ms']:.3f} ms); whole protocol from device "
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
        torch.cuda.reset_peak_memory_stats()
        plain_ms = device_time(groups, cf32.stage_group32_plain, warmup=1,
                               reps=3) * 1e3
        peak = torch.cuda.max_memory_allocated()
        apply_ms = device_time(ntt.apply, x_dev) * 1e3
        out["chain"][log_rate] = {"ms": ms, "plain_ms": plain_ms}
        out["apply"][log_rate] = apply_ms
        plan = [(t0, k, low) for (t0, k, low, _) in ntt.tables]
        say("ntt32_timing", f"2^24 rate {log_rate} stage groups {plan}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (peak "
            f"{peak / 2**30:.1f} GiB); apply from device words "
            f"{apply_ms:.3f} ms")

    rng = np.random.default_rng(SEED + 33)
    x = to_torch(rng.integers(0, 1 << 32, (1 << 17, W), dtype=np.uint32),
                 dev)
    out["lanes"] = {
        "ms": device_time(cf32.bitslice_lane_groups, x) * 1e3,
        "plain_ms": device_time(cf32.bitslice_lane_groups_plain, x, warmup=1,
                                reps=3) * 1e3}
    compact = AdditiveNTT(24, 0, use_fused=False, device=dev)
    out["compact_ms"] = device_time(compact.apply, to_torch(runs[0][2], dev),
                                    warmup=1, reps=3) * 1e3
    say("ntt32_timing", f"bitslice_lane_groups on 2^17 rows (64 MB): kernel "
        f"{out['lanes']['ms']:.3f} ms, plain {out['lanes']['plain_ms']:.3f} "
        f"ms; compact torch path AdditiveNTT(24, 0, use_fused=False).apply "
        f"{out['compact_ms']:.3f} ms")
    return out


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
    launches, ntt24 = phase_main_path(dev, golden)
    timing = phase_timing(ntt24, dev)
    sc = load_test_file("test_torch_sumcheck_golden")
    sc_err = phase_sumcheck_kernels(dev)
    sc_launches, words, challenges = phase_sumcheck_main(dev, sc)
    sc_timing = phase_sumcheck_timing(dev, words, challenges, sc_err)
    t32 = time.perf_counter()
    golden32 = golden32_table()
    n32_err = phase_ntt32_kernels(dev, golden32)
    n32_launches, n32_runs = phase_ntt32_main(dev, golden32)
    n32_timing = phase_ntt32_timing(dev, n32_runs)
    say("ntt32_timing", f"phases 10-12 took {time.perf_counter() - t32:.1f} "
        f"s")

    def sumcheck_entry(kind: str, line: int) -> dict:
        return {
            "name": f"sumcheck_{kind}", "route": "cuda",
            "source": f"binius_ntt_tpu_torch/csrc/sumcheck_{kind}.cu",
            "replaces": f"binius_ntt_tpu/sumcheck/pallas_round.py:{line}",
            "launches": sc_launches[f"sumcheck_{kind}"],
            "max_abs_err": sc_err[kind],
            "ms": sc_timing[2][f"{kind}_ms"],
            "plain_ms": sc_timing[2][f"{kind}_plain_ms"],
            "shape": "2^24 evaluations, first round; ms and plain_ms at C=2",
            "ms_by_composition": {
                c: sc_timing[c][f"{kind}_ms"] for c in COMPS},
            "plain_ms_by_composition": {
                c: sc_timing[c][f"{kind}_plain_ms"] for c in COMPS}}

    mul["launches"] = launches["mul_tiles"]
    kernels = {
        "kernels": [{
            "name": "stage_group", "route": "cuda",
            "source": "binius_ntt_tpu_torch/csrc/stage_group.cu",
            "replaces": "binius_ntt_tpu/ntt/pallas_fused.py:341",
            "launches": launches["stage_group"], "max_abs_err": sg_err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"]},
            sumcheck_entry("round", 175), sumcheck_entry("fold", 294),
            {"name": "bitslice_lane_groups", "route": "cuda",
             "source": "binius_ntt_tpu_torch/csrc/bitslice_lane_groups.cu",
             "replaces": "binius_ntt_tpu/ntt/pallas_fused32.py:130",
             "launches": n32_launches["bitslice_lane_groups"],
             "max_abs_err": max(n32_err["bitslice_lane_groups"],
                                n32_timing["err"]["bitslice_lane_groups"]),
             "ms": n32_timing["lanes"]["ms"],
             "plain_ms": n32_timing["lanes"]["plain_ms"],
             "shape": "2^17 rows of 128 words (2^24 compact words)"},
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
             "apply_ms_by_rate": n32_timing["apply"],
             "compact_plain_apply_ms": n32_timing["compact_ms"]}],
        # built and checked, but on neither of the port's paths.  In the
        # reference it runs in the TPU sumcheck's small rounds (the jnp
        # kernels below the Pallas tile gate multiply through it); the
        # port's sumcheck_round and sumcheck_fold take that work over for
        # every round
        "off_path": [mul],
    }
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
