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
  6. timing   — stage groups at 2^24 rate 0, kernel vs plain, CUDA events.

Then three lines: the kernels as JSON, the card's name and power limit
from nvidia-smi, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Every comparison is exact word equality (GF(2) arithmetic has no rounding).
The script imports no JAX.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from binius_ntt_tpu_torch import AdditiveNTT128, _build  # noqa: E402
from binius_ntt_tpu_torch.layout.bitslicing import (  # noqa: E402
    bitslice_transpose, bitslice_untranspose)
from binius_ntt_tpu_torch.ntt import cuda_fused as cf  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck  # noqa: E402
from binius_ntt_tpu_torch.ntt.additive import (  # noqa: E402
    precompute_subspace_evals)
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch  # noqa: E402
from binius_ntt_tpu_torch.utils.capabilities import (  # noqa: E402
    check_capabilities)
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream  # noqa: E402

SEED = 0xDEADBEEF
W = 128


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


def golden_table():
    path = ROOT / "tests" / "golden_hashes_oracle.py"
    spec = importlib.util.spec_from_file_location("golden_hashes_oracle",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ADDITIVE_NTT128_HASHES


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

    cf.stage_group.launches = 0
    ck.mul_tiles.launches = 0
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

    mul["launches"] = launches["mul_tiles"]
    kernels = {
        "kernels": [{
            "name": "stage_group", "route": "cuda",
            "source": "binius_ntt_tpu_torch/csrc/stage_group.cu",
            "replaces": "binius_ntt_tpu/ntt/pallas_fused.py:341",
            "launches": launches["stage_group"], "max_abs_err": sg_err,
            "ms": timing["ms"], "plain_ms": timing["plain_ms"]}],
        # built and checked, but not on the NTT path (the sumcheck's)
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
