#!/usr/bin/env python3
"""Check and time mul_tiles, the standalone GF(2^128) multiply, on one GPU.

    python3 tools/torch_mul_tiles_ab.py [--log-rows 18 19] [--time-only]

Run from the root of a checkout: it builds and times that checkout's
binius_ntt_tpu_torch, so two checkouts run in turns (parent, change,
change, parent) compare two versions on one card.  It holds ``mul_tiles``
word for word to ``mul_tiles_plain`` on 1, 31, 32, 33, 1000, 2^15 + 5 and
2^18 + 5 numpy-seeded random rows and on each timed input (2^18 and 2^19
rows of 128 words by default), then times it with CUDA events (median of
7): one call, and a run of RUN calls back to back, whose time a call
leaves out the host's share of a launch.  Each timed size is printed
beside its bound: 10,326 three-input LOP3 operations a row
(chip_smoke.tower_mul_ops(7)) at 1.67e13 int32 operations/s, against 3 x
512 bytes a row at 3.35e12 B/s.  Prints ptxas's figures for
``mul_tiles_kernel`` and one JSON object with the card's name and power
limit.  ``--time-only`` skips the checks, to time a copy whose output is
wrong by design (a diagnostic that leaves out part of the work).  Imports
no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from ab_common import card, ptxas_usage  # noqa: E402
from binius_ntt_tpu_torch import _build  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_torch  # noqa: E402

SEED = 0x3A7
W = 128
MUL128_OPS = 10_326                     # chip_smoke.tower_mul_ops(7)
INT_OPS_PER_S = 1.67e13
BYTES_PER_S = 3.35e12
RUN = 10                                # calls of a back-to-back run


def timed(fn, *args) -> dict:
    """ms of one call, and ms a call in a run of RUN back to back."""
    def run():
        for _ in range(RUN):
            fn(*args)
    return {"ms": device_time(fn, *args) * 1e3,
            "run_ms": device_time(run) * 1e3 / RUN}


def words(rng, rows: int, dev) -> torch.Tensor:
    return to_torch(rng.integers(0, 1 << 32, (rows, W), dtype=np.uint32), dev)


def check(a, b) -> None:
    got = ck.mul_tiles(a, b)
    if not torch.equal(got, ck.mul_tiles_plain(a, b)):
        raise SystemExit(f"mul_tiles differs from mul_tiles_plain on "
                         f"{a.shape[0]} rows")


def bound_ms(rows: int) -> dict:
    ops = rows * MUL128_OPS / INT_OPS_PER_S * 1e3
    nbytes = 3 * rows * W * 4 / BYTES_PER_S * 1e3
    return {"bound_ms": max(ops, nbytes), "ops_ms": ops, "bytes_ms": nbytes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-rows", nargs="*", type=int, default=[18, 19])
    ap.add_argument("--time-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    usage = ptxas_usage(_build, "mul_tiles_kernel")
    out = {"checkout": os.getcwd(), "card": smi, "ptxas": usage, "rows": {}}
    rng = np.random.default_rng(SEED)
    for rows in () if args.time_only else (1, 31, 32, 33, 1000,
                                           (1 << 15) + 5, (1 << 18) + 5):
        check(words(rng, rows, dev), words(rng, rows, dev))
    for log_rows in args.log_rows:
        rows = 1 << log_rows
        a, b = words(rng, rows, dev), words(rng, rows, dev)
        if not args.time_only:
            check(a, b)
        t = {**timed(ck.mul_tiles, a, b), **bound_ms(rows)}
        out["rows"][log_rows] = t
        print(f"[time] mul_tiles on 2^{log_rows} rows: {t['ms']:.4f} ms "
              f"({t['bound_ms'] / t['ms']:.0%} of its bound "
              f"{t['bound_ms']:.4f} ms; bytes alone {t['bytes_ms']:.4f}), "
              f"{t['run_ms']:.4f} ms a call back to back "
              f"({t['bound_ms'] / t['run_ms']:.0%})", flush=True)
        del a, b
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
