#!/usr/bin/env python3
"""Check and time mul_compact_tiles and bitslice_lane_groups on one GPU.

    python3 tools/torch_mul_compact_ab.py [--heights 5 6 7] [--log-n 24]
                                          [--lane-rows-log 17 19]

Run from the root of a checkout: it builds and times that checkout's
binius_ntt_tpu_torch, so two checkouts run in turns (parent, change,
change, parent) compare two versions on one card.  It holds
``mul_compact_tiles`` word for word to ``mul_compact`` at each height on
n = 1, 31, 33, 1000 and 2^16 + 3 numpy-seeded random elements and on the
timed input (2^log_n elements), and ``bitslice_lane_groups`` to
``bitslice_lane_groups_plain`` on 1, 3, 5 and 2^12 + 1 rows and on each
timed input (2^17 and 2^19 rows of 128 words by default).  Then it times
each with CUDA events (median of 7): one call, and a run of RUN calls
back to back, whose time a call leaves out the host's share of a short
launch; the transpose beside its bytes bound (each word read once and
written once at 3.35e12 B/s) and beside a plain copy of the same rows.  Prints ptxas's
figures for every mul_compact_kernel instantiation and the
bitslice_lane_groups kernel, and one JSON object with the card's name and
power limit.  Imports no JAX.
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
from binius_ntt_tpu_torch import _build, tower_compact  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_fused32 as cf32  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_torch  # noqa: E402

SEED = 0xC0A7
BYTES_PER_S = 3.35e12
RUN = 10                                # calls of a back-to-back run


def timed(fn, *args) -> dict:
    """ms of one call, and ms a call in a run of RUN back to back."""
    def run():
        for _ in range(RUN):
            fn(*args)
    return {"ms": device_time(fn, *args) * 1e3,
            "run_ms": device_time(run) * 1e3 / RUN}


def words(rng, shape, dev) -> torch.Tensor:
    return to_torch(rng.integers(0, 1 << 32, shape, dtype=np.uint32), dev)


def check_mul(a, b, height: int) -> None:
    got = tower_compact.mul_compact_tiles(a, b, height)
    if not torch.equal(got, tower_compact.mul_compact(a, b, height)):
        raise SystemExit(f"mul_compact_tiles differs from mul_compact at "
                         f"height {height}, n = {a.shape[0]}")


def check_lanes(x) -> None:
    if not torch.equal(cf32.bitslice_lane_groups(x),
                       cf32.bitslice_lane_groups_plain(x)):
        raise SystemExit(f"bitslice_lane_groups differs from its plain "
                         f"version on {x.shape[0]} rows")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heights", nargs="*", type=int, default=[5, 6, 7])
    ap.add_argument("--log-n", type=int, default=24)
    ap.add_argument("--lane-rows-log", nargs="*", type=int, default=[17, 19])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    usage = ptxas_usage(_build, "mul_compact_kernel|bitslice_lane_groups")
    out = {"checkout": os.getcwd(), "card": smi, "ptxas": usage,
           "mul_compact": {}, "lanes": {}}
    rng = np.random.default_rng(SEED)
    for h in args.heights:
        nl = 1 << (h - 5)
        for n in (1, 31, 33, 1000, (1 << 16) + 3):
            check_mul(words(rng, (n, nl), dev), words(rng, (n, nl), dev), h)
        a, b = (words(rng, (1 << args.log_n, nl), dev) for _ in range(2))
        check_mul(a, b, h)
        t = timed(tower_compact.mul_compact_tiles, a, b, h)
        out["mul_compact"][h] = t
        print(f"[time] mul_compact_tiles height {h}, 2^{args.log_n} "
              f"products: {t['ms']:.3f} ms, {t['run_ms']:.3f} ms a call "
              f"back to back", flush=True)
        del a, b
    for rows in (1, 3, 5, (1 << 12) + 1):
        check_lanes(words(rng, (rows, 128), dev))
    for log_rows in args.lane_rows_log:
        x = words(rng, (1 << log_rows, 128), dev)
        check_lanes(x)
        t = timed(cf32.bitslice_lane_groups, x)
        bound_ms = 2 * x.numel() * 4 / BYTES_PER_S * 1e3
        copy_ms = timed(torch.clone, x)["run_ms"]
        out["lanes"][log_rows] = {**t, "bound_ms": bound_ms,
                                  "copy_run_ms": copy_ms}
        print(f"[time] bitslice_lane_groups on 2^{log_rows} rows: "
              f"{t['ms']:.4f} ms ({bound_ms / t['ms']:.0%} of its bytes "
              f"bound {bound_ms:.4f} ms), {t['run_ms']:.4f} ms a call back "
              f"to back ({bound_ms / t['run_ms']:.0%}); a plain copy of the "
              f"rows (torch.clone) {copy_ms:.4f} ms", flush=True)
        del x
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
