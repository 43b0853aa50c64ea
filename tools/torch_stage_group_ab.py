#!/usr/bin/env python3
"""Time the GF(2^128) NTT's stage-group chain on one GPU.

    python3 tools/torch_stage_group_ab.py [--plans KB,KU,PT ...]

Run from the root of a checkout: it times that checkout's
binius_ntt_tpu_torch, so two checkouts run in turns (parent, change,
change, parent) compare two versions on one card.  At 2^24, rates 0 and 2,
input on the device, CUDA events (median of 7): the whole chain of
stage_group launches and each group alone, under the package's default
plan and then under each (KB, KU, PT) of --plans, whose output must equal
the default plan's word for word.  Prints one JSON object with the card's
name and power limit.  Imports no JAX.  (chip_smoke.py times the general
route beside the default one.)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from binius_ntt_tpu_torch import AdditiveNTT128  # noqa: E402
from binius_ntt_tpu_torch.layout.bitslicing import (  # noqa: E402
    bitslice_transpose)
from binius_ntt_tpu_torch.ntt import cuda_fused as cf  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_torch  # noqa: E402
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream  # noqa: E402

LOG_H = 24


def chain(x, tables) -> None:
    for g in tables:
        # a checkout before the route flag has 7-element groups
        route = {"chunk32": g[7]} if len(g) > 7 else {}
        cf.stage_group(x, *g[3:6], t0=g[0], k=g[1], include_low=g[2],
                       zero_flags=g[6], **route)


def run(log_rate: int, dev, want=None):
    ntt = AdditiveNTT128(LOG_H, log_rate, device=dev)
    words = mt19937_stream(0xDEADBEEF + LOG_H + log_rate, (1 << LOG_H) * 4)
    sliced = bitslice_transpose(to_torch(words, dev).reshape(-1, 128))
    x = sliced.repeat(1 << log_rate, 1).view(1 << log_rate, -1, 128)
    y = x.clone()
    chain(y, ntt.tables)
    torch.cuda.synchronize()
    if want is not None and not torch.equal(y, want):
        raise SystemExit(f"rate {log_rate}: plan {cf.KB, cf.KU, cf.PT} "
                         f"differs from the default plan")
    groups = [device_time(lambda g=g: chain(x, [g])) * 1e3
              for g in ntt.tables]
    return y, {"plan": [list(g[:3]) for g in ntt.tables],
               "chain_ms": device_time(chain, x, ntt.tables) * 1e3,
               "group_ms": groups}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"checkout": os.getcwd(), "card": smi}
    default = {}
    for r in (0, 2):
        default[r], out[f"r{r} default {cf.KB},{cf.KU},{cf.PT}"] = run(r, dev)
    for plan in args.plans:
        cf.KB, cf.KU, cf.PT = (int(v) for v in plan.split(","))
        for r in (0, 2):
            _, out[f"r{r} plan {plan}"] = run(r, dev, default[r])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
