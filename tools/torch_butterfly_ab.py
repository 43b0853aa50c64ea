#!/usr/bin/env python3
"""Check and time the per-stage GF(2^128) NTT's butterflies on one GPU.

    python3 tools/torch_butterfly_ab.py

Run from the root of a checkout: it builds and times that checkout's
binius_ntt_tpu_torch, so two checkouts run in turns (parent, change,
change, parent) compare two versions on one card.  It holds
``butterfly_high`` and ``butterfly_low`` word for word to their plain
versions at every stage of AdditiveNTT128(12, 2, use_fused=False) on
numpy-seeded random words, then, at 2^24 for rates 0 and 2, on the
chain's own inputs: one random input through the transform, each stage
(high stages 23 .. 5, then low stages 4 .. 0) held to its plain version
and timed alone with CUDA events (median of 7), each on the input the
chain gives it.  Beside them it times the whole per-stage chain
(apply_sliced).  Prints ptxas's figures for every butterfly_high_kernel
and butterfly_low_kernel instantiation (read with this script's own
``_build.kernel_usage``, so a parent checkout reports them too), the route
each stage took, and one JSON object with the card's name and power
limit.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from ab_common import card, ptxas_usage  # noqa: E402
from binius_ntt_tpu_torch import AdditiveNTT128, _build  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_torch  # noqa: E402

SEED = 0xB0F1
LOG_H = 24
W = 128


def route(args) -> str:
    """The route a step's arguments ask for (a checkout before a kernel's
    route flag has no flag there: its one route is the general one)."""
    flag = args[-1] if isinstance(args[-1], bool) else False
    return "chunk32" if flag else "general"


def sliced_words(log_h: int, dev, rng) -> torch.Tensor:
    return to_torch(rng.integers(0, 1 << 32, ((1 << log_h) // 32, W),
                                 dtype=np.uint32), dev)


def check_small(dev, rng) -> int:
    """Both butterflies == their plain versions at every stage of (12,
    2)."""
    ntt = AdditiveNTT128(12, 2, use_fused=False, device=dev)
    x = sliced_words(12, dev, rng).repeat(4, 1)
    held = 0
    for s, kernel, plain, args in ntt.stage_steps():
        want = plain(x.clone(), *args)
        kernel(x, *args)
        if not torch.equal(x, want):
            raise SystemExit(f"{kernel.__name__} differs from plain at "
                             f"stage {s} of (12, 2)")
        held += 1
    return held


def run(log_rate: int, dev, rng) -> dict:
    ntt = AdditiveNTT128(LOG_H, log_rate, use_fused=False, device=dev)
    data = sliced_words(LOG_H, dev, rng)
    x = data.repeat(1 << log_rate, 1)
    out = {"high": {}, "low": {}}
    for s, kernel, plain, args in ntt.stage_steps():
        want = plain(x.clone(), *args)
        got = kernel(x.clone(), *args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"rate {log_rate}: {kernel.__name__} differs "
                             f"from plain at stage {s} of 2^{LOG_H}")
        del got, want
        out["high" if kernel is ck.butterfly_high else "low"][s] = {
            "route": route(args),
            "ms": device_time(kernel, x.clone(), *args) * 1e3}
        kernel(x, *args)                        # advance the chain
    for kind in ("high", "low"):
        out[f"{kind}_sum_ms"] = sum(t["ms"] for t in out[kind].values())
    out["chain_ms"] = device_time(ntt.apply_sliced, data) * 1e3
    torch.cuda.synchronize()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    usage = ptxas_usage(_build, r"butterfly_(?:high|low)_kernel")
    out = {"checkout": os.getcwd(), "card": smi, "ptxas": usage}
    rng = np.random.default_rng(SEED)
    out["held_small_stages"] = check_small(dev, rng)
    for log_rate in (0, 2):
        out[f"r{log_rate}"] = run(log_rate, dev, rng)
        print(f"[time] rate {log_rate}: {out[f'r{log_rate}']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
