#!/usr/bin/env python3
"""Check and time the BB31 NTT's stage-group chain on one GPU.

    python3 tools/torch_stage_group_r2_ab.py [--plans NAME=V,NAME=V ...]
                                             [--sizes 24 27] [--time-only]

Run from the root of a checkout: it builds and times that checkout's
binius_ntt_tpu_torch, so two checkouts run in turns (parent, change,
change, parent) compare two versions on one card.  Prints ptxas's line for
every stage_group_r2 entry (read with this script's own
``_build.kernel_usage``, so a parent checkout reports its kernel too).
Then for each size (default 2^24 and 2^27), on numpy-seeded random words
on the device, under the package's default plan and then under each entry
of --plans (module settings of ntt/cuda_fused_bb31.py, as in ``KB=13,KU=11``
or ``COLS_LOG=5``): every group held word for word to
stage_group_r2_plain on the input the chain gives it, then with CUDA
events (median of 7) each group alone (the first also without its
bit-reversing load), the whole chain of stage_group_r2 launches and
NTTRadix2(137, 27, N).apply from device words.  Beside each
group it prints the launch the kernel gets (``launch_r2``, where the
checkout has it).  Every plan's output must equal the default plan's.
Prints one JSON object with the card's name and power limit.  Imports no
JAX.  --time-only skips the checks, for diagnostic copies of the kernel
whose output is wrong by design (no arithmetic, or no device memory
traffic).
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
from binius_ntt_tpu_torch import NTTRadix2, _build  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_fused_bb31 as cfb  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_torch  # noqa: E402

SEED = 0xB331


def settings(plan: str) -> dict:
    return {name: int(value) for name, value in
            (item.split("=") for item in plan.split(","))}


def plan_name() -> str:
    return f"KB={cfb.KB},KU={cfb.KU}"


def chain(fn, out, x, tw, log_n: int) -> None:
    plan = cfb.plan_groups_r2(log_n)
    for gi, (s0, k) in enumerate(plan):
        fn(out, tw, s0=s0, k=k, log_n=log_n, encode_in=gi == 0,
           decode_out=gi == len(plan) - 1, src=x if gi == 0 else None)


def run(ntt, x, log_n: int, want=None, check: bool = True) -> tuple:
    plan = cfb.plan_groups_r2(log_n)
    tw = ntt.tw
    out, ref = torch.empty_like(x), torch.empty_like(x)
    groups = []
    for gi, (s0, k) in enumerate(plan):
        kw = dict(s0=s0, k=k, log_n=log_n, encode_in=gi == 0,
                  decode_out=gi == len(plan) - 1, src=x if gi == 0 else None)
        start = out.clone()
        cfb.stage_group_r2(out, tw, **kw)
        if check:
            cfb.stage_group_r2_plain(ref, tw, **kw)
        torch.cuda.synchronize()
        if check and not torch.equal(out, ref):
            raise SystemExit(f"2^{log_n} {plan_name()}: group (s0={s0}, "
                             f"k={k}) differs from stage_group_r2_plain")
        g = {"group": [s0, k],
             "ms": device_time(lambda s=start, kw=kw:
                               cfb.stage_group_r2(s, tw, **kw)) * 1e3}
        if hasattr(cfb, "launch_r2"):
            g.update(cfb.launch_r2(s0, k, log_n))
        groups.append(g)
        del start
    s0, k = plan[0]
    groups[0]["no_src_ms"] = device_time(
        lambda: cfb.stage_group_r2(ref, tw, s0=s0, k=k, log_n=log_n,
                                   encode_in=True)) * 1e3
    del ref
    if check and want is not None and not torch.equal(out, want):
        raise SystemExit(f"2^{log_n}: {plan_name()} differs from the "
                         f"default plan")
    res = {"plan": plan_name(), "groups": groups,
           "chain_ms": device_time(chain, cfb.stage_group_r2, out, x, tw,
                                   log_n) * 1e3,
           "apply_ms": device_time(ntt.apply, x) * 1e3}
    return out, res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", nargs="*", default=[])
    ap.add_argument("--sizes", nargs="*", type=int, default=[24, 27])
    ap.add_argument("--time-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    usage = ptxas_usage(_build, "stage_group_r2")
    out = {"checkout": os.getcwd(), "card": smi, "ptxas": usage}
    defaults = {name: getattr(cfb, name) for plan in args.plans
                for name in settings(plan)}
    rng = np.random.default_rng(SEED)
    for log_n in args.sizes:
        ntt = NTTRadix2(137, 27, log_n, device=dev)
        x = to_torch(rng.integers(0, 1 << 32, 1 << log_n, dtype=np.uint32),
                     dev)
        check = not args.time_only
        default, res = run(ntt, x, log_n, check=check)
        out[f"2^{log_n} default"] = res
        print(f"[time] 2^{log_n} default: {json.dumps(res)}", flush=True)
        for plan in args.plans:
            for name, value in settings(plan).items():
                setattr(cfb, name, value)
            try:
                _, res = run(ntt, x, log_n, default, check)
            finally:
                for name, value in defaults.items():
                    setattr(cfb, name, value)
            out[f"2^{log_n} {plan}"] = res
            print(f"[time] 2^{log_n} {plan}: {json.dumps(res)}", flush=True)
        del default, x, ntt
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
