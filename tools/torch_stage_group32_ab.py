#!/usr/bin/env python3
"""Check and time the GF(2^32) NTT's stage-group chain on one GPU.

    python3 tools/torch_stage_group32_ab.py [--plans KB,KU ...] [--log-h N]

Run from the root of a checkout: it builds and times that checkout's
binius_ntt_tpu_torch, so two checkouts run in turns (parent, change,
change, parent) compare two versions on one card.  Prints ptxas's line for
every stage_group32_kernel entry (read with this script's own
``_build.kernel_usage``, so a parent checkout reports its kernel too).
Then at 2^24 (or 2^N), rates 0 and 2, on numpy-seeded random packed rows
on the device, under the package's default plan and then under each (KB, KU) of
--plans: every group held word for word to stage_group32_plain on the
input the chain gives it, then with CUDA events (median of 7) the whole
chain of stage_group32 launches, each group alone and AdditiveNTT(N,
r).apply from device words.  For the shared-memory design (a checkout
whose kernel has the <bool LOW> entries) it prints beside each group its
columns a block, blocks, threads, tile bytes, the blocks an SM holds and
the waves that makes.  Every plan's
output must equal the default plan's.  Prints one JSON object with the
card's name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from ab_common import card, ptxas_usage  # noqa: E402
from binius_ntt_tpu_torch import AdditiveNTT, _build  # noqa: E402
from binius_ntt_tpu_torch.ntt import cuda_fused32 as cf32  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_torch  # noqa: E402

SEED = 0x5632
W = 128
# the card's registers and shared memory an SM, and what the runtime
# reserves for each block
SM_REGS = 65536
SM_SMEM = 228 * 1024
SMEM_RESERVED = 1024
MAX_THREADS = 256


def registers(line: str) -> int | None:
    found = re.search(r"Used (\d+) registers", line)
    return int(found.group(1)) if found else None


def occupancy(k: int, low: bool, post: int, n_inst: int,
              regs: int | None, sms: int) -> dict:
    """Blocks, blocks an SM holds and waves, by the shared-memory design's
    launch rule (csrc/stage_group32.cu): an upper block 2^k * cols slots of
    128 bytes, the bottom block 4 * 2^k, 128 threads where two blocks'
    tiles fit an SM, else 256."""
    cols = 1 if low else cf32.group_cols32(k, post)
    blocks = n_inst * (post // cols) * (1 if low else 4)
    smem = cf32.tile_bytes32(k, low, cols)
    work = (2 << k) if low else (cols << (k - 1))
    cap = (MAX_THREADS // 2 if 2 * (smem + SMEM_RESERVED) <= SM_SMEM
           else MAX_THREADS)
    threads = min(work, cap)
    by_smem = SM_SMEM // (smem + SMEM_RESERVED)
    warps = -(-threads // 32)
    by_regs = (SM_REGS // (warps * 32 * (-(-regs // 8) * 8))
               if regs else by_smem)
    per_sm = max(min(by_smem, by_regs, 2048 // threads, 32), 0)
    return {"cols": cols, "blocks": blocks, "smem": smem,
            "threads": threads, "blocks_per_sm": per_sm,
            "waves": blocks / (sms * per_sm) if per_sm else None}


def groups_of(ntt, x, fn) -> None:
    cosets = 1 << ntt.log_rate
    for (t0, k, low, tabs) in ntt.tables:
        fn(x, tabs, t0=t0, k=k, include_low=low, cosets=cosets,
           log_nbr=ntt.log_h - 7)


def plan_name() -> str:
    return f"{cf32.KB},{cf32.KU}"


def run(log_h: int, log_rate: int, dev, data, regs, want=None) -> tuple:
    ntt = AdditiveNTT(log_h, log_rate, device=dev)
    cosets = 1 << log_rate
    x0 = data.repeat(cosets, 1).view(cosets, -1, W)
    x, groups = x0.clone(), []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (t0, k, low, tabs) in ntt.tables:
        kw = dict(t0=t0, k=k, include_low=low, cosets=cosets,
                  log_nbr=log_h - 7)
        want_g = cf32.stage_group32_plain(x.clone(), tabs, **kw)
        start = x.clone()
        cf32.stage_group32(x, tabs, **kw)
        torch.cuda.synchronize()
        if not torch.equal(x, want_g):
            raise SystemExit(f"rate {log_rate} plan {plan_name()}: "
                             f"group (t0={t0}, k={k}, low={low}) differs "
                             f"from stage_group32_plain")
        del want_g
        g = {"group": [t0, k, low],
             "ms": device_time(lambda s=start, t=tabs, kw=kw:
                               cf32.stage_group32(s, t, **kw)) * 1e3}
        if regs is not None:
            g.update(occupancy(k, low, 1 << t0,
                               cosets << (log_h - 7 - t0 - k),
                               regs.get(low), sms))
        groups.append(g)
        del start
    if want is not None and not torch.equal(x, want):
        raise SystemExit(f"rate {log_rate}: plan {plan_name()} "
                         f"differs from the default plan")
    out = {"plan": plan_name(), "groups": groups,
           "chain_ms": device_time(groups_of, ntt, x0.clone(),
                                   cf32.stage_group32) * 1e3}
    words = cf32.bitslice_lane_groups(data).reshape(-1)
    out["apply_ms"] = device_time(ntt.apply, words) * 1e3
    return x, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", nargs="*", default=[])
    ap.add_argument("--log-h", type=int, default=24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    usage = ptxas_usage(_build, "stage_group32_kernel")
    # the shared-memory design's two entries: <false> upper, <true> bottom
    regs = None
    if any("stage_group32_kernelILb" in n for n in usage):
        regs = {low: registers(line) for name, line in usage.items()
                for low in (False, True)
                if f"stage_group32_kernelILb{int(low)}E" in name}
    out = {"checkout": os.getcwd(), "card": smi, "ptxas": usage,
           "log_h": args.log_h}
    rng = np.random.default_rng(SEED)
    data = to_torch(rng.integers(0, 1 << 32, ((1 << args.log_h) // W, W),
                                 dtype=np.uint32), dev)
    default = {}
    for r in (0, 2):
        default[r], res = run(args.log_h, r, dev, data, regs)
        out[f"r{r} default {plan_name()}"] = res
        print(f"[time] r{r} default {plan_name()}: {json.dumps(res)}",
              flush=True)
    for plan in args.plans:
        cf32.KB, cf32.KU = (int(v) for v in plan.split(","))
        for r in (0, 2):
            _, res = run(args.log_h, r, dev, data, regs, default[r])
            out[f"r{r} plan {plan}"] = res
            print(f"[time] r{r} plan {plan}: {json.dumps(res)}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
