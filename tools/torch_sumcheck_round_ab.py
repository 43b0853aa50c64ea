#!/usr/bin/env python3
"""Check and time the GF(2^128) sumcheck round and fold kernels on one GPU.

    python3 tools/torch_sumcheck_round_ab.py

Run from the root of a checkout: it builds and times that checkout's
binius_ntt_tpu_torch, so two checkouts run in turns (parent, change,
change, parent) compare two versions on one card.  For C = 2, 3, 4 it holds
``round_kernel`` word for word to ``round_plain`` at num_vars 12 (every
live row count b .. 2, two counts whose half is not a multiple of 32, then
the in-word rounds at lanes 32 .. 1) and on the timed input, 2^24
evaluations of numpy-seeded random words; it holds ``fold_kernel`` to
``fold_plain`` on clones of the same inputs at the same shapes (in-word
lanes 32 .. 2).  Then it times the first round there with CUDA events
(median of 7), the fold beside it, and the first in-word round (rows = 1,
lanes = 32) on the same input.  Prints ptxas's figures for
sumcheck_round_kernel and both sumcheck_fold_kernel instantiations (read
with this script's own ``_build.kernel_usage``, so a parent checkout
reports them too) and one JSON object with the card's name and power
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
from binius_ntt_tpu_torch import _build  # noqa: E402
from binius_ntt_tpu_torch.sumcheck import cuda_round as cr  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import device_time  # noqa: E402
from binius_ntt_tpu_torch.utils.bits import to_torch  # noqa: E402

COMPS = (2, 3, 4)
SEED = 0x5C0024
LOG_N = 24


def words(rng, shape, dev) -> torch.Tensor:
    return to_torch(rng.integers(0, 1 << 32, shape, dtype=np.uint32), dev)


def check_fold(x, challenge, rows: int, lanes: int = 32) -> None:
    got = cr.fold_kernel(x.clone(), challenge, rows, lanes)
    if not torch.equal(got, cr.fold_plain(x.clone(), challenge, rows,
                                          lanes)):
        raise SystemExit(f"C={x.shape[0]}: fold_kernel differs from "
                         f"fold_plain at B={x.shape[1]}, rows={rows}, "
                         f"lanes={lanes}")


def check_small(dev, comp: int, rng, num_vars: int = 12) -> int:
    """round_kernel == round_plain and fold_kernel == fold_plain at every
    round's shape; returns the number of shapes held."""
    b = (1 << num_vars) // 32
    x = words(rng, (comp, b, 128), dev)
    challenge = rng.integers(0, 1 << 32, 4, dtype=np.uint32)
    live = [(b >> k, 32) for k in range(b.bit_length() - 1)]
    live += [(70, 32), (b - 2, 32)]           # idle lanes in the last warp
    live += [(1, 32 >> k) for k in range(6)]
    for rows, lanes in live:
        got = cr.round_kernel(x, rows, comp + 1, lanes)
        if not torch.equal(got, cr.round_plain(x, rows, comp + 1, lanes)):
            raise SystemExit(f"C={comp}: round_kernel differs from "
                             f"round_plain at num_vars {num_vars}, "
                             f"rows={rows}, lanes={lanes}")
        if lanes >= 2:                        # a fold leaves 2 lanes or more
            check_fold(x, challenge, rows, lanes)
    return len(live)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    usage = ptxas_usage(_build, "sumcheck_(?:round|fold)_kernel")
    out = {"checkout": os.getcwd(), "card": smi, "ptxas": usage}
    rng = np.random.default_rng(SEED)
    b = (1 << LOG_N) // 32
    big = words(rng, (max(COMPS), b, 128), dev)
    challenge = rng.integers(0, 1 << 32, 4, dtype=np.uint32)
    for comp in COMPS:
        shapes = check_small(dev, comp, rng)
        x = big[:comp].clone()
        if not torch.equal(cr.round_kernel(x, b, comp + 1),
                           cr.round_plain(x, b, comp + 1)):
            raise SystemExit(f"C={comp}: round_kernel differs from "
                             f"round_plain at 2^{LOG_N}")
        check_fold(x, challenge, b)
        out[f"C={comp}"] = {
            "held_shapes": shapes + 1,
            "round_ms": device_time(cr.round_kernel, x, b, comp + 1) * 1e3,
            # the fold works in place: each call folds the same rows again
            "fold_ms": device_time(cr.fold_kernel, x, challenge, b) * 1e3,
            "in_word_ms": device_time(cr.round_kernel, x, 1, comp + 1,
                                      32) * 1e3}
        print(f"[time] C={comp}: {out[f'C={comp}']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
