#!/usr/bin/env python3
"""The port's sharded paths over a real process group, one shard a rank,
and the sharded NTT128's cross-device stages timed with and without the
exchange split into halves.

    python3 -m torch.distributed.run --standalone --nproc_per_node=4 \\
        tools/torch_sharded_nccl.py [--log-h 24] [--rates 0 2]
        [--chunk-rows 262144]

Run from the root of a checkout.  Every rank sets up the default process
group through ``parallel.mesh.initialize_distributed`` (torchrun's
environment, or ``--init-method``, ``--world-size`` and ``--rank``; NCCL
where a GPU is present, each rank on ``cuda:LOCAL_RANK``, gloo on the CPU
otherwise) and a ``DistMesh`` through ``make_mesh()``.  It then:

  * runs ``entry.dryrun_multichip`` on the process group;
  * applies ``ShardedAdditiveNTT128(log_h, r)`` to the mt19937 input of
    seed 0xdeadbeef + log_h + r (the native oracle's words, bit-sliced
    chunk by chunk on the rank's device), and holds the gathered output
    word for word to the single-device ``AdditiveNTT128`` on the rank's
    own device, ``--chunk-rows`` rows at a time, and on rank 0 to the
    golden MD5 digest (tests/test_torch_golden_tail.py's merged table)
    where the table has one, untransposed and hashed chunk by chunk on the
    device, so that no rank holds a second output-sized buffer for it;
    the exchange count to OVERLAP_HALVES a cross-device stage.  At log_h
    28, rate 2 the output is 2^32 words (17.2 GB) on every rank;
  * on GPUs, records the device's peak memory over the checks, then
    times with CUDA events (median of 7, every rank in step, at every
    size):
    the sharded ``apply_shards``, the single-device ``apply_sliced`` on the
    same card, ``cross_stages`` with OVERLAP_HALVES = 2 (half 0 multiplied
    while half 1 is in flight) and 1 (one transfer, then one multiply) in
    turns 2, 1, 1, 2, and one exchange of a whole shard a cross-device
    stage alone.

Rank 0 prints every rank's times as one JSON object with the card's name
and power limit.  Off the GPU (``--log-h`` small) it runs the checks only.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.getcwd())

from ab_common import card  # noqa: E402
from binius_ntt_tpu_torch.entry import dryrun_multichip  # noqa: E402
from binius_ntt_tpu_torch.layout.bitslicing import (  # noqa: E402
    CHUNK_ROWS, bitslice_transpose_streamed)
from binius_ntt_tpu_torch.ntt.additive_bitsliced import (  # noqa: E402
    AdditiveNTT128)
from binius_ntt_tpu_torch.parallel import ntt128_sharded as ns  # noqa: E402
from binius_ntt_tpu_torch.parallel.mesh import (  # noqa: E402
    DistMesh, initialize_distributed, make_mesh, shutdown_distributed)
from binius_ntt_tpu_torch.utils import native_oracle  # noqa: E402
from binius_ntt_tpu_torch.utils.benchlib import (  # noqa: E402
    device_time, md5_untransposed)

SEED = 0xDEADBEEF
W = 128


def golden_table() -> dict:
    """The GF(2^128) digests: the oracle table and the port's own."""
    path = os.path.join(os.getcwd(), "tests", "test_torch_golden_tail.py")
    spec = importlib.util.spec_from_file_location("golden_tail", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ntt128_hashes()



def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def run_rate(mesh, log_h: int, r: int, golden: dict, timing: bool,
             chunk_rows: int = CHUNK_ROWS) -> dict:
    dev = mesh.device
    words = native_oracle.mt19937_fill(SEED + log_h + r, (1 << log_h) * 4)
    sliced = bitslice_transpose_streamed(words.reshape(-1, W), device=dev)
    del words
    sh = ns.ShardedAdditiveNTT128(log_h, r, mesh)
    single = AdditiveNTT128(log_h, r, device=dev)

    mesh.exchanges = 0
    out = sh.apply_sliced(sliced)
    exchanges = mesh.exchanges
    check(exchanges == sh.log_d * ns.OVERLAP_HALVES,
          f"{exchanges} exchanges, not {ns.OVERLAP_HALVES} a stage")
    ref = single.apply_sliced(sliced)
    for i in range(0, out.shape[0], chunk_rows):
        check(torch.equal(out[i:i + chunk_rows], ref[i:i + chunk_rows]),
              f"({log_h}, {r}) sharded != single-device in rows "
              f"[{i}, {i + chunk_rows})")
    del ref
    want = golden.get(r, {}).get(log_h)
    res = {"equal_to_single": True, "exchanges": exchanges,
           "golden": want is not None}
    if mesh.rank == 0:
        digest = md5_untransposed(out, chunk_rows)
        check(want in (None, digest), f"({log_h}, {r}) digest {digest} != "
              f"golden {want}")
        res["digest"] = digest
    del out
    if not timing:
        return res
    res["check_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    dist.barrier()                   # rank 0 has hashed; time in step

    xs = sh.shard_input(sliced)
    shard = xs[mesh.rank]

    def exchange_only():
        for s in range(sh.log_d):
            mesh.exchange({mesh.rank: [shard]}, 1 << s)

    saved = ns.OVERLAP_HALVES
    cross = {1: [], 2: []}
    try:
        for halves in (2, 1, 1, 2):
            ns.OVERLAP_HALVES = halves
            cross[halves].append(device_time(sh.cross_stages, xs) * 1e3)
    finally:
        ns.OVERLAP_HALVES = saved
    res.update(
        apply_shards_ms=device_time(
            lambda: sh.apply_shards(sh.shard_input(sliced))) * 1e3,
        shard_input_ms=device_time(sh.shard_input, sliced) * 1e3,
        single_apply_ms=device_time(single.apply_sliced, sliced) * 1e3,
        cross_halves2_ms=cross[2], cross_halves1_ms=cross[1],
        exchange_only_ms=device_time(exchange_only) * 1e3,
        shard_bytes=shard.numel() * shard.element_size())
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-h", type=int, default=24)
    ap.add_argument("--rates", type=int, nargs="+", default=[0, 2])
    ap.add_argument("--chunk-rows", type=int, default=CHUNK_ROWS,
                    help="rows a chunk of the comparison and the hash")
    ap.add_argument("--init-method", default=None,
                    help="the process group's init method (default "
                    "torchrun's environment)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args()

    check(initialize_distributed(args.init_method, args.world_size,
                                 args.rank),
          "no process group: run under torchrun")
    mesh = make_mesh()
    check(isinstance(mesh, DistMesh), "make_mesh() gave no DistMesh")
    timing = mesh.device.type == "cuda"
    dist.barrier()                   # every rank's communicator is up
    dryrun_multichip(mesh.size)
    golden = golden_table()
    results = {r: run_rate(mesh, args.log_h, r, golden, timing,
                           args.chunk_rows) for r in args.rates}
    gathered = [None] * mesh.size
    dist.all_gather_object(gathered, {"rank": mesh.rank,
                                      "device": str(mesh.device),
                                      "results": results})
    if mesh.rank == 0:
        print(json.dumps({"world": mesh.size,
                          "backend": dist.get_backend(),
                          "card": card() if timing else None,
                          "log_h": args.log_h, "ranks": gathered}))
    shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
