"""One rank of the port's gloo runs (tests/test_torch_distributed.py).

    python tests/_torch_distributed_child.py STORE WORLD_SIZE RANK OUT_JSON

Sets up a process group through ``initialize_distributed`` with a
``file://`` store, runs the sharded NTT128 at (10, 1) on a forced
multi-group local plan, the GF(2^128) sumcheck at num_vars 10 and the QM31
sumcheck at num_vars 7 on the CPU, one shard a rank, and writes the
outputs, the transcripts and the mesh's counters to OUT_JSON.  It also runs
the NTT's cross-device stages once more with their transfers, waits and
multiplies logged in order, to show each half multiplied while the next
half is in flight.  Imports no JAX.
"""

import hashlib
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from binius_ntt_tpu_torch.layout.bitslicing import (  # noqa: E402
    bitslice_transpose)
from binius_ntt_tpu_torch.ntt import cuda_fused as cf  # noqa: E402
from binius_ntt_tpu_torch.parallel import mesh as pm  # noqa: E402
from binius_ntt_tpu_torch.parallel import ntt128_sharded as ns  # noqa: E402
from binius_ntt_tpu_torch.parallel.mesh import (  # noqa: E402
    DistMesh, initialize_distributed, make_mesh, shutdown_distributed)
from binius_ntt_tpu_torch.parallel.ntt128_sharded import (  # noqa: E402
    ShardedAdditiveNTT128)
from binius_ntt_tpu_torch.parallel.prime_sharded import (  # noqa: E402
    ShardedPrimeFieldSumcheck)
from binius_ntt_tpu_torch.parallel.sumcheck_sharded import (  # noqa: E402
    ShardedSumcheck)
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch  # noqa: E402
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream  # noqa: E402

LOG_H, LOG_RATE = 10, 1
NV, COMP = 10, 2
QNV, QSEED = 7, 51
P = (1 << 31) - 1


def logged_cross_stages(ntt, xs) -> list:
    """Run ``ntt.cross_stages`` on xs with every transfer batch issued
    ("issue"), every half waited for ("wait") and every product ("mul")
    logged in order; a "mul" also logs how many issued halves are not yet
    waited for."""
    events, open_ = [], [0]
    batch, wait, mul = (dist.batch_isend_irecv, pm._Arrived.wait,
                        ns.ck.mul_tiles)

    def logged_batch(ops):
        events.append("issue")
        open_[0] += 1
        return batch(ops)

    def logged_wait(self):
        events.append("wait")
        open_[0] -= 1
        return wait(self)

    def logged_mul(a, b):
        events.append(f"mul, {open_[0]} in flight")
        return mul(a, b)

    dist.batch_isend_irecv = logged_batch
    pm._Arrived.wait = logged_wait
    ns.ck.mul_tiles = logged_mul
    try:
        ntt.cross_stages(xs)
    finally:
        dist.batch_isend_irecv, pm._Arrived.wait, ns.ck.mul_tiles = (
            batch, wait, mul)
    return events


def main() -> None:
    store, world, rank, out_path = sys.argv[1:5]
    assert initialize_distributed(f"file://{store}", int(world), int(rank),
                                  backend="gloo")
    mesh = make_mesh()
    assert isinstance(mesh, DistMesh) and mesh.shards == (int(rank),)

    cf.KB, cf.KU, cf.PT = 2, 2, 2              # a multi-group local plan
    words = mt19937_stream(0xBEEF + LOG_H, (1 << LOG_H) * 4)
    sliced = bitslice_transpose(to_torch(words).view(-1, 128))
    ntt = ShardedAdditiveNTT128(LOG_H, LOG_RATE, mesh)
    shards = ntt.apply_shards(ntt.shard_input(sliced))
    ntt_counts = {"exchanges": mesh.exchanges,
                  "exchange_bytes": mesh.exchange_bytes,
                  "all_gathers": mesh.all_gathers}
    out = to_numpy(ntt.gather_output(shards))
    ntt_md5 = hashlib.md5(out.astype("<u4").tobytes()).hexdigest()
    overlap_events = logged_cross_stages(ntt, ntt.shard_input(sliced))

    n_ints = 4 * (1 << NV) * COMP
    vals = mt19937_stream(999, n_ints + 4 * NV)
    evals, chals = vals[:n_ints], vals[n_ints:].reshape(NV, 4)
    sc = ShardedSumcheck(evals, COMP, NV, mesh)
    gathers0 = mesh.all_gathers
    messages = []
    for rnd in range(NV + 1):
        total, pts = sc.round_messages()
        messages.append([total.tolist(), pts.tolist()])
        if rnd < NV:
            sc.move_to_next_round(chals[rnd])
    sumcheck_gathers = mesh.all_gathers - gathers0

    rng = np.random.default_rng(QSEED)
    qe = rng.integers(0, P, size=(2, 1 << QNV, 4), dtype=np.uint32)
    qch = rng.integers(0, P, size=(QNV, 4), dtype=np.uint32)
    pf = ShardedPrimeFieldSumcheck(qe, mesh)
    qmessages = []
    for r in range(QNV):
        qmessages.append(pf.round_messages().tolist())
        pf.fold(qch[r])

    pathlib.Path(out_path).write_text(json.dumps({
        "rank": mesh.rank, "size": mesh.size, "ntt_md5": ntt_md5,
        "ntt_counts": ntt_counts, "overlap_events": overlap_events,
        "sumcheck": messages,
        "sumcheck_all_gathers": sumcheck_gathers,
        "qm31": qmessages, "jax_loaded": "jax" in sys.modules}))
    shutdown_distributed()


if __name__ == "__main__":
    main()
