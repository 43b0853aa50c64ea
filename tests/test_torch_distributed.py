"""Real process groups for the port's sharded paths: 2 and 4 gloo ranks,
each a child process on the CPU (tests/_torch_distributed_child.py), held
to the JAX package's single-device results, which this process computes,
and the order of the sharded NTT's transfers and multiplies: each half's
product runs while the next half is still in flight.

The ranks meet through a ``file://`` store under the test's own temporary
directory, so parallel test workers cannot collide, and every child is
waited for at most CHILD_TIMEOUT seconds: a hung rank kills all of them
and fails the test.  No process group is set up in this process.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from binius_ntt_tpu.fields.m31 import P
from binius_ntt_tpu.layout.bitslicing import bitslice_transpose
from binius_ntt_tpu.ntt.additive_bitsliced import AdditiveNTT128
from binius_ntt_tpu.sumcheck.prime_field import PrimeFieldSumcheck
from binius_ntt_tpu.sumcheck.prover import Sumcheck
from binius_ntt_tpu.utils.mt19937 import mt19937_stream

REPO = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "_torch_distributed_child.py"
CHILD_TIMEOUT = 120
LOG_H, LOG_RATE = 10, 1       # must match _torch_distributed_child.py
NV, COMP = 10, 2
QNV, QSEED = 7, 51


def _reference():
    words = mt19937_stream(0xBEEF + LOG_H, (1 << LOG_H) * 4)
    sliced = bitslice_transpose(jnp.asarray(words.reshape(-1, 128)))
    out = np.asarray(AdditiveNTT128(LOG_H, LOG_RATE, use_pallas=False)
                     .apply_sliced(sliced))
    ntt_md5 = hashlib.md5(out.astype("<u4").tobytes()).hexdigest()

    n_ints = 4 * (1 << NV) * COMP
    vals = mt19937_stream(999, n_ints + 4 * NV)
    evals, chals = vals[:n_ints], vals[n_ints:].reshape(NV, 4)
    ref = Sumcheck(evals, COMP, NV)
    messages = []
    for rnd in range(NV + 1):
        total, pts = ref.round_messages()
        messages.append([np.asarray(total).tolist(),
                         np.asarray(pts).tolist()])
        if rnd < NV:
            ref.move_to_next_round(chals[rnd])

    rng = np.random.default_rng(QSEED)
    qe = rng.integers(0, P, size=(2, 1 << QNV, 4), dtype=np.uint32)
    qch = rng.integers(0, P, size=(QNV, 4), dtype=np.uint32)
    pf = PrimeFieldSumcheck(qe)
    qmessages = []
    for r in range(QNV):
        qmessages.append(np.asarray(pf.round_messages()).tolist())
        pf.fold(qch[r])
    return ntt_md5, messages, qmessages


def _run_ranks(tmp_path: Path, world: int) -> list:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), str(store), str(world), str(r),
         str(outs[r])], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    fail = []
    try:
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=CHILD_TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of {world} did not finish in "
                            f"{CHILD_TIMEOUT} s")
            if p.returncode != 0:
                fail.append(f"rank {r} rc={p.returncode}:\n"
                            f"{log.decode(errors='replace')[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not fail, "\n".join(fail)
    return [json.loads(o.read_text()) for o in outs]


@pytest.fixture(scope="module", params=[2, 4], ids=str)
def ranks(request, tmp_path_factory):
    """(world, every rank's results) of one gloo run of ``world`` ranks."""
    world = request.param
    return world, _run_ranks(tmp_path_factory.mktemp(f"gloo{world}"), world)


def test_gloo_ranks_match_reference(ranks):
    world, results = ranks
    ntt_md5, messages, qmessages = _reference()
    log_d = world.bit_length() - 1
    shard_bytes = (1 << LOG_RATE) * ((1 << LOG_H) // 32 // world) * 128 * 4
    assert sorted(r["rank"] for r in results) == list(range(world))
    for r in results:
        assert r["size"] == world and not r["jax_loaded"]
        assert r["ntt_md5"] == ntt_md5
        assert r["ntt_counts"] == {"exchanges": 2 * log_d,
                                   "exchange_bytes": log_d * shard_bytes,
                                   "all_gathers": 0}
        assert r["sumcheck"] == messages
        assert r["qm31"] == qmessages
        # one all_gather a sharded round (until one row a rank is left),
        # one more for the tail handoff
        local_rows = (1 << NV) // 32 // world
        assert r["sumcheck_all_gathers"] == local_rows.bit_length()


def test_gloo_exchange_overlaps_the_multiply(ranks):
    """Every cross-device stage issues both halves' transfers before the
    first multiply, and waits for each half just before its own multiply:
    half 0 is multiplied with half 1 still in flight."""
    world, results = ranks
    log_d = world.bit_length() - 1
    stage = ["issue", "issue", "wait", "mul, 1 in flight", "wait",
             "mul, 0 in flight"]
    for r in results:
        assert r["overlap_events"] == stage * log_d
