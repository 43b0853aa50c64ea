"""Entry points: a single-device forward step and a multi-shard dry run.

Port of the repository's ``__graft_entry__.py``.  ``entry()`` gives the
flagship transform as a callable and its example input; ``dryrun_multichip
(n)`` runs every sharded path of ``parallel/`` on an n-shard mesh and holds
each to its single-device counterpart.  The mesh is a LocalMesh of n
shards on ``device`` (default ``cuda:0``), or, where a process group is
initialised (``parallel.mesh.initialize_distributed``, e.g. under
``torchrun --nproc_per_node=n``), one shard a rank.
"""

from __future__ import annotations

import numpy as np

from .fields.m31 import P, qm31_add_host
from .layout.bitslicing import bitslice_transpose
from .ntt import cuda_fused as cf
from .ntt.additive import AdditiveNTT
from .ntt.additive_bitsliced import AdditiveNTT128
from .parallel.mesh import LocalMesh, initialize_distributed, make_mesh
from .parallel.ntt128_sharded import ShardedAdditiveNTT128
from .parallel.ntt_sharded import ShardedAdditiveNTT
from .parallel.prime_sharded import ShardedPrimeFieldSumcheck
from .parallel.sumcheck_sharded import ShardedSumcheck
from .sumcheck.prime_field import PrimeFieldSumcheck, interpolate_at_host
from .sumcheck.prover import INTS_PER_VALUE
from .sumcheck.verifier import evaluate_univariate_given_points, words_to_int
from .utils.bits import to_torch
from .utils.mt19937 import mt19937_stream

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, example_args): one 2^14-point GF(2^32) transform at rate 2, on
    the compact path, as the reference's entry gives it."""
    log_h, log_rate = 14, 2
    ntt = AdditiveNTT(log_h, log_rate, use_fused=False, device=device)
    x = to_torch(mt19937_stream(0xDEADBEEF + log_h + log_rate, 1 << log_h),
                 ntt.device)
    return ntt.apply, (x,)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Every sharded path on an n-shard mesh, each held to the single-device
    result; raises AssertionError at the first difference.

      * ShardedAdditiveNTT128 at (13, 1) on a forced multi-group local plan
        (KB = 3: a bottom and an upper group, their seam and every shard's
        twiddle correction), word-equal to the single-device transform;
      * ShardedAdditiveNTT (GF(2^32)) word-equal to AdditiveNTT;
      * ShardedSumcheck at num_vars 14, every round's claim checked by the
        verifier's interpolation;
      * ShardedPrimeFieldSumcheck (QM31), every round's claim checked;
      * a checkpoint after three rounds, resumed on a LocalMesh of half the
        size (one shard at n = 2) in every process, its messages equal to
        the uninterrupted run's.
    """
    initialize_distributed()        # nothing without a configuration
    mesh = make_mesh(n_devices, device)
    dev = mesh.device
    n_devices = mesh.size
    log_d = n_devices.bit_length() - 1
    _check(1 << log_d == n_devices, "the shard count is a power of two")

    log_h, log_rate = 13, 1
    words = mt19937_stream(9, (1 << log_h) * 4)
    sliced = bitslice_transpose(to_torch(words, dev).view(-1, 128))
    saved = cf.KB
    cf.KB = 3                   # local log_nb 8 - log_d: bottom + upper
    try:
        got = ShardedAdditiveNTT128(log_h, log_rate, mesh).apply_sliced(
            sliced)
    finally:
        cf.KB = saved
    want = AdditiveNTT128(log_h, log_rate, use_fused=False,
                          device=dev).apply_sliced(sliced)
    _check(bool((got == want).all()), "sharded NTT128 != single-device")

    x32 = mt19937_stream(1, 1 << (log_d + 2))
    got32 = ShardedAdditiveNTT(log_d + 2, 1, mesh).apply(x32)
    want32 = AdditiveNTT(log_d + 2, 1, device=dev).apply(x32)
    _check(bool((got32 == want32).all()), "sharded GF(2^32) NTT != "
           "single-device")

    num_vars, comp = 14, 2
    evals = mt19937_stream(2, INTS_PER_VALUE * (1 << num_vars) * comp)
    sc = ShardedSumcheck(evals, comp, num_vars, mesh)
    rng = np.random.default_rng(5)
    claim = None
    for _ in range(6):
        s, pts = sc.round_messages()
        if claim is not None:
            _check(words_to_int(s) == claim, "claim consistency failed")
        _check(words_to_int(s)
               == words_to_int(pts[0]) ^ words_to_int(pts[1]),
               "sum != p(0) + p(1)")
        ch = rng.integers(0, 2 ** 32, size=4, dtype=np.uint32)
        claim = evaluate_univariate_given_points(
            words_to_int(ch), [words_to_int(p) for p in pts], comp + 1)
        sc.move_to_next_round(ch)

    qn = 10
    qe = rng.integers(0, P, size=(2, 1 << qn, 4), dtype=np.uint32)
    pfs = ShardedPrimeFieldSumcheck(qe, mesh)
    single = PrimeFieldSumcheck(qe, device=dev)
    qclaim = None
    for _ in range(4):
        p = pfs.round_messages()
        _check(np.array_equal(p, single.round_messages()),
               "sharded QM31 round != single-device")
        if qclaim is not None:
            _check(np.array_equal(qm31_add_host(p[0], p[1]), qclaim),
                   "QM31 claim consistency failed")
        ch = rng.integers(0, P, size=4, dtype=np.uint32)
        qclaim = interpolate_at_host(ch, p)
        pfs.fold(ch)
        single.fold(ch)

    nv_ck = 12
    ck_evals = mt19937_stream(3, INTS_PER_VALUE * (1 << nv_ck) * comp)
    ck_chals = [np.random.default_rng(100 + i).integers(
        0, 2 ** 32, size=4, dtype=np.uint32) for i in range(6)]
    base = ShardedSumcheck(ck_evals, comp, nv_ck, mesh)
    ckpt, base_msgs = None, []
    for i, ch in enumerate(ck_chals):
        if i == 3:
            ckpt = base.state_dict()
        base_msgs.append(base.round_messages())
        base.move_to_next_round(ch)
    # the state is global, so every process resumes it on a mesh of its
    # own, also under a process group
    resumed = ShardedSumcheck.from_state_dict(
        ckpt, LocalMesh(max(n_devices // 2, 1), dev))
    _check(resumed.round == 3, "resumed at the wrong round")
    for i in range(3, len(ck_chals)):
        s, pts = resumed.round_messages()
        bs, bpts = base_msgs[i]
        _check(np.array_equal(s, bs) and np.array_equal(pts, bpts),
               "the resumed run diverged from the uninterrupted one")
        resumed.move_to_next_round(ck_chals[i])
