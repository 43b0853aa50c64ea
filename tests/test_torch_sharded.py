"""The port's sharded paths (binius_ntt_tpu_torch/parallel/) on LocalMesh
D = 2, 4, 8 on the CPU, vs the JAX package.

The JAX side runs as tests/test_sharded.py runs it: the single-device
classes, and the sharded ones on the virtual 8-device CPU mesh.  Every
comparison is exact word equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.fields.m31 import P
from binius_ntt_tpu.layout.bitslicing import bitslice_transpose
from binius_ntt_tpu.ntt import pallas_fused as pf
from binius_ntt_tpu.ntt.additive import AdditiveNTT as JaxNTT
from binius_ntt_tpu.ntt.additive_bitsliced import AdditiveNTT128 as JaxNTT128
from binius_ntt_tpu.parallel import mesh as jax_mesh
from binius_ntt_tpu.parallel.ntt128_sharded import (
    ShardedAdditiveNTT128 as JaxShardedNTT128)
from binius_ntt_tpu.parallel.prime_sharded import (
    ShardedPrimeFieldSumcheck as JaxShardedPrime)
from binius_ntt_tpu.parallel.sumcheck_sharded import (
    ShardedSumcheck as JaxShardedSumcheck)
from binius_ntt_tpu.sumcheck.prime_field import (
    PrimeFieldSumcheck as JaxPrime)
from binius_ntt_tpu.sumcheck.prover import Sumcheck as JaxSumcheck
from binius_ntt_tpu.utils.mt19937 import mt19937_stream
from binius_ntt_tpu_torch.convert import (
    sharded_prime_sumcheck_state_from_jax, sharded_sumcheck_state_from_jax)
from binius_ntt_tpu_torch.entry import dryrun_multichip, entry
from binius_ntt_tpu_torch.ntt import cuda_fused as cf
from binius_ntt_tpu_torch.parallel.mesh import LocalMesh, make_mesh
from binius_ntt_tpu_torch.parallel.ntt128_sharded import (
    OVERLAP_HALVES, ShardedAdditiveNTT128)
from binius_ntt_tpu_torch.parallel.ntt_sharded import ShardedAdditiveNTT
from binius_ntt_tpu_torch.parallel.prime_sharded import (
    ShardedPrimeFieldSumcheck)
from binius_ntt_tpu_torch.parallel.sumcheck_sharded import ShardedSumcheck
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch

needs_mesh = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

DEVICES = [2, 4, 8]
NV, COMP = 10, 2
QNV = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the torch side.  Parallel test workers share
    the machine's cores, and torch's default threads in several workers at
    once oversubscribe them: six concurrent runs of the (14, 2) transforms
    took over 900 s at 8 threads each and 22 s at one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return make_mesh(n, "cpu")


def _plan(monkeypatch, forced):
    if forced:
        for mod in (pf, cf):
            monkeypatch.setattr(mod, "KB", 2)
            monkeypatch.setattr(mod, "KU", 2)
            monkeypatch.setattr(mod, "PT", 2)


@functools.lru_cache(maxsize=None)
def _ntt128_case(log_h, log_rate):
    """(bit-sliced input, the JAX single-device output), numpy."""
    words = mt19937_stream(0xBEEF + log_h, (1 << log_h) * 4)
    sliced = np.asarray(bitslice_transpose(jnp.asarray(words.reshape(-1,
                                                                     128))))
    ref = np.asarray(JaxNTT128(log_h, log_rate, use_pallas=False)
                     .apply_sliced(jnp.asarray(sliced)))
    return sliced, ref


@pytest.mark.parametrize("n_dev", DEVICES)
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("log_h,log_rate,forced", [
    (9, 0, False), (10, 1, False), (13, 0, True), (14, 2, True)])
def test_sharded_ntt128_matches_reference(log_h, log_rate, forced, fused,
                                          n_dev, monkeypatch):
    _plan(monkeypatch, forced)
    sliced, ref = _ntt128_case(log_h, log_rate)
    ntt = ShardedAdditiveNTT128(log_h, log_rate, _mesh(n_dev),
                                use_fused=fused)
    got = to_numpy(ntt.apply_sliced(to_torch(sliced)))
    assert np.array_equal(got, ref)


@needs_mesh
@pytest.mark.parametrize("n_dev", DEVICES)
def test_sharded_ntt128_matches_jax_sharded(n_dev):
    sliced, ref = _ntt128_case(10, 1)
    jax_out = np.asarray(JaxShardedNTT128(
        10, 1, jax_mesh.make_mesh(n_dev)).apply_sliced(sliced))
    got = to_numpy(ShardedAdditiveNTT128(10, 1, _mesh(n_dev))
                   .apply_sliced(to_torch(sliced)))
    assert np.array_equal(got, jax_out) and np.array_equal(got, ref)


def test_sharded_ntt128_uses_each_shards_dplanes():
    """Without its correction every shard but 0 computes the wrong words."""
    sliced, ref = _ntt128_case(10, 1)
    ntt = ShardedAdditiveNTT128(10, 1, _mesh(4))
    ntt.dplanes = {d: tuple(p * 0 for p in planes)
                   for d, planes in ntt.dplanes.items()}
    got = to_numpy(ntt.apply_sliced(to_torch(sliced)))
    assert not np.array_equal(got, ref)


def test_sharded_ntt128_rejects_too_many_shards():
    with pytest.raises(ValueError, match="2 batches a shard"):
        ShardedAdditiveNTT128(9, 0, _mesh(16))


@pytest.mark.parametrize("n_dev", DEVICES)
@pytest.mark.parametrize("log_h,log_rate", [(8, 0), (8, 2), (4, 1)])
def test_sharded_ntt_matches_reference(log_h, log_rate, n_dev):
    inp = mt19937_stream(0xDEADBEEF + log_h + log_rate, 1 << log_h)
    ref = np.asarray(JaxNTT(log_h, log_rate).apply(inp))
    got = to_numpy(ShardedAdditiveNTT(log_h, log_rate, _mesh(n_dev))
                   .apply(inp))
    assert np.array_equal(got, ref)


def _sumcheck_inputs(seed):
    n_ints = 4 * (1 << NV) * COMP
    vals = mt19937_stream(seed, n_ints + 4 * NV)
    return vals[:n_ints], vals[n_ints:].reshape(NV, 4)


@functools.lru_cache(maxsize=None)
def _jax_sumcheck_messages(seed):
    evals, chals = _sumcheck_inputs(seed)
    a = JaxSumcheck(evals.copy(), COMP, NV)
    out = []
    for rnd in range(NV):
        out.append(tuple(np.asarray(m) for m in a.round_messages()))
        a.move_to_next_round(chals[rnd])
    out.append(tuple(np.asarray(m) for m in a.round_messages()))
    return out


@pytest.mark.parametrize("n_dev", DEVICES)
def test_sharded_sumcheck_matches_reference(n_dev):
    evals, chals = _sumcheck_inputs(123)
    want = _jax_sumcheck_messages(123)
    b = ShardedSumcheck(evals.copy(), COMP, NV, _mesh(n_dev))
    for rnd in range(NV + 1):
        s, pts = b.round_messages()
        assert np.array_equal(s, want[rnd][0]), f"round {rnd}"
        assert np.array_equal(pts, want[rnd][1]), f"round {rnd}"
        if rnd < NV:
            b.move_to_next_round(chals[rnd])


def _prime_inputs(seed):
    rng = np.random.default_rng(seed)
    evals = rng.integers(0, P, size=(2, 1 << QNV, 4), dtype=np.uint32)
    return evals, rng.integers(0, P, size=(QNV, 4), dtype=np.uint32)


@pytest.mark.parametrize("n_dev", DEVICES)
def test_sharded_prime_sumcheck_matches_reference(n_dev):
    evals, chals = _prime_inputs(51)
    a = JaxPrime(evals)
    b = ShardedPrimeFieldSumcheck(evals, _mesh(n_dev))
    for r in range(QNV):
        assert np.array_equal(np.asarray(a.round_messages()),
                              b.round_messages()), f"round {r}"
        a.fold(chals[r])
        b.fold(chals[r])


def _sharded_arrays_equal(port: dict, ref: dict) -> bool:
    """The evals arrays (or the tail's) of two sharded state dicts."""
    if (port["evals"] is None) != (ref["evals"] is None):
        return False
    if port["evals"] is not None:
        return np.array_equal(port["evals"], np.asarray(ref["evals"]))
    pt, rt = port["tail"], ref["tail"]
    arrays = [k for k in pt if k != "round" and k in rt
              and (pt[k] is not None or rt[k] is not None)]
    return bool(arrays) and all(
        pt[k] is not None and rt[k] is not None
        and np.array_equal(pt[k], np.asarray(rt[k])) for k in arrays)


@needs_mesh
@pytest.mark.parametrize("snap_round,resume_devices", [
    (1, 8),    # live sharded state, same mesh size
    (2, 4),    # live sharded state, a smaller mesh
    (4, 8),    # after the single-device tail handoff
])
def test_sharded_sumcheck_checkpoint_resume(snap_round, resume_devices):
    evals, chals = _sumcheck_inputs(321)
    want = _jax_sumcheck_messages(321)
    b = ShardedSumcheck(evals.copy(), COMP, NV, _mesh(8))
    j = JaxShardedSumcheck(evals.copy(), COMP, NV, jax_mesh.make_mesh(8))
    for rnd in range(snap_round):
        b.round_messages()
        b.move_to_next_round(chals[rnd])
        j.round_messages()
        j.move_to_next_round(chals[rnd])
    state, jstate = b.state_dict(), j.state_dict()
    assert state["round"] == jstate["round"] == snap_round
    assert _sharded_arrays_equal(state, jstate)
    # resume the port's own state, and the JAX package's
    for d in (state, sharded_sumcheck_state_from_jax(jstate)):
        c = ShardedSumcheck.from_state_dict(d, _mesh(resume_devices))
        assert c.round == snap_round
        for rnd in range(snap_round, NV + 1):
            s, pts = c.round_messages()
            assert np.array_equal(s, want[rnd][0]), f"round {rnd}"
            assert np.array_equal(pts, want[rnd][1]), f"round {rnd}"
            if rnd < NV:
                c.move_to_next_round(chals[rnd])


@needs_mesh
@pytest.mark.parametrize("snap_round,resume_devices", [
    (2, 8), (3, 4), (5, 8)])
def test_sharded_prime_checkpoint_resume(snap_round, resume_devices):
    evals, chals = _prime_inputs(83)
    ref = JaxPrime(evals)
    b = ShardedPrimeFieldSumcheck(evals, _mesh(8))
    j = JaxShardedPrime(evals, jax_mesh.make_mesh(8))
    for r in range(snap_round):
        for p in (ref, b, j):
            p.round_messages()
            p.fold(chals[r])
    state, jstate = b.state_dict(), j.state_dict()
    assert _sharded_arrays_equal(state, jstate)
    for d in (state, sharded_prime_sumcheck_state_from_jax(jstate)):
        c = ShardedPrimeFieldSumcheck.from_state_dict(d,
                                                      _mesh(resume_devices))
        assert c.round == snap_round
        a = JaxPrime.from_state_dict(ref.state_dict())
        for r in range(snap_round, QNV):
            assert np.array_equal(np.asarray(a.round_messages()),
                                  c.round_messages()), f"round {r}"
            a.fold(chals[r])
            c.fold(chals[r])


@pytest.mark.parametrize("n_dev", DEVICES)
def test_ntt128_exchange_schedule(n_dev):
    """log_d stages, each one exchange of every shard's OVERLAP_HALVES
    halves (tests/test_comm_volume.py); no all_gather inside the
    transform."""
    mesh = _mesh(n_dev)
    ntt = ShardedAdditiveNTT128(12, 1, mesh)
    sliced, _ = _ntt128_case(12, 1)
    xs = ntt.shard_input(to_torch(sliced))
    shard_bytes = xs[0].numel() * 4
    ntt.apply_shards(xs)
    assert mesh.exchanges == ntt.log_d * OVERLAP_HALVES * n_dev
    # the halves together are the shard: one shard a stage, a shard
    assert mesh.exchange_bytes == ntt.log_d * shard_bytes * n_dev
    assert mesh.all_gathers == 0


@pytest.mark.parametrize("n_dev", DEVICES)
def test_sumcheck_collective_schedule(n_dev):
    """One all_gather a sharded round, none in a fold before the tail
    handoff, no exchange."""
    mesh = _mesh(n_dev)
    evals, chals = _sumcheck_inputs(7)
    s = ShardedSumcheck(evals, COMP, NV, mesh)
    s.round_messages()
    assert mesh.all_gathers == 1
    s.move_to_next_round(chals[0])
    assert mesh.all_gathers == 1 and mesh.exchanges == 0
    q = ShardedPrimeFieldSumcheck(_prime_inputs(9)[0], mesh)
    q.round_messages()
    q.fold(chals[0] % P)
    assert mesh.all_gathers == 2 and mesh.exchanges == 0


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_dryrun_multichip(n_dev):
    dryrun_multichip(n_dev, "cpu")


def test_entry_matches_reference_entry():
    fn, (x,) = entry("cpu")
    ref = JaxNTT(14, 2, use_fused=False).apply(to_numpy(x))
    assert np.array_equal(to_numpy(fn(x)), np.asarray(ref))


def test_local_mesh_operations():
    mesh = LocalMesh(4, "cpu")
    parts = {d: [torch.full((2,), d)] for d in range(4)}
    got = mesh.exchange(parts, 2)
    assert [int(got[d][0][0]) for d in range(4)] == [2, 3, 0, 1]
    assert [int(t[0]) for t in mesh.all_gather({d: parts[d][0]
                                                for d in range(4)})] \
        == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="power of two"):
        LocalMesh(3, "cpu")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("log_h,log_rate,n_dev", [(10, 1, 4), (9, 0, 8),
                                                  (13, 2, 2)])
def test_sharded_ntt128_hands_mul_tiles_what_the_kernel_takes(
        log_h, log_rate, n_dev, fused, monkeypatch):
    """On the card mul_tiles takes only contiguous (N, 128) int32 rows of
    one shape; on the CPU it runs its plain version without the checks.
    Hold every operand of the sharded path to the card's checks here."""
    from binius_ntt_tpu_torch.ntt import cuda_kernels as ck

    calls = []

    def checked(a, b):
        for t in (a, b):
            assert t.dtype == torch.int32 and t.dim() == 2
            assert t.shape[1] == 128 and t.is_contiguous()
        assert a.shape == b.shape
        calls.append(a.shape[0])
        return ck.mul_tiles_plain(a, b)

    monkeypatch.setattr(ck, "mul_tiles", checked)
    sliced, ref = _ntt128_case(log_h, log_rate)
    ntt = ShardedAdditiveNTT128(log_h, log_rate, _mesh(n_dev),
                                use_fused=fused)
    assert np.array_equal(to_numpy(ntt.apply_sliced(to_torch(sliced))), ref)
    assert calls
