"""The port's batched GF(2^128) transform: ``AdditiveNTT128.apply_sliced``
on (B, nb, 128), B independent bit-sliced columns, held word for word to
the same method on each column alone and to the benchmark's plain batched
reference (portbench/reference/ntt128_batch.py), on the fused path and
the per-stage one; its refusals; and on the card, the kernel against the
plain version with one launch a stage group for the whole batch.  The file
imports no JAX."""

import functools

import pytest
import torch

from binius_ntt_tpu_torch import AdditiveNTT128
from binius_ntt_tpu_torch.ntt import cuda_fused
from portbench.reference.ntt128_batch import ntt_sliced_batch


@functools.lru_cache(maxsize=None)
def _ntt(log_h, log_rate, use_fused=None, device="cpu"):
    return AdditiveNTT128(log_h, log_rate, use_fused=use_fused,
                          device=device)


def _columns(b, log_h, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (b, (1 << log_h) // 32, 128),
                         dtype=torch.int32, device=device, generator=g)


def _check_batch(ntt, x):
    before = x.clone()
    out = ntt.apply_sliced(x)
    assert torch.equal(x, before)
    b, nb = x.shape[:2]
    assert out.shape == (b, nb << ntt.log_rate, 128) and out.is_contiguous()
    for i in range(b):
        assert torch.equal(out[i], ntt.apply_sliced(x[i]))
    assert torch.equal(out, ntt_sliced_batch(x, ntt.log_h, ntt.log_rate))
    return out


@pytest.mark.parametrize("log_rate", [0, 1, 2])
@pytest.mark.parametrize("log_h", [6, 8, 10])
@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_batch_equals_each_column_and_the_reference(b, log_h, log_rate):
    ntt = _ntt(log_h, log_rate)
    assert ntt.use_fused
    _check_batch(ntt, _columns(b, log_h, 1000 * b + 10 * log_h + log_rate))


@pytest.mark.parametrize("log_h,log_rate,use_fused", [
    (5, 0, None), (5, 2, None), (7, 1, False)])
@pytest.mark.parametrize("b", [1, 3])
def test_per_stage_batch(b, log_h, log_rate, use_fused):
    ntt = _ntt(log_h, log_rate, use_fused)
    assert not ntt.use_fused
    _check_batch(ntt, _columns(b, log_h, 7 * b + log_h))


def test_batch_refuses_what_it_does_not_take():
    ntt = _ntt(6, 1)
    nb = 2
    bad = [torch.zeros(2, nb + 1, 128, dtype=torch.int32),
           torch.zeros(0, nb, 128, dtype=torch.int32),
           torch.zeros(1, 2, nb, 128, dtype=torch.int32),
           torch.zeros(nb * 128, dtype=torch.int32),
           torch.zeros(2, nb, 64, dtype=torch.int32),
           torch.zeros(2, nb, 128, dtype=torch.int64),
           torch.zeros(2, nb, 128, dtype=torch.int32, device="meta")]
    for x in bad:
        with pytest.raises(ValueError, match="apply_sliced"):
            ntt.apply_sliced(x)


def test_a_strided_batch_is_taken_and_left_unchanged():
    """A batch that is a view of every other column of a larger tensor."""
    ntt = _ntt(7, 2)
    big = _columns(6, 7, 99)
    x = big[::2]
    assert not x.is_contiguous()
    before = big.clone()
    out = ntt.apply_sliced(x)
    assert torch.equal(big, before)
    assert torch.equal(out, ntt.apply_sliced(x.contiguous()))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("log_h,log_rate,plain", [
    (16, 0, True), (16, 2, True), (24, 0, False)])
def test_batch_on_card_one_launch_a_group(dev, log_h, log_rate, plain):
    """B = 4 on the card: each column equal to its own call (and at 2^16
    to the plain version on the CPU), with one launch a stage group for
    the batch, as for one column."""
    ntt = _ntt(log_h, log_rate, None, dev)
    x = _columns(4, log_h, 2 ** 31 + log_h, dev)
    before = cuda_fused.stage_group.launches
    out = ntt.apply_sliced(x)
    torch.cuda.synchronize(dev)
    batch_launches = cuda_fused.stage_group.launches - before
    before = cuda_fused.stage_group.launches
    one = ntt.apply_sliced(x[0])
    torch.cuda.synchronize(dev)
    assert cuda_fused.stage_group.launches - before == batch_launches \
        == len(ntt.tables)
    assert torch.equal(out[0], one)
    del one
    for i in range(1, 4):
        assert torch.equal(out[i], ntt.apply_sliced(x[i]))
    if plain:
        cpu = _ntt(log_h, log_rate).apply_sliced(x.cpu())
        assert torch.equal(out.cpu(), cpu)
