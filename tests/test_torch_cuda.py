"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an sm_90 GPU and nvcc; it is marked ``cuda`` and skips
elsewhere.  The file imports no JAX, so it also runs on a machine with only
PyTorch, where it is run without the JAX-configuring conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import hashlib

import numpy as np
import pytest
import torch

from golden_hashes_oracle import ADDITIVE_NTT128_HASHES
from binius_ntt_tpu_torch import AdditiveNTT128
from binius_ntt_tpu_torch.layout.bitslicing import bitslice_transpose
from binius_ntt_tpu_torch.ntt import cuda_fused as cf
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck
from binius_ntt_tpu_torch.ntt.additive import precompute_subspace_evals
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _words(log_h, log_rate):
    return mt19937_stream(0xDEADBEEF + log_h + log_rate, (1 << log_h) * 4)


def _rand(seed, shape, device):
    rng = np.random.default_rng(seed)
    return to_torch(rng.integers(0, 1 << 32, shape, dtype=np.uint32), device)


@pytest.mark.parametrize("rows", [1, 127, 1 << 12])
def test_mul_tiles_kernel_matches_plain(dev, rows):
    a, b = _rand(1, (rows, 128), dev), _rand(2, (rows, 128), dev)
    before = ck.mul_tiles.launches
    got = ck.mul_tiles(a, b)
    torch.cuda.synchronize()
    assert ck.mul_tiles.launches == before + 1
    assert torch.equal(got, ck.mul_tiles_plain(a, b))


def test_mul_tiles_refuses_what_the_kernel_does_not_take(dev):
    a = _rand(3, (64, 128), dev)
    with pytest.raises(ValueError, match="contiguous"):
        ck.mul_tiles(a[::2], a[::2])
    with pytest.raises(ValueError, match="expected"):
        ck.mul_tiles(a, a.cpu())
    with pytest.raises(ValueError, match="int32"):
        ck.mul_tiles(a.long(), a.long())


@pytest.mark.parametrize("log_h,log_rate,kb,ku,pt", [
    (9, 1, 2, 2, 2), (12, 0, 2, 2, 2), (10, 2, 3, 1, 1), (13, 4, 8, 8, 8),
])
def test_stage_group_kernel_matches_plain(dev, log_h, log_rate, kb, ku, pt,
                                          monkeypatch):
    monkeypatch.setattr(cf, "KB", kb)
    monkeypatch.setattr(cf, "KU", ku)
    monkeypatch.setattr(cf, "PT", pt)
    rows = precompute_subspace_evals(log_h, log_rate, 7)
    tables = cf.build_tables(rows, log_h, log_rate, dev)
    cosets = 1 << log_rate
    data = bitslice_transpose(to_torch(_words(log_h, log_rate),
                                       dev).view(-1, 128))
    x = data.repeat(cosets, 1).view(cosets, -1, 128)
    before = cf.stage_group.launches
    for (t0, k, low, mtile, minst, lanes, zero) in tables:
        kw = dict(t0=t0, k=k, include_low=low, zero_flags=zero)
        want = cf.stage_group_plain(x.clone(), mtile, minst, lanes, **kw)
        assert cf.stage_group(x, mtile, minst, lanes, **kw) is x
        torch.cuda.synchronize()
        assert torch.equal(x, want)
    assert cf.stage_group.launches == before + len(tables)


@pytest.mark.parametrize("log_h,log_rate", [(6, 0), (12, 0), (10, 2),
                                            (16, 0), (12, 4)])
def test_ntt128_golden_on_card(dev, log_h, log_rate):
    ntt = AdditiveNTT128(log_h, log_rate, device=dev)
    out = ntt.apply(_words(log_h, log_rate))
    assert out.device.type == "cuda"
    digest = hashlib.md5(to_numpy(out).astype("<u4").tobytes()).hexdigest()
    assert digest == ADDITIVE_NTT128_HASHES[log_rate][log_h]


def test_apply_sliced_rejects_a_tensor_on_another_device(dev):
    ntt = AdditiveNTT128(8, 0, device=dev)
    with pytest.raises(ValueError, match="apply_sliced"):
        ntt.apply_sliced(torch.zeros(8, 128, dtype=torch.int32))
