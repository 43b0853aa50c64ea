"""Bit-sliced layout and multiply of the torch port vs the JAX package.

Inputs come from numpy (seeded) and go to both packages; every comparison
is exact word equality (GF(2) arithmetic has no rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.fields import bitsliced as bs_jax
from binius_ntt_tpu.layout import bitslicing as lay_jax
from binius_ntt_tpu_torch.fields import bitsliced
from binius_ntt_tpu_torch.layout import bitslicing
from binius_ntt_tpu_torch.ntt import cuda_kernels as ck
from binius_ntt_tpu_torch.utils.bits import lsr, to_numpy, to_torch, u32


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, shape,
                                                dtype=np.uint32)


def test_lsr_matches_uint32_shift():
    x = _words(1, (4096,))
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    t = to_torch(x)
    for s in range(32):
        assert np.array_equal(to_numpy(lsr(t, s)), x >> np.uint32(s))


def test_u32_and_views_keep_bits():
    assert u32(0xFFFF0000) == -65536 and u32(0x7FFFFFFF) == 0x7FFFFFFF
    assert u32(0xFFFFFFFF) == -1 and u32(0) == 0
    x = _words(2, (3, 128))
    t = to_torch(x)
    assert t.dtype == torch.int32
    assert np.array_equal(to_numpy(t), x)
    assert np.array_equal(to_numpy(t & u32(0xFFFF0000)), x & 0xFFFF0000)
    with pytest.raises(TypeError):
        to_torch(x.astype(np.int64))


@pytest.mark.parametrize("width", [32, 128])
def test_bitslice_transpose_matches_reference(width):
    x = _words(width, (6, width))
    got = bitslicing.bitslice_transpose(to_torch(x))
    assert np.array_equal(to_numpy(got),
                          np.asarray(lay_jax.bitslice_transpose(x)))
    back = bitslicing.bitslice_untranspose(got)
    assert np.array_equal(to_numpy(back), x)
    assert np.array_equal(
        to_numpy(bitslicing.bitslice_untranspose(to_torch(x))),
        np.asarray(lay_jax.bitslice_untranspose(x)))


def test_transpose32_is_an_involution():
    x = to_torch(_words(3, (5, 32)))
    t = bitslicing.transpose32(x)
    assert torch.equal(bitslicing.transpose32(t), x)
    with pytest.raises(ValueError):
        bitslicing.transpose32(x[:, :16])


@pytest.mark.parametrize("height,n", [(7, 64), (5, 33), (3, 8)])
def test_multiply_matches_reference(height, n):
    a = _words(10 + height, (n, 1 << height))
    b = _words(20 + height, (n, 1 << height))
    want = np.asarray(bs_jax.multiply(jnp.asarray(a), jnp.asarray(b),
                                      height))
    got = bitsliced.multiply(to_torch(a), to_torch(b), height)
    assert np.array_equal(to_numpy(got), want)


def test_multiply_broadcasts_and_alpha_matches():
    a = _words(30, (4, 1, 128))
    b = _words(31, (4, 5, 128))
    want = np.asarray(bs_jax.multiply(jnp.asarray(a), jnp.asarray(b), 7))
    got = bitsliced.multiply(to_torch(a), to_torch(b), 7)
    assert np.array_equal(to_numpy(got), want)
    for h in (0, 3, 7):
        x = _words(32 + h, (3, 1 << h))
        assert np.array_equal(
            to_numpy(bitsliced.multiply_alpha(to_torch(x), h)),
            np.asarray(bs_jax.multiply_alpha(jnp.asarray(x), h)))
    with pytest.raises(ValueError):
        bitsliced.multiply(to_torch(a), to_torch(b[..., :64]), 7)


def test_mul_tiles_plain_matches_reference():
    a = _words(40, (64, 128))     # the shape of test_multiply_matches_reference
    b = _words(41, (64, 128))
    want = np.asarray(bs_jax.multiply(jnp.asarray(a), jnp.asarray(b), 7))
    assert np.array_equal(
        to_numpy(ck.mul_tiles_plain(to_torch(a), to_torch(b))), want)


def test_mul_tiles_on_cpu_runs_plain_and_launches_nothing():
    a = to_torch(_words(42, (16, 128)))
    b = to_torch(_words(43, (16, 128)))
    before = ck.mul_tiles.launches
    assert torch.equal(ck.mul_tiles(a, b), ck.mul_tiles_plain(a, b))
    assert ck.mul_tiles.launches == before
