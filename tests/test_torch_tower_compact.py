"""The torch port's compact tower multiply (fields/tower_compact.py).

``mul_compact``, ``multiply_alpha_compact`` and ``mul_compact_tiles`` (on
the CPU, so its plain version) against the JAX ``mul_compact`` /
``multiply_alpha_compact``, against the scalar oracle on sampled pairs, and
on the reference's 128-bit vector.  JAX's ``mul_compact_tiles`` is held
through ``mul_compact``, the function its kernel body computes: on the CPU
backend the Pallas call needs interpret mode, which it takes no flag for.
Tolerance: exact word equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binius_ntt_tpu.fields import tower_compact as tc_jax
from binius_ntt_tpu_torch import tower_compact as tc
from binius_ntt_tpu_torch.fields import tower_scalar as ts
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch


def _to_int(limbs) -> int:
    return int.from_bytes(np.asarray(limbs).astype("<u4").tobytes(), "little")


def _pairs(seed, height, n=64):
    rng = np.random.default_rng(seed)
    shape = (n, 1 << (height - 5)) if height > 5 else (n,)
    return (rng.integers(0, 1 << 32, shape, dtype=np.uint32),
            rng.integers(0, 1 << 32, shape, dtype=np.uint32))


@pytest.mark.parametrize("height", range(1, 8))
def test_mul_compact_matches_jax(height):
    a, b = _pairs(height, height)
    want = np.asarray(tc_jax.mul_compact(jnp.asarray(a), jnp.asarray(b),
                                         height))
    got = tc.mul_compact(to_torch(a), to_torch(b), height)
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("height", [5, 6, 7])
def test_multiply_alpha_compact_matches_jax(height):
    a, _ = _pairs(10 + height, height)
    want = np.asarray(tc_jax.multiply_alpha_compact(jnp.asarray(a), height))
    got = tc.multiply_alpha_compact(to_torch(a), height)
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("height", [5, 6, 7])
def test_mul_compact_tiles_matches_jax_mul_compact(height):
    a, b = _pairs(20 + height, height, n=256)
    a, b = a.reshape(256, -1), b.reshape(256, -1)
    want = np.asarray(tc_jax.mul_compact(jnp.asarray(a), jnp.asarray(b),
                                         height))
    launches = tc.mul_compact_tiles.launches
    got = tc.mul_compact_tiles(to_torch(a), to_torch(b), height)
    assert got.shape == (256, 1 << (height - 5))
    assert np.array_equal(to_numpy(got).reshape(want.shape), want)
    assert tc.mul_compact_tiles.launches == launches    # plain on the CPU


@pytest.mark.parametrize("height", [5, 6, 7])
def test_mul_compact_tiles_matches_the_scalar_oracle(height):
    a, b = _pairs(30 + height, height, n=128)
    a, b = a.reshape(128, -1), b.reshape(128, -1)
    got = to_numpy(tc.mul_compact_tiles(to_torch(a), to_torch(b), height))
    alpha = to_numpy(tc.multiply_alpha_compact(to_torch(a), height))
    for i in range(128):
        av, bv = _to_int(a[i]), _to_int(b[i])
        assert _to_int(got[i]) == ts.multiply(av, bv, height)
        assert _to_int(alpha[i]) == ts.multiply_alpha(av, height)


def test_reference_128bit_kat():
    a = 0x0123456789ABCDEF0011223344556677
    b = 0xFEDCBA9876543210AABBCCDDEEFF0099
    la = to_torch(np.frombuffer(a.to_bytes(16, "little"),
                                dtype=np.uint32).reshape(1, 4))
    lb = to_torch(np.frombuffer(b.to_bytes(16, "little"),
                                dtype=np.uint32).reshape(1, 4))
    want = ts.multiply(a, b, 7)
    assert _to_int(to_numpy(tc.mul_compact(la, lb, 7))[0]) == want
    assert _to_int(to_numpy(tc.mul_compact_tiles(la, lb, 7))[0]) == want


def test_mul_compact_tiles_refuses_what_it_does_not_take():
    x = torch.zeros(8, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="height"):
        tc.mul_compact_tiles(x, x, 8)
    with pytest.raises(ValueError, match="height"):
        tc.mul_compact_tiles(x[:, :1], x[:, :1], 4)
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        tc.mul_compact_tiles(x, x, 6)
    with pytest.raises(ValueError, match="int32"):
        tc.mul_compact_tiles(x.long(), x.long(), 7)
    with pytest.raises(ValueError, match="differ"):
        tc.mul_compact_tiles(x, x[:4], 7)
