"""The port's binding of the native oracle (tools/native/oracle.cpp).

Word for word against the port's numpy mt19937 and the JAX package's own
binding, the scalar tower multiply, the golden tables, and the port's NTTs
on the CPU.  Skips where g++ is absent (the library is built at first use).
"""

import hashlib
import re
import shutil

import numpy as np
import pytest

from golden_hashes import ADDITIVE_NTT_HASHES
from golden_hashes_oracle import ADDITIVE_NTT128_HASHES
from binius_ntt_tpu.utils import native_oracle as jax_oracle
from binius_ntt_tpu_torch import AdditiveNTT, AdditiveNTT128
from binius_ntt_tpu_torch.fields import tower_scalar
from binius_ntt_tpu_torch.utils import native_oracle
from binius_ntt_tpu_torch.utils.bits import to_numpy
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

SEED = 0xDEADBEEF


@pytest.fixture
def oracle():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native oracle cannot be built")
    assert native_oracle.available()
    return native_oracle


def _md5(words: np.ndarray) -> str:
    return hashlib.md5(words.astype("<u4").tobytes()).hexdigest()


@pytest.mark.parametrize("seed,n", [(0, 1), (SEED + 5, 1000),
                                    (SEED + 24, 624 * 3 + 7), (7, 1 << 16)])
def test_mt19937_fill_word_equal(oracle, seed, n):
    got = oracle.mt19937_fill(seed, n)
    assert got.dtype == np.uint32 and got.shape == (n,)
    assert np.array_equal(got, mt19937_stream(seed, n))
    assert np.array_equal(got, jax_oracle.mt19937_fill(seed, n))


def test_tower_mul128_against_the_scalar_tower(oracle):
    a, b = mt19937_stream(1, 4 * 64), mt19937_stream(2, 4 * 64)
    got = oracle.tower_mul128(a, b)
    assert np.array_equal(got, jax_oracle.tower_mul128(a, b))

    def value(w, i):
        return int.from_bytes(w[4 * i:4 * i + 4].astype("<u4").tobytes(),
                              "little")

    for i in range(64):
        assert value(got, i) == tower_scalar.multiply(value(a, i),
                                                      value(b, i), 7)


@pytest.mark.parametrize("log_h,log_rate", [(12, 0), (12, 2), (16, 0)])
def test_additive_ntt32_golden(oracle, log_h, log_rate):
    x = oracle.mt19937_fill(SEED + log_h + log_rate, 1 << log_h)
    out = oracle.additive_ntt32(x, log_h, log_rate)
    assert out.shape == (1 << (log_h + log_rate),)
    assert _md5(out) == ADDITIVE_NTT_HASHES[log_rate][log_h]


@pytest.mark.parametrize("log_h,log_rate", [(12, 0), (12, 2), (16, 0)])
def test_additive_ntt128_golden(oracle, log_h, log_rate):
    x = oracle.mt19937_fill(SEED + log_h + log_rate, (1 << log_h) * 4)
    out = oracle.additive_ntt128(x, log_h, log_rate)
    assert out.shape == ((1 << (log_h + log_rate)) * 4,)
    assert _md5(out) == ADDITIVE_NTT128_HASHES[log_rate][log_h]


@pytest.mark.parametrize("log_h,log_rate", [(8, 0), (10, 3), (12, 1)])
def test_additive_ntt32_equals_the_port(oracle, log_h, log_rate):
    x = oracle.mt19937_fill(SEED + 100 + log_h, 1 << log_h)
    want = to_numpy(AdditiveNTT(log_h, log_rate, device="cpu").apply(x))
    assert np.array_equal(oracle.additive_ntt32(x, log_h, log_rate), want)


@pytest.mark.parametrize("log_h,log_rate,fused", [(6, 1, None), (9, 3, None),
                                                  (12, 0, None),
                                                  (8, 2, False)])
def test_additive_ntt128_equals_the_port(oracle, log_h, log_rate, fused):
    x = oracle.mt19937_fill(SEED + 200 + log_h, (1 << log_h) * 4)
    want = to_numpy(AdditiveNTT128(log_h, log_rate, use_fused=fused,
                                   device="cpu").apply(x))
    assert np.array_equal(oracle.additive_ntt128(x, log_h, log_rate), want)


def test_library_is_in_the_ports_build_dir_under_its_digest(oracle):
    path = oracle.library_path()
    assert path.exists()
    assert path.parent == native_oracle.BUILD_DIR
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "binius_ntt_tpu_torch"
    assert re.fullmatch(r"liboracle_[0-9a-f]{16}\.so", path.name)
    assert native_oracle.SOURCE.name == "oracle.cpp"
    assert native_oracle.SOURCE.parent.parts[-2:] == ("tools", "native")


@pytest.mark.parametrize("call,match", [
    (lambda o: o.tower_mul128(np.zeros(8, np.uint32), np.zeros(4, np.uint32)),
     "tower_mul128"),
    (lambda o: o.tower_mul128(np.zeros(6, np.uint32), np.zeros(6, np.uint32)),
     "multiple of 4"),
    (lambda o: o.additive_ntt32(np.zeros(100, np.uint32), 7, 0),
     "additive_ntt32"),
    (lambda o: o.additive_ntt128(np.zeros(128, np.uint32), 6, 0),
     "additive_ntt128"),
    (lambda o: o.additive_ntt32(np.zeros(64, np.float32), 6, 0),
     "uint32"),
])
def test_bad_operands_raise_before_the_library(oracle, call, match):
    with pytest.raises(ValueError, match=match):
        call(oracle)
