"""The streamed bit-slicing transforms and AdditiveNTT128's capacity route.

The port's ``bitslice_transpose_streamed``, ``bitslice_untranspose_streamed``
and ``bitslice_transpose_streamed_cols`` against the JAX package's (run on
the CPU) and the port's whole-array transforms; ``_pick_chunk`` against the
reference's; the capacity gate's decisions; ``AdditiveNTT128.apply`` forced
onto the capacity route against the golden digests and the JAX ``apply``;
and a prover built from streamed columns.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_hashes_oracle import ADDITIVE_NTT128_HASHES
from binius_ntt_tpu.layout import bitslicing as jbs
from binius_ntt_tpu.ntt.additive_bitsliced import \
    AdditiveNTT128 as AdditiveNTT128Jax
from binius_ntt_tpu_torch import AdditiveNTT128, Sumcheck
from binius_ntt_tpu_torch.layout import bitslicing as bs
from binius_ntt_tpu_torch.ntt import additive_bitsliced as ab
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

CPU = torch.device("cpu")
# (rows, chunk_rows): one chunk, rows under chunk_rows, several chunks
SHAPES = [(64, 64), (40, 64), (96, 32), (256, 16)]


def _rows(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, shape,
                                                dtype=np.uint32)


@pytest.mark.parametrize("w", [32, 128])
@pytest.mark.parametrize("rows,chunk_rows", SHAPES)
def test_transpose_streamed_word_equal(w, rows, chunk_rows):
    host = _rows(rows * w, (rows, w))
    got = bs.bitslice_transpose_streamed(host, chunk_rows, device=CPU)
    assert got.dtype == torch.int32 and got.device == CPU
    assert np.array_equal(to_numpy(got), np.asarray(
        jbs.bitslice_transpose_streamed(host, chunk_rows)))
    assert torch.equal(got, bs.bitslice_transpose(to_torch(host)))
    # a CPU int32 tensor is taken as well as numpy words
    assert torch.equal(bs.bitslice_transpose_streamed(
        to_torch(host), chunk_rows, device=CPU), got)


@pytest.mark.parametrize("w", [32, 128])
@pytest.mark.parametrize("rows,chunk_rows", SHAPES)
def test_untranspose_streamed_word_equal(w, rows, chunk_rows):
    sliced = _rows(rows * w + 1, (rows, w))
    got = bs.bitslice_untranspose_streamed(to_torch(sliced), chunk_rows)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint32
    assert np.array_equal(got, jbs.bitslice_untranspose_streamed(
        jnp.asarray(sliced), chunk_rows))
    assert np.array_equal(got, to_numpy(bs.bitslice_untranspose(
        to_torch(sliced))))
    # the round trip
    assert np.array_equal(bs.bitslice_untranspose_streamed(
        bs.bitslice_transpose_streamed(got, chunk_rows, device=CPU),
        chunk_rows), got)


@pytest.mark.parametrize("w", [32, 128])
@pytest.mark.parametrize("rows,chunk_rows", SHAPES)
def test_transpose_streamed_cols_word_equal(w, rows, chunk_rows):
    cols = _rows(rows + w + 2, (3, rows, w))
    got = bs.bitslice_transpose_streamed_cols(cols, chunk_rows, device=CPU)
    assert tuple(got.shape) == (3, rows, w) and got.dtype == torch.int32
    assert np.array_equal(to_numpy(got), np.asarray(
        jbs.bitslice_transpose_streamed_cols(cols, chunk_rows)))
    assert torch.equal(got, bs.bitslice_transpose(to_torch(cols)))


def test_streamed_cols_needs_three_axes():
    with pytest.raises(ValueError, match="C, rows, W"):
        bs.bitslice_transpose_streamed_cols(_rows(0, (8, 32)), 4, device=CPU)


@pytest.mark.parametrize("rows", [1 << k for k in range(0, 24, 3)]
                         + [96, 3 << 10, 5 << 12])
@pytest.mark.parametrize("chunk_rows", [1, 16, 1 << 10, 1 << 18])
def test_pick_chunk_equals_the_reference(rows, chunk_rows):
    assert bs._pick_chunk(rows, chunk_rows) == jbs._pick_chunk(rows,
                                                               chunk_rows)


@pytest.mark.parametrize("rows,chunk_rows", [(100, 64), (105, 32),
                                             ((1 << 18) + 2, 1 << 18),
                                             (3 * 7 << 5, 256)])
def test_pick_chunk_raises_where_the_reference_asserts(rows, chunk_rows):
    with pytest.raises(AssertionError):
        jbs._pick_chunk(rows, chunk_rows)
    with pytest.raises(ValueError, match=rf"{rows} rows.*"
                       rf"chunk_rows={chunk_rows}"):
        bs._pick_chunk(rows, chunk_rows)


def test_pick_chunk_refuses_an_empty_split():
    with pytest.raises(ValueError, match="must be >= 1"):
        bs._pick_chunk(0, 16)
    with pytest.raises(ValueError, match="must be >= 1"):
        bs._pick_chunk(16, 0)


# the budget on an 80 GB H100: total_memory (85,017,493,504 B) less the
# margin
H100_BUDGET = 85_017_493_504 - ab.CAPACITY_MARGIN_BYTES


@pytest.mark.parametrize("log_h,log_rate,whole", [
    (24, 0, True), (26, 0, True), (27, 0, True), (26, 2, True),
    (28, 0, True), (29, 0, True), (27, 2, True),
    (28, 2, False), (30, 0, False), (29, 2, False)])
def test_gate_decisions_on_an_80gb_card(log_h, log_rate, whole):
    assert ab.streams(log_h, log_rate, H100_BUDGET) is not whole


def test_gate_arithmetic():
    assert ab.whole_array_peak(24, 0) == int(
        ab.WHOLE_ARRAY_PEAK_FACTOR * (1 << 28))
    assert ab.whole_array_peak(26, 2) == ab.whole_array_peak(28, 0)
    peak = ab.whole_array_peak(20, 1)
    assert ab.streams(20, 1, peak - 1) and not ab.streams(20, 1, peak)
    assert ab.capacity_budget("cpu") == float("inf")
    assert not ab.streams(40, 4, ab.capacity_budget(CPU))


@pytest.fixture
def forced(monkeypatch):
    """The capacity route at any size: budget 0, chunks of 8 rows; counts
    the streamed transposes."""
    calls = []
    transpose = ab.bitslice_transpose_streamed

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return transpose(*args, **kwargs)

    monkeypatch.setattr(ab, "capacity_budget", lambda device: 0)
    monkeypatch.setattr(ab, "STREAM_CHUNK_ROWS", 8)
    monkeypatch.setattr(ab, "bitslice_transpose_streamed", counted)
    return calls


def _words(log_h, log_rate):
    return mt19937_stream(0xDEADBEEF + log_h + log_rate, (1 << log_h) * 4)


@pytest.fixture(scope="module")
def jax_outputs():
    return {(lh, lr): np.asarray(AdditiveNTT128Jax(lh, lr).apply(
        _words(lh, lr))) for lh, lr in ((10, 0), (10, 2), (9, 1))}


@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("log_h,log_rate", [(10, 0), (10, 2), (9, 1)])
def test_apply_on_the_capacity_route(forced, jax_outputs, log_h, log_rate,
                                     fused):
    words = _words(log_h, log_rate)
    ntt = AdditiveNTT128(log_h, log_rate, use_fused=fused, device="cpu")
    for x in (words, to_torch(words)):
        out = ntt.apply(x)
        assert out.dtype == torch.int32
        assert tuple(out.shape) == ((1 << (log_h + log_rate)) * 4,)
        got = to_numpy(out)
        assert np.array_equal(got, jax_outputs[log_h, log_rate])
        want = ADDITIVE_NTT128_HASHES[log_rate].get(log_h)
        if want is not None:
            assert hashlib.md5(got.astype("<u4").tobytes()).hexdigest() \
                == want
    # both inputs went through the streamed transpose, 2^log_h/32 rows
    assert forced == [((1 << log_h) // 32, 128)] * 2


def test_apply_takes_the_whole_array_route_on_the_cpu(monkeypatch):
    monkeypatch.setattr(ab, "bitslice_transpose_streamed",
                        lambda *a, **k: pytest.fail("streamed on the CPU"))
    out = AdditiveNTT128(10, 0, device="cpu").apply(_words(10, 0))
    assert hashlib.md5(to_numpy(out).astype("<u4").tobytes()).hexdigest() \
        == ADDITIVE_NTT128_HASHES[0][10]


def test_capacity_route_checks_its_input(forced):
    ntt = AdditiveNTT128(8, 0, device="cpu")
    with pytest.raises(ValueError, match="input shape"):
        ntt.apply(np.zeros(100, np.uint32))
    with pytest.raises(ValueError, match="int32"):
        ntt.apply(torch.zeros((1 << 8) * 4, dtype=torch.int64))


@pytest.mark.parametrize("comp,num_vars", [(2, 8), (3, 9)])
def test_sumcheck_from_streamed_columns(comp, num_vars):
    """A prover built from bitslice_transpose_streamed_cols' output gives
    the first-round messages of one built from the host words."""
    b = (1 << num_vars) // 32
    words = _rows(comp * num_vars, (comp, b, 128))
    host = Sumcheck(words.reshape(-1), comp, num_vars, device="cpu")
    cols = bs.bitslice_transpose_streamed_cols(words, 2, device=CPU)
    streamed = Sumcheck(cols, comp, num_vars, data_is_transposed=True,
                        device="cpu")
    for _ in range(2):
        (s0, p0), (s1, p1) = host.round_messages(), streamed.round_messages()
        assert np.array_equal(s0, s1) and np.array_equal(p0, p1)
        challenge = _rows(comp, (4,))
        host.move_to_next_round(challenge)
        streamed.move_to_next_round(challenge)
