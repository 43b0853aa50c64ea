"""The port's own golden digests for GF(2^128) sizes past the oracle table,
the merged table that chip_smoke.py and the tools read, and the chunked
hashes they hold a card-sized output to.

``PORT_NTT128_HASHES`` keeps the convention of tests/golden_hashes_oracle.py
(the native C++ oracle of tools/native/oracle.cpp; input the raw mt19937
stream of seed 0xdeadbeef + log_h + log_rate, 4 words an element,
little-endian element-major; MD5 over the little-endian output words).
That table is left as it is; :func:`ntt128_hashes` lays this one over it
and refuses a size that both hold.

The module imports no JAX: chip_smoke.py and the tools load it by path.
"""

import hashlib
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from binius_ntt_tpu_torch import AdditiveNTT128  # noqa: E402
from binius_ntt_tpu_torch.layout.bitslicing import (  # noqa: E402
    bitslice_transpose, bitslice_untranspose)
from binius_ntt_tpu_torch.utils.benchlib import (  # noqa: E402
    md5_untransposed, md5_words)
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch  # noqa: E402
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream  # noqa: E402

# {log_rate: {log_h: md5}}.  2^28 at rate 2 (2^32 output words, 17.2 GB):
# minted by `python tools/gen_golden128_tail.py 28:2` on one CPU core,
# 33m17s of wall time with its self-check, the MD5 fed from the output
# array in place (the tool's astype().tobytes() would add two 17.2 GB
# copies to the oracle's 43 GB).
PORT_NTT128_HASHES = {
    2: {28: "ff8e2b23c16677d23ff64df4847fa4b3"},
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def oracle_ntt128_hashes() -> dict:
    """ADDITIVE_NTT128_HASHES of tests/golden_hashes_oracle.py."""
    return _load("golden_hashes_oracle", Path(__file__).with_name(
        "golden_hashes_oracle.py")).ADDITIVE_NTT128_HASHES


def merge_hashes(base: dict, extra: dict) -> dict:
    """A new {log_rate: {log_h: md5}} of both tables; a (log_rate, log_h)
    that both hold raises ValueError."""
    out = {r: dict(t) for r, t in base.items()}
    for r, t in extra.items():
        shared = sorted(set(out.get(r, {})) & set(t))
        if shared:
            raise ValueError(f"golden table: log_rate {r}, log_h {shared} "
                             f"in both tables")
        out.setdefault(r, {}).update(t)
    return out


def ntt128_hashes() -> dict:
    """The GF(2^128) golden table that chip_smoke.py and the tools read:
    the oracle table with PORT_NTT128_HASHES laid over it."""
    return merge_hashes(oracle_ntt128_hashes(), PORT_NTT128_HASHES)


def test_port_table_values_are_md5_hex():
    for table in PORT_NTT128_HASHES.values():
        for digest in table.values():
            assert re.fullmatch(r"[0-9a-f]{32}", digest), digest


def test_port_table_shares_no_key_with_the_oracle_table():
    oracle = oracle_ntt128_hashes()
    for r, table in PORT_NTT128_HASHES.items():
        assert not set(table) & set(oracle.get(r, {})), r


def test_merged_table_holds_both_tables():
    merged, oracle = ntt128_hashes(), oracle_ntt128_hashes()
    assert merged[2][28] == PORT_NTT128_HASHES[2][28]
    for r, table in oracle.items():
        for log_h, digest in table.items():
            assert merged[r][log_h] == digest
    assert sum(map(len, merged.values())) == (
        sum(map(len, oracle.values()))
        + sum(map(len, PORT_NTT128_HASHES.values())))


def test_merge_refuses_a_size_in_both_tables():
    with pytest.raises(ValueError, match=r"log_rate 2, log_h \[10\]"):
        merge_hashes({2: {10: "a" * 32, 11: "b" * 32}}, {2: {10: "c" * 32}})
    # the inputs are left as they were
    base = {0: {1: "a" * 32}}
    assert merge_hashes(base, {0: {2: "b" * 32}, 3: {4: "c" * 32}}) == {
        0: {1: "a" * 32, 2: "b" * 32}, 3: {4: "c" * 32}}
    assert base == {0: {1: "a" * 32}}


def _load_tool(name: str):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        return _load(name, ROOT / "tools" / f"{name}.py")
    finally:
        sys.path.remove(str(ROOT / "tools"))


@pytest.mark.parametrize("reader", [
    lambda: _load("chip_smoke", ROOT / "chip_smoke.py").golden_table(),
    lambda: _load_tool("torch_capacity").golden_table(),
    lambda: _load_tool("torch_sharded_nccl").golden_table()],
    ids=["chip_smoke", "torch_capacity", "torch_sharded_nccl"])
def test_readers_take_the_merged_table(reader):
    assert reader() == ntt128_hashes()


@pytest.mark.parametrize("chunk_rows", [1, 3, 8, 1 << 20])
@pytest.mark.parametrize("log_rate", [0, 2])
def test_md5_untransposed_meets_the_golden_digest(log_rate, chunk_rows):
    """The port's transform at log_h 10 on the CPU, hashed a few rows at a
    time (a partial last chunk where chunk_rows does not divide the rows),
    gives the oracle's digest and the whole untranspose's."""
    log_h = 10
    words = mt19937_stream(0xDEADBEEF + log_h + log_rate, (1 << log_h) * 4)
    sliced = bitslice_transpose(to_torch(words).reshape(-1, 128))
    out = AdditiveNTT128(log_h, log_rate, device="cpu").apply_sliced(sliced)
    whole = hashlib.md5(to_numpy(bitslice_untranspose(out)).astype(
        "<u4").tobytes()).hexdigest()
    got = md5_untransposed(out, chunk_rows)
    assert got == whole == oracle_ntt128_hashes()[log_rate][log_h]


@pytest.mark.parametrize("chunk_words", [1, 7, 128, 1 << 26])
def test_md5_words_in_chunks_equals_one_hash(chunk_words):
    words = np.random.default_rng(5).integers(0, 1 << 32, 1000,
                                              dtype=np.uint32)
    t = to_torch(words).reshape(8, 125)
    assert md5_words(t, chunk_words) == hashlib.md5(
        words.astype("<u4").tobytes()).hexdigest()
