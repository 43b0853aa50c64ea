"""The torch port's GF(2^128) additive NTT end to end.

Golden digests from the native oracle (tests/golden_hashes_oracle.py), word
equality with the JAX AdditiveNTT128, the port's import boundary (no JAX),
and chip_smoke.py's refusal to report a result without a GPU.
"""

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from golden_hashes_oracle import ADDITIVE_NTT128_HASHES
from binius_ntt_tpu.ntt.additive_bitsliced import \
    AdditiveNTT128 as AdditiveNTT128Jax
from binius_ntt_tpu_torch import AdditiveNTT128, DataOrder, NTTData
from binius_ntt_tpu_torch.utils.bits import to_numpy, to_torch
from binius_ntt_tpu_torch.utils.mt19937 import mt19937_stream

ROOT = Path(__file__).resolve().parent.parent


def _md5(t) -> str:
    return hashlib.md5(to_numpy(t).astype("<u4").tobytes()).hexdigest()


def _words(log_h, log_rate):
    return mt19937_stream(0xDEADBEEF + log_h + log_rate, (1 << log_h) * 4)


@pytest.mark.parametrize("log_h,log_rate", [
    (6, 0), (9, 0), (12, 0), (6, 2), (10, 2),
    (6, 1), (8, 3), (8, 4), (10, 1),
])
def test_ntt128_golden_cpu(log_h, log_rate):
    out = AdditiveNTT128(log_h, log_rate, device="cpu").apply(
        _words(log_h, log_rate))
    assert out.shape == ((1 << (log_h + log_rate)) * 4,)
    assert _md5(out) == ADDITIVE_NTT128_HASHES[log_rate][log_h]


def test_matches_jax_transform():
    words = _words(9, 1)
    want = np.asarray(AdditiveNTT128Jax(9, 1).apply(words))
    ntt = AdditiveNTT128(9, 1, device="cpu")
    assert np.array_equal(to_numpy(ntt.apply(words)), want)
    # int32 tensors and NTTData go through the same path
    assert np.array_equal(to_numpy(ntt.apply(to_torch(words))), want)
    wrapped = ntt.apply(NTTData(words))
    assert wrapped.order is DataOrder.IN_ORDER
    assert np.array_equal(to_numpy(wrapped.data), want)


def test_apply_sliced_leaves_input_and_holds_tables_as_buffers():
    ntt = AdditiveNTT128(8, 2, device="cpu")
    assert ntt.device == torch.device("cpu")
    names = set(dict(ntt.named_buffers()))
    assert {"mtile0", "minst0", "lanes0"} <= names
    x = torch.arange(8 * 128, dtype=torch.int32).view(8, 128)
    before = x.clone()
    out = ntt.apply_sliced(x)
    assert out.shape == (32, 128) and torch.equal(x, before)


def test_apply_rejects_bad_input():
    ntt = AdditiveNTT128(6, 0, device="cpu")
    with pytest.raises(ValueError, match="input shape"):
        ntt.apply(np.zeros(10, np.uint32))
    with pytest.raises(ValueError, match="IN_ORDER"):
        ntt.apply(NTTData(np.zeros(256, np.uint32), DataOrder.BIT_REVERSED))
    with pytest.raises(ValueError, match="int32"):
        ntt.apply(torch.zeros(256, dtype=torch.int64))
    with pytest.raises(ValueError, match="apply_sliced"):
        ntt.apply_sliced(torch.zeros(3, 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="log_h"):
        AdditiveNTT128(4, 0, device="cpu")
    with pytest.raises(ValueError, match="log_rate"):
        AdditiveNTT128(8, 5, device="cpu")


def test_port_imports_no_jax():
    code = ("import sys, importlib, pkgutil, binius_ntt_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'binius_ntt_tpu.'))]\n"
            "assert not bad, bad\nprint('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout
    for path in (ROOT / "binius_ntt_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and words[1].split(".")[0] in ("jax",
                                                       "binius_ntt_tpu")), \
                (path, line)


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", script)
    proc = _run_smoke(tmp_path, script)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "binius_ntt_tpu_torch" in proc.stderr    # the port is missing
