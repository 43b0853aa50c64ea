"""tools/torch_sharded_nccl.py on two gloo ranks on the CPU: the checks it
runs at capacity on four cards (the native oracle's input, the gathered
output held to the single-device transform a chunk of rows at a time, and
on rank 0 the digest of the output untransposed and hashed chunk by chunk),
at log_h 10, rate 2, against the oracle's golden digest.

Each rank is a child process running the tool itself, meeting the other
through a ``file://`` store under the test's own temporary directory (as
tests/test_torch_distributed.py does), and waited for at most
CHILD_TIMEOUT seconds.  No process group is set up in this process.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from golden_hashes_oracle import ADDITIVE_NTT128_HASHES

REPO = Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "torch_sharded_nccl.py"
CHILD_TIMEOUT = 120
WORLD, LOG_H, LOG_RATE = 2, 10, 2


def _run_tool(tmp_path: Path, chunk_rows: int) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, str(TOOL), "--log-h", str(LOG_H), "--rates",
         str(LOG_RATE), "--chunk-rows", str(chunk_rows), "--init-method",
         store, "--world-size", str(WORLD), "--rank", str(r)],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    logs, fail = [], []
    try:
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=CHILD_TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} of {WORLD} did not finish in "
                            f"{CHILD_TIMEOUT} s")
            logs.append(log.decode(errors="replace"))
            if p.returncode != 0:
                fail.append(f"rank {r} rc={p.returncode}:\n{logs[r][-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not fail, "\n".join(fail)
    return json.loads(logs[0].strip().splitlines()[-1])


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="g++ is absent: the native oracle, the tool's "
                    "input, cannot be built")
@pytest.mark.parametrize("chunk_rows", [5, 1 << 18])
def test_tool_on_two_gloo_ranks(tmp_path, chunk_rows):
    """Rows 128 of output: chunks of 5 rows end in a partial chunk; 2^18
    rows is the default, one chunk here."""
    got = _run_tool(tmp_path, chunk_rows)
    assert got["world"] == WORLD and got["backend"] == "gloo"
    assert got["log_h"] == LOG_H and got["card"] is None
    assert sorted(r["rank"] for r in got["ranks"]) == list(range(WORLD))
    for r in got["ranks"]:
        res = r["results"][str(LOG_RATE)]
        assert res["equal_to_single"] and res["golden"]
        # log_d cross-device stages, OVERLAP_HALVES exchanges each
        assert res["exchanges"] == 1 * 2
        if r["rank"] == 0:
            assert res["digest"] == ADDITIVE_NTT128_HASHES[LOG_RATE][LOG_H]
        else:
            assert "digest" not in res
