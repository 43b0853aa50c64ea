"""The four-rank cell rehearsed on the CPU over gloo at a small size: the
launcher, the ranks in step, one result line, files only where a run may
write them, and the check failing when the exchange is left out or an
answer altered."""

import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELL = "ntt128-2e28-r2-x4.sliced"
SEED = 2 ** 31 + 4242
LOG_H = 11


def rehearse(cwd: Path, env: dict, trace: int):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "1", "--trace", str(trace),
         "--cpu-rehearsal"],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=600)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A checkout of the files a run needs, the cell's configuration cut
    to 2^LOG_H points in it, and a HOME, XDG_CACHE_HOME and TMPDIR of its
    own."""
    base = tmp_path_factory.mktemp("checkout")
    co = base / "co"
    co.mkdir()
    ignore = shutil.ignore_patterns("__pycache__", "_build")
    for name in ("portbench", "binius_ntt_tpu_torch"):
        shutil.copytree(ROOT / name, co / name, ignore=ignore)
    shutil.copy(ROOT / "BENCHMARK.json", co)
    bench = json.loads((co / "BENCHMARK.json").read_text())
    config = next(co / c["file"] for c in bench["configs"]
                  if c["name"] == CELL.split(".")[0])
    small = json.loads(config.read_text())
    small["log_h"] = LOG_H
    config.write_text(json.dumps(small))
    env = dict(os.environ)
    for key in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        d = base / key.lower()
        d.mkdir()
        env[key] = str(d)
    return base, co, env


@pytest.mark.parametrize("trace", [0, 1])
def test_four_ranks_one_line(checkout, trace):
    base, co, env = checkout
    before = {p for p in co.rglob("*")}
    p = rehearse(co, env, trace)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["correct"] and r["device"]["count"] == 4
    assert r["checks"]["outputs_compared"]["value"] == 4
    if trace:
        assert r["metrics"]["cross_stages_ms"]["value"] > 0
    else:
        assert set(r["metrics"]) == {"ntt_gbfly_per_s", "ntt_p95_ms",
                                     "setup_s"}
    new = {p for p in co.rglob("*")} - before
    assert all("__pycache__" in p.parts or ".portbench-cache" in p.parts
               for p in new), sorted(map(str, new))[:10]


def _rank(rank: int, world: int, init: str, fault: str, queue) -> None:
    import torch.distributed as dist

    from binius_ntt_tpu_torch.parallel import mesh
    from portbench import run

    if fault == "exchange_left_out":
        mesh.DistMesh.exchange_async = lambda self, parts, mask: {
            self.rank: [mesh._Arrived(t.clone()) for t in parts[self.rank]]}
    elif fault == "answer_altered" and rank == 2:
        from binius_ntt_tpu_torch.parallel import ntt128_sharded as ns
        apply_shards = ns.ShardedAdditiveNTT128.apply_shards

        def altered(self, xs):
            out = apply_shards(self, xs)
            out[self.mesh.rank][1, 2, 3] ^= 1
            return out
        ns.ShardedAdditiveNTT128.apply_shards = altered
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank, timeout=timedelta(seconds=120))
    try:
        r = run.run(CELL, SEED, 1.0, False, device="cpu",
                    overrides={"log_h": LOG_H})
    except Exception as exc:        # reported to the test, not lost
        queue.put({"error": f"rank {rank}: {exc!r}"})
        raise
    finally:
        dist.destroy_process_group()
    if rank == 0:
        queue.put(r)


@pytest.mark.parametrize("fault", ["exchange_left_out", "answer_altered"])
def test_fault_across_ranks_is_caught(fault):
    from portbench import run
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    init = f"tcp://127.0.0.1:{run.free_port()}"
    procs = [ctx.Process(target=_rank, args=(r, 4, init, fault, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        result = queue.get(timeout=300)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    assert "error" not in result, result
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("seed", [21, 2 ** 31 + 22, 2 ** 33 + 23])
def test_control_fails_on_every_shard(seed):
    """The reference in the program's place, its products cut to
    GF(2^32), comes out not correct on each rank's shard."""
    from portbench import run
    cell = run.Cell(CELL, overrides={"log_h": 10})
    drv = cell.driver
    for d in range(4):
        kw = {"rank": d, "world": 4}
        inputs = drv.make_inputs(cell.config, cell.traffic, seed, "cpu", **kw)
        answers = drv.control_answers(cell.config, cell.traffic, inputs, seed,
                                      **kw)
        checks, compared, failed = drv.check(cell.config, cell.traffic,
                                             inputs, answers, seed, **kw)
        assert failed == compared == 1 and checks["wrong_words"][0] > 0
