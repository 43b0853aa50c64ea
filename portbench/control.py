"""The control of a cell's check, at the cell's own size.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed (and, in a cell over several ranks, each rank's shard in
turn): the cell's inputs made on the card as a run makes them,
the plain reference put in the program's place with every product cut to
GF(2^32) (drivers' ``control_answers``), and the cell's own check of
those answers.  Prints one JSON line a seed with the check's readings;
the control has to come out not correct on every seed.  The benchmark's
runs do not run this; it is how the readings in PERF.md were taken.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = run.Cell(args.workload)
    drv = cell.driver
    chips = cell.workload["chips"]
    for seed in args.seeds:
        # a cell over several ranks: each rank's shard in turn, on one
        # card (a shard's check needs nothing of the other ranks)
        shards = [{}] if chips == 1 else [{"rank": d, "world": chips}
                                          for d in range(chips)]
        total, compared, failed, correct = {}, 0, 0, True
        t0 = time.perf_counter()
        check_s = 0.0
        for kw in shards:
            inputs = drv.make_inputs(cell.config, cell.traffic, seed,
                                     args.device, **kw)
            answers = drv.control_answers(cell.config, cell.traffic, inputs,
                                          seed, **kw)
            if "sample" in cell.traffic:
                cell.traffic["sample"] = len(answers)
            t1 = time.perf_counter()
            checks, n, bad = drv.check(cell.config, cell.traffic, inputs,
                                       answers, seed, **kw)
            check_s += time.perf_counter() - t1
            compared, failed = compared + n, failed + bad
            for k, (v, op, lim) in checks.items():
                total[k] = total.get(k, 0) + v
                correct &= v <= lim if op == "<=" else v >= lim
            del inputs, answers
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        print(json.dumps({
            "workload": args.workload, "seed": seed, "correct": correct,
            "compared": compared, "failed": failed, "checks": total,
            "control_s": time.perf_counter() - t0 - check_s,
            "check_s": check_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
