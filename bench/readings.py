"""Readings of the numbers compared, for setting their limits: the
program on many seeds and the control (the reference in the precision one
below the configuration's, in the program's place) on a few, in one
process.

    python3 bench/readings.py --workload <cell> --seconds 2 \
        --seeds 11 12 13 ... --control-seeds 21 22 23

One JSON line a run: {"who": "program" | "control", "seed", "checks"}.
Not part of a benchmark run.
"""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import argparse                                           # noqa: E402

import torch                                              # noqa: E402

from bench import cells, run                              # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=())
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("readings: no CUDA device; limits are read on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    for who, seeds, prog in (("program", args.seeds, None),
                             ("control", args.control_seeds,
                              cell.driver.ReferenceProgram)):
        for seed in seeds:
            t = time.perf_counter()
            res = run.run_cell(cell, seed, args.seconds, False, dev,
                               program=prog, t_start=t)
            print(json.dumps({"who": who, "seed": seed, "device": kind,
                              "correct": res["correct"],
                              "checks": {k: v["value"] for k, v in
                                         res["checks"].items()},
                              "metrics": {k: v["value"] for k, v in
                                          res["metrics"].items()},
                              "seconds": time.perf_counter() - t,
                              "judge_s": res["_diag"]["judge_s"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
