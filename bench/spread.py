"""The spread of each metric over a set of runs, for setting bounds.

    python3 bench/spread.py run1.out run2.out ...

Each file holds one run's output; its last JSON line is read.  For each
metric: the values, the median, and the spread, (q3 - q1) / median with
the quartiles of ``statistics.quantiles(values, n=4)``.  Not part of a
benchmark run.
"""
import json
import statistics
import sys


def last_result(path: str) -> dict:
    lines = [l for l in open(path) if l.startswith("{")]
    return json.loads(lines[-1])


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths) -> int:
    runs = [last_result(p) for p in paths]
    names = sorted({k for r in runs for k in r["metrics"]})
    for n in names:
        vals = [r["metrics"][n]["value"] for r in runs if n in r["metrics"]]
        out = {"metric": n, "n": len(vals),
               "median": statistics.median(vals), "values": vals}
        if len(vals) >= 2:
            out["spread"] = spread(vals)
        print(json.dumps(out))
    print(json.dumps({"correct": [r["correct"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
