#!/usr/bin/env python3
"""Spreads of a cell's end-to-end metrics over sets of runs, and the bounds they give.

    python3 h100bench/tools/spread.py sets_yolov3-serve-b32.jsonl

Each line of the file is {"set": <name>, "seed": <n>, "line": <a run's result line>}.
For every metric and set: the median, and the spread, the distance between the
first and third quartiles (statistics.quantiles(values, n=4)) over the
median; then five times the widest spread of the sets, never under 1%, the
bound it suggests (setup_s takes 0.25 whatever its spread).
"""

import json
import statistics
import sys
from collections import defaultdict


def main(paths):
    for path in paths:
        vals = defaultdict(lambda: defaultdict(list))
        for row in map(json.loads, open(path)):
            if row["line"].get("correct") is not True:
                print(f"{path}: set {row['set']} seed {row['seed']} not correct: {row['line'].get('checks')}")
            for name, m in row["line"]["metrics"].items():
                vals[name][row["set"]].append(m["value"])
        for name, sets in vals.items():
            spreads = []
            for s, v in sets.items():
                if len(v) < 2:
                    continue
                q1, med, q3 = statistics.quantiles(v, n=4)
                spreads.append((q3 - q1) / statistics.median(v))
                print(f"{path} {name} set {s}: n {len(v)} median {statistics.median(v)!r} spread {spreads[-1]!r} "
                      f"min {min(v)!r} max {max(v)!r}")
            if spreads:
                bound = 0.25 if name == "setup_s" else max(0.01, 5 * max(spreads))
                print(f"{path} {name}: widest spread {max(spreads)!r} -> bound {bound!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
