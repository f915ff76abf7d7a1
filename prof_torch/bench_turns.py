"""Benchmark cells run on this checkout and on another, in turns, on one
card.

    python3 prof_torch/bench_turns.py --parent <checkout> --cells <a,b,...>
        [--pairs 2] [--trace 0|1] [--seed 2900000000] [--seconds 30]

For each cell, ``--pairs`` pairs of runs of ``python3 -m vosbench.run``,
each pair on a seed of its own, in the order parent, this, this, parent
(then again), each run in its own process from the root of its checkout.
Every result line goes to ``chiprun_out/bench_turns/<cell>.jsonl`` with
the side, seed and exit code beside it, its standard error's last lines
to ``<cell>.<side>.<seed>.err``; one line a run is printed, then a JSON
line of each cell's end-to-end medians by side.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "bench_turns"


def run_one(checkout: Path, cell: str, seed: int, seconds: float, trace: int):
    cmd = [sys.executable, "-m", "vosbench.run", "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    r = subprocess.run(cmd, cwd=checkout, capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    return r.returncode, line, "\n".join(r.stderr.splitlines()[-40:])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", required=True)
    p.add_argument("--cells", required=True)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--seed", type=int, default=2_900_000_000)
    p.add_argument("--seconds", type=float, default=30)
    args = p.parse_args()
    sides = {"parent": Path(args.parent).resolve(), "this": ROOT}
    OUT.mkdir(parents=True, exist_ok=True)
    medians = {}
    for cell in args.cells.split(","):
        values = {"parent": {}, "this": {}}
        for k in range(args.pairs):
            seed = args.seed + 1000 * k + (7 if args.trace else 0)
            for side in (("parent", "this") if k % 2 == 0 else ("this", "parent")):
                rc, line, err = run_one(sides[side], cell, seed, args.seconds, args.trace)
                tag = f"{cell}.{side}.{seed}.t{args.trace}"
                (OUT / f"{tag}.err").write_text(err)
                with open(OUT / f"{cell}.jsonl", "a") as f:
                    f.write(json.dumps({"side": side, "seed": seed, "trace": args.trace, "rc": rc,
                                        "line": line}) + "\n")
                metrics = (line or {}).get("metrics", {})
                for name, m in metrics.items():
                    values[side].setdefault(name, []).append(m["value"])
                print(f"{cell} {side} seed {seed} trace {args.trace}: rc {rc} correct "
                      f"{(line or {}).get('correct')} "
                      + ", ".join(f"{n} {m['value']:.6g}" for n, m in metrics.items()),
                      flush=True)
        medians[cell] = {side: {n: statistics.median(v) for n, v in vals.items()} for side, vals in values.items()}
    print(json.dumps({"medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
