"""The readings that a cell's limits are set from, on the card, in one
process: for each seed, the program's numbers and the control's at the
cell's own size, and for a training cell the numbers of the faults planted
in the program.

    python3 -m vosbench.calibrate --workload <name> --seeds <n> [--first <seed>] [--seconds <s>]

Inference cells run the whole cell with a short window and read the
control beside the program (the reference with float8 activations in the
program's place). Training cells read, from the same weights and batches,
the program as the configuration states it, the control (the program's own
bfloat16 autocast path, the precision below float32), and the program fed
half of each batch (the mean taken over the rest). A state left unchanged
reads 1 by the measure and needs no run. One JSON line a seed on standard
output; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from vosbench import run as bench_run
from vosbench.harness import Context


def infer_seed(cell: dict, seed: int, seconds: float) -> dict:
    root = bench_run.HERE.parent
    driver = bench_run.load_module(root / "vosbench" / "drivers" / f"{cell['traffic']['driver']}.py", "cal_driver")
    ctx = Context(workload=cell["workload"]["name"], config=cell["config"], traffic=cell["traffic"],
                  seed=seed, seconds=seconds, trace=False, device=torch.device("cuda:0"),
                  t_process=time.perf_counter(), control=True)
    out = driver.run(ctx)
    return {"program": out.readings, "control": out.control, "frames_per_s": out.metrics["frames_per_s"][0]}


def train_seed(cell: dict, seed: int) -> dict:
    from vosbench import videos
    from vosbench.drivers import train_step as ts
    from vosbench.weights import train_state_dict

    cfg, tr, dev = cell["config"], cell["traffic"], torch.device("cuda:0")
    ring = videos.make_train_ring(tr, seed, dev)
    ref = ts.reference_run(cfg["model"], seed, ring, dev)
    out = {}
    half = [(imgs[: len(imgs) // 2], anns[: len(anns) // 2]) for imgs, anns in ring]
    for name, bf16, batches in (("program", False, ring), ("control", True, ring), ("half_batch", False, half)):
        step, net, opt = ts.program(cfg, train_state_dict(cfg["model"], seed, dev), dev, bf16=bf16)
        readings = ts.compare(ts.first_steps(step, net, opt, batches), ref, cfg["train"]["weight_decay"])
        out[name] = {k: v for k, v in readings.items() if k not in ("_losses", "_ref_losses", "_left_out")}
        del step, net, opt
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=3_000_000_001)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default="build/calibrate")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = bench_run.resolve(bench_run.HERE.parent, args.workload)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{args.workload}.jsonl", "a") as f:
        for i in range(args.seeds):
            seed = args.first + 7919 * i
            t0 = time.perf_counter()
            if cell["traffic"]["driver"] == "train_step":
                row = train_seed(cell, seed)
            else:
                row = infer_seed(cell, seed, args.seconds)
            row.update(seed=seed, seconds=time.perf_counter() - t0, card=bench_run.power_limit())
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
