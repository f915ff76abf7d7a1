"""Every full bench of the port, one after another on the card, each in a
process of its own:

    python3 prof_torch/bench_all.py [name ...]

``bench_480`` (``python -m semi_supervised_vos_tpu_torch.bench``, the full
480p protocol with the strategy matrix, the train pin and the 1080p pin),
``bench_1080`` (the same with ``SVOS_BENCH_RES=1080``), ``train``
(``.bench_train``, bf16 autocast), ``input_pipeline`` and
``loss_families``; names on the command line run those only. Prints the
card's name and power limit, then each bench's JSON line prefixed by its
name, and writes each bench's stderr log and JSON line under
``chiprun_out/bench/``. Needs one NVIDIA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out" / "bench"
RUNS = {
    "bench_480": (["semi_supervised_vos_tpu_torch.bench"], {}),
    "bench_1080": (["semi_supervised_vos_tpu_torch.bench"], {"SVOS_BENCH_RES": "1080"}),
    "train": (["semi_supervised_vos_tpu_torch.bench_train"], {}),
    "input_pipeline": (["semi_supervised_vos_tpu_torch.bench_train", "--input-pipeline"], {}),
    "loss_families": (["semi_supervised_vos_tpu_torch.bench_train", "--loss-families"], {}),
}


def main(names) -> int:
    sys.path.insert(0, str(ROOT))
    from semi_supervised_vos_tpu_torch.utils.benchmarking import card_line

    OUT.mkdir(parents=True, exist_ok=True)
    print(card_line(), flush=True)
    failed = []
    for name in names or RUNS:
        args, env = RUNS[name]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env={**os.environ, **env},
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        (OUT / f"{name}.log").write_text(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            failed.append(name)
            print(f"{name}: exit {proc.returncode} after {seconds:.1f} s; stderr ends:\n{proc.stderr[-3000:]}",
                  flush=True)
            continue
        (OUT / f"{name}.json").write_text(lines[-1] + "\n")
        print(f"{name} ({seconds:.1f} s): {json.dumps(json.loads(lines[-1]))}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
