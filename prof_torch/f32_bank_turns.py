"""The float32 bank kernel of this checkout and of another, in turns.

    python3 prof_torch/f32_bank_turns.py --parent DIR

DIR is a checkout of an earlier commit (for example unpacked with ``git
archive``). Each turn is a child process (this script with ``--one ROOT``)
that imports ROOT's ``semi_supervised_vos_tpu_torch``, builds its kernels
under ROOT, runs ``affinity_from_bank_batched`` in float32 at hd 2 x wd 960
(or prints the error it raises there), and times it at 480p B = 1 (K 9,
C 256, 22 classes; median of 20 CUDA-event timings) on inputs from one
seed, with the sha256 of that output. Turns: parent, change, change,
parent. Prints the card's name and power limit, one line per turn, and a
JSON line last. Needs one NVIDIA Hopper card (about a minute).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one(root: Path) -> dict:
    """The turn of checkout ``root``, in this process."""
    sys.path.insert(0, str(root))
    import torch

    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops import affinity as aff

    assert Path(aff.__file__).resolve().is_relative_to(root), f"{aff.__file__} is not under {root}"
    dev = torch.device("cuda")
    c, d_pad, cap, k = 256, 24, 45, 9
    idx, valid, dense = sample_frames(50, 40, k)
    gen = torch.Generator(device=dev).manual_seed(1)

    def make(hd, wd):
        p = hd * wd
        feats = torch.randn((cap, 1, p, c), generator=gen, device=dev) * 0.2
        labels = torch.nn.functional.one_hot(torch.randint(0, 22, (cap, 1, p), generator=gen, device=dev),
                                             d_pad).to(torch.bfloat16)
        tgt = torch.randn((1, p, c), generator=gen, device=dev) * 0.2
        return lambda: aff.affinity_from_bank_batched(feats, labels, tgt, idx % cap, feature_hw=(hd, wd),
                                                      temperature=1.0, valid=valid, dense=dense)

    try:
        make(2, 960)()
        wide = "ran"
    except RuntimeError as err:
        wide = str(err)
    run = make(60, 107)
    out = run()
    for _ in range(3):
        run()
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return dict(wide=wide, ms=sorted(times)[len(times) // 2],
                sha256=hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one(args.one.resolve())))
        return 0
    if args.parent is None:
        ap.error("--parent DIR is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    turns = []
    for name, root in (("parent", args.parent), ("change", ROOT), ("change", ROOT), ("parent", args.parent)):
        out = subprocess.run([sys.executable, __file__, "--one", str(root)], capture_output=True, text=True,
                             check=True, timeout=900).stdout
        turn = dict(name=name, **json.loads(out.strip().splitlines()[-1]))
        print(f"{name}: 480p B=1 {turn['ms']:.4f} ms, output sha256 {turn['sha256'][:16]}; hd 2 x wd 960: "
              f"{turn['wide']}", flush=True)
        turns.append(turn)
    bit_equal = len({t["sha256"] for t in turns}) == 1
    print(f"480p outputs bit-equal across the builds: {bit_equal}", flush=True)
    print(json.dumps(dict(card=card, turns=turns, bit_equal=bit_equal)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
