"""The lockstep lane envelope's anchors: device memory of one chunk at the
lane cap (``infer/batched.py::_hbm_lanes_cap``) for each network and
compute dtype, at 480p and 1080p.

    python3 prof_torch/lane_caps.py [float32|bfloat16 ...]

Builds the 480p lockstep tree of ``chip_smoke.py`` phase 10 and the random
calibrated resnet50 and facebook networks, then runs
``chip_smoke.py::lockstep_memory`` (the phase 10d / 12d / 14e method:
``start_videos`` plus one 8-step chunk at the cap, peak
``max_memory_allocated``) for every network at each dtype named (default
float32). Prints, per case, the GB a lane at the cap, the peak share of the
card, and the lanes that would fill 70 % of it (the anchors' aim); a JSON
line last. Needs one NVIDIA card.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dtypes = argv or ["float32"]
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        work = Path(tmp)
        cs.make_davis_tree(work / "lockstep", {"v0": 17}, (cs.H480, cs.W480), seed=3)
        frames = cs.load_video(work, "lockstep", "v0", 4)[0]
        total = torch.cuda.get_device_properties(0).total_memory
        for arch in ("resnet50", "facebook"):
            net = cs.calibrated_vosnet(torch, dev, 0, frames, arch)
            for name in dtypes:
                mem = cs.lockstep_memory(torch, dev, net, work, slopes=False, dtype=getattr(torch, name))
                for res, r in mem.items():
                    if res == "total_bytes":
                        continue
                    aim = int(0.70 * total // r["cap_bytes_per_lane"])
                    print(f"{arch} {name} {res}: {r['cap_bytes_per_lane'] / 1e9:.4f} GB a lane at the cap of "
                          f"{r['cap_lanes']} lanes, peak {r['cap_share']:.4f} of the card; 70 % of the card is "
                          f"{aim} lanes", flush=True)
                    out[f"{arch} {name} {res}"] = dict(r, lanes_at_70=aim)
            del net
            torch.cuda.empty_cache()
    print(json.dumps({"lane_caps": out, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
