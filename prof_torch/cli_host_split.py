"""Where the port's CLI spends its wall time on the card, at ``--video-batch
8`` and ``--video-batch 1``.

    python3 prof_torch/cli_host_split.py

Builds the 8-video 480p tree of ``chip_smoke.py`` phase 10 (17 and 12
frames, random calibrated resnet50 weights), then runs ``inference`` four
times in turns (1, 8, 8, 1) with wall-clock timers around the host work:
JPEG decode, PNG writes (both summed over their threads), checkpoint load,
dataset preload, the engines' construction (BN fold), the main thread's
encode and step calls (dispatch only: the card runs behind them) and its
wait for the mask drain. Prints one line per run and a JSON line last.
Needs one NVIDIA card.
"""

from __future__ import annotations

import collections
import functools
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from semi_supervised_vos_tpu_torch.data import davis
    from semi_supervised_vos_tpu_torch.infer import batched, drain, engine, strategies
    from semi_supervised_vos_tpu_torch.models import convert
    from semi_supervised_vos_tpu_torch.models.convert import save_torch_checkpoint
    from semi_supervised_vos_tpu_torch.ops import _build
    from semi_supervised_vos_tpu_torch.utils import image

    totals = collections.defaultdict(float)
    lock = threading.Lock()

    def timed(owner, name, key):
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    totals[key] += time.perf_counter() - t0

        setattr(owner, name, wrapper)

    for owner, name, key in (
        (davis, "decode_rgb", "jpeg decode (all threads)"),
        (image, "save_prediction", "png writes (all threads)"),
        (batched, "save_prediction", "png writes (all threads)"),
        (convert, "load_torch_checkpoint", "checkpoint load"),
        (davis.InferenceDataset, "__post_init__", "dataset preload"),
        (engine.PropagationEngine, "__init__", "engine construction"),
        (engine.PropagationEngine, "encode", "encode calls (dispatch)"),
        (engine.PropagationEngine, "_step", "step calls (dispatch)"),
        (drain.MaskDrain, "drain", "wait for the drain"),
        (strategies, "run_streams", "run_streams"),
        (batched, "_run_group", "_run_group"),
    ):
        timed(owner, name, key)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    _build.build()
    dev = torch.device("cuda")
    runs = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)
        videos = {f"v{i}": 17 if i % 2 == 0 else 12 for i in range(8)}
        cs.make_davis_tree(work / "lockstep", videos, (cs.H480, cs.W480), seed=3)
        frames, _ = cs.load_video(work, "lockstep", "v0", 4)
        save_torch_checkpoint(cs.calibrated_vosnet(torch, dev, 0, frames), work / "resnet50.pth.tar")
        n_frames = sum(videos.values())
        for i, vb in enumerate((1, 8, 8, 1)):
            totals.clear()
            args = ["inference", "-d", str(work / "lockstep"), "-r", str(work / "resnet50.pth.tar"),
                    "-s", str(work / f"out{i}"), "--video-batch", str(vb)]
            wall, _ = cs.cli_run(torch, args)
            split = dict(sorted(totals.items(), key=lambda kv: -kv[1]))
            runs.append(dict(video_batch=vb, seconds=wall, fps=n_frames / wall, split=split))
            print(f"--video-batch {vb}: {wall:.3f} s = {n_frames / wall:.3f} fps; "
                  + "; ".join(f"{k} {v:.3f} s" for k, v in split.items()), flush=True)
    print(card)
    print(json.dumps({"cli_host_split": runs, "frames": n_frames, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
