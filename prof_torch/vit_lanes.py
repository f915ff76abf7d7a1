"""The lockstep lane envelope's anchors for a frozen embedder with a card
path of its own, ``dino_vitb8`` or ``sam2_hiera_l``
(``infer/batched.py::_hbm_lanes_cap``), and one 480p lockstep chunk timed.

    python3 prof_torch/vit_lanes.py [dino_vitb8 | sam2_hiera_l]

For 480p (480 x 854) and 1080p (1080 x 1920) it runs, as
``chip_smoke.py::lockstep_memory`` does, ``start_videos`` plus one 8-step
chunk of a ``BatchedPropagationEngine`` over the network (seeded weights:
the position tables and, for the ViT, the CLS token N(0, 0.02²), the rest at
PyTorch's default) with the lane cap set to the probe's lanes, so that an
encode call takes one step of every lane, as it does at the cap; the peak
``max_memory_allocated`` over the probe's lanes is the bytes a lane at the
cap, and 70 % of the card over it the anchor. Then the 480p B = 8 chunk of
the network's lockstep cell (64 lane-frames), timed by CUDA events after a
warm-up, and one 64-frame encode. Prints the card's name and power limit,
one line per case, and a JSON line last. Needs one NVIDIA Hopper card
(about a minute for the ViT, two for Hiera).
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROBES = (("480p", (480, 854), 24), ("1080p", (1080, 1920), 4))


def main(model: str = "dino_vitb8") -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from semi_supervised_vos_tpu_torch.infer import batched
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig
    from semi_supervised_vos_tpu_torch.models.vos_net import build_vos_net

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    torch.manual_seed(0)
    net = build_vos_net(model).to(dev).eval()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name in ("cls_token", "pos_embed", "trunk.pos_embed", "trunk.pos_embed_window"):
                p.normal_(0.0, 0.02)
    cfg = EngineConfig(temperature=10.0, feature_dim=net.feature_dim)
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"total_bytes": total}
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        work = Path(tmp)
        cs.make_davis_tree(work / "lockstep", {"v0": 9}, (cs.H480, cs.W480), seed=3)
        frames480, label480 = cs.load_video(work, "lockstep", "v0", 9)

        def clip(hw):
            ri = (np.arange(hw[0]) * cs.H480) // hw[0]
            ci = (np.arange(hw[1]) * cs.W480) // hw[1]
            return frames480[:, ri][:, :, ci], label480[ri][:, ci]

        for name, hw, b in PROBES:
            frames, label = clip(hw)
            lanes = np.ascontiguousarray(np.broadcast_to(frames[:, None], (frames.shape[0], b) + frames.shape[1:]))
            labels = np.ascontiguousarray(np.broadcast_to(label[None], (b,) + label.shape))
            saved = batched._hbm_lanes_cap
            batched._hbm_lanes_cap = lambda *a, b=b: b
            try:
                engine = batched.BatchedPropagationEngine(net, hw, b, cfg, dev)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                state = engine.start_videos(lanes[0], labels)
                masks, state = engine.step_chunk_small(lanes[1:], state, 1)
                torch.cuda.synchronize()
                used = torch.cuda.max_memory_allocated() - before
            finally:
                batched._hbm_lanes_cap = saved
            per_lane = used / b
            aim = int(0.70 * total // per_lane)
            print(f"{model} {name}: one chunk at {b} lanes (one step each per encode call) {used / 1e9:.4f} GB = "
                  f"{per_lane / 1e9:.4f} GB a lane; 70 % of the card is {aim} lanes; masks carry an object: "
                  f"{bool((masks.max() > 0).item())}", flush=True)
            out[name] = dict(probe_lanes=b, bytes=used, bytes_per_lane=per_lane, lanes_at_70=aim)
            del engine, state, masks
            torch.cuda.empty_cache()

        # the cell's chunk: 8 lanes x 8 steps at 480p
        b = 8
        lanes = np.ascontiguousarray(np.broadcast_to(frames480[:, None], (9, b) + frames480.shape[1:]))
        labels = np.ascontiguousarray(np.broadcast_to(label480[None], (b,) + label480.shape))
        engine = batched.BatchedPropagationEngine(net, (cs.H480, cs.W480), b, cfg, dev)
        state = engine.start_videos(lanes[0], labels)
        times = []
        for rep in range(4):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            masks, state = engine.step_chunk_small(lanes[1:], state, 1)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        feats = engine.encode(lanes[1])
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(3):
            engine.encode(lanes[1:].reshape((-1,) + lanes.shape[2:]))
        e1.record()
        torch.cuda.synchronize()
        enc = e0.elapsed_time(e1) / 3
        print(f"{model} 480p B=8 chunk (64 lane-frames): {times} ms; one 64-frame encode {enc:.2f} ms; "
              f"features {tuple(feats.shape)}, peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
        out["chunk_ms"] = times
        out["encode64_ms"] = enc
    print(json.dumps({"vit_lanes": out, "model": model, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
