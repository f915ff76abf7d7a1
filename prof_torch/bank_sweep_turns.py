"""The bf16 bank sweep of this checkout and of another, in turns.

    python3 prof_torch/bank_sweep_turns.py --parent DIR

DIR is a checkout of an earlier commit (for example unpacked with ``git
archive`` into ``_parent/``). Each turn is a child process (this script
with ``--one ROOT``) that imports ROOT's ``semi_supervised_vos_tpu_torch``,
builds its kernels under ROOT and times ``affinity_from_bank_batched`` on
the benchmark's shapes (K 9 slots of frame 50's schedule, C 256, 22
classes): 480p (60 x 107) at B = 1 and B = 8, the 1080p bank of
``r50-1080p-vb2`` (135 x 240, B = 2), probability mode (no prior) at 480p
B = 1, four stats shards of the 480p bank with the combine, and
``affinity_propagate_fused`` on a gathered 480p set; then the wide sweep
(C 768, DINO ViT-B/8's unit-norm features at its temperature 10): 480p at
B = 1 and B = 8, 1080p at B = 2, and two stats shards of the 480p bank with
the combine. Each time is the median of 20 CUDA-event timings after 3
warm-up calls; the 480p B = 1 outputs of both widths are also held against
the plain version (max_abs, argmax agreement). Turns: parent, change, change, parent. Prints the card's name and power limit, one line per turn, and a JSON line
last. Needs one NVIDIA Hopper card (a few minutes).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ("480p_b1", "480p_b8", "1080p_b2", "prob_480p_b1", "stats4_480p_b1", "fused_480p",
          "wide_480p_b1", "wide_480p_b8", "wide_1080p_b2", "wide_stats2_480p_b1")


def one(root: Path) -> dict:
    """The timings of checkout ``root``, in this process."""
    sys.path.insert(0, str(root))
    import torch

    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops import affinity as aff

    assert Path(aff.__file__).resolve().is_relative_to(root), f"{aff.__file__} is not under {root}"
    dev = torch.device("cuda")
    c, d, d_pad, cap, k = 256, 22, 24, 45, 9
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    gen = torch.Generator(device=dev).manual_seed(1)

    def bank(b, p):
        feats = (torch.randn((cap, b, p, c), generator=gen, device=dev) * 0.2).to(torch.bfloat16)
        labels = torch.nn.functional.one_hot(torch.randint(0, d, (cap, b, p), generator=gen, device=dev),
                                             d_pad).to(torch.bfloat16)
        tgt = (torch.randn((b, p, c), generator=gen, device=dev) * 0.2).to(torch.bfloat16).float()
        return feats, labels, tgt

    def time_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    out = {}
    for shape, (hd, wd, b) in (("480p_b1", (60, 107, 1)), ("480p_b8", (60, 107, 8)), ("1080p_b2", (135, 240, 2))):
        feats, labels, tgt = bank(b, hd * wd)
        kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
        run = lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)  # noqa: E731
        out[shape] = time_ms(run)
        if shape == "480p_b1":
            got = run()[0, :d]
            expect = aff.affinity_from_bank_plain(feats.float(), labels.float(), tgt, slots, **kw)[0, :d]
            out["max_abs_480p_b1"] = (got - expect).abs().max().item()
            out["agree_480p_b1"] = (got.argmax(0) == expect.argmax(0)).double().mean().item()
            out["prob_480p_b1"] = time_ms(lambda: aff.affinity_from_bank_batched(
                feats, labels, tgt, slots, spatial=False, **kw))
            p_loc = hd * wd // 4 + 1  # 1606, 1606, 1606, 1602 rows: the last shard ragged

            sliced = [(feats[:, :, s * p_loc:(s + 1) * p_loc].contiguous(),
                       labels[:, :, s * p_loc:(s + 1) * p_loc].contiguous()) for s in range(4)]
            feats_shards = [f[:, 0] for f, _ in sliced]
            labels_shards = [lab[:, 0] for _, lab in sliced]

            def shards():  # contiguous shards, as the sharded engine holds them
                parts = [aff.affinity_from_bank_stats(f, lab, tgt[0], slots, row_base=s * p_loc, **kw)
                         for s, (f, lab) in enumerate(zip(feats_shards, labels_shards))]
                m, l, acc = (torch.stack(x)[:, None] for x in zip(*parts))
                return aff.combine_partials(m.contiguous(), l.contiguous(), acc.contiguous())

            out["stats4_480p_b1"] = time_ms(shards)
            ref = feats[slots[: k], 0].float()
            lab = labels[slots[: k], 0, :, :d].float()
            out["fused_480p"] = time_ms(lambda: aff.affinity_propagate_fused(
                ref, tgt[0], lab, feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense))
        del feats, labels, tgt

    c = 768  # the wide sweep: unit-norm rows, as the ViT's, at its temperature
    for shape, (hd, wd, b) in (("wide_480p_b1", (60, 107, 1)), ("wide_480p_b8", (60, 107, 8)),
                               ("wide_1080p_b2", (135, 240, 2))):
        p = hd * wd
        feats = torch.nn.functional.normalize(torch.randn((cap, b, p, c), generator=gen, device=dev), dim=-1)
        labels = torch.nn.functional.one_hot(torch.randint(0, d, (cap, b, p), generator=gen, device=dev), d_pad)
        tgt = torch.nn.functional.normalize(torch.randn((b, p, c), generator=gen, device=dev), dim=-1)
        feats, labels, tgt = feats.to(torch.bfloat16), labels.to(torch.bfloat16), tgt.to(torch.bfloat16).float()
        kw = dict(feature_hw=(hd, wd), temperature=10.0, valid=valid, dense=dense)
        out[shape] = time_ms(lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw))
        if shape == "wide_480p_b1":
            got = aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)[0, :d]
            expect = aff.affinity_from_bank_plain(feats, labels.float(), tgt, slots, **kw)[0, :d]
            out["max_abs_wide_480p_b1"] = (got - expect).abs().max().item()
            out["agree_wide_480p_b1"] = (got.argmax(0) == expect.argmax(0)).double().mean().item()
            half = p // 2
            halves = [(feats[:, 0, s * half:(s + 1) * half].contiguous(),
                       labels[:, 0, s * half:(s + 1) * half].contiguous()) for s in range(2)]

            def wide_shards():
                parts = [aff.affinity_from_bank_stats(f, lab, tgt[0], slots, row_base=s * half, **kw)
                         for s, (f, lab) in enumerate(halves)]
                m, l, acc = (torch.stack(x)[:, None] for x in zip(*parts))
                return aff.combine_partials(m.contiguous(), l.contiguous(), acc.contiguous())

            out["wide_stats2_480p_b1"] = time_ms(wide_shards)
            del halves
        del feats, labels, tgt
    return out


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
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(f"{name}: failed\n{proc.stderr[-3000:]}", flush=True)
            turns.append(dict(name=name, error=proc.stderr[-3000:]))
            continue
        turn = dict(name=name, **json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{name}: " + ", ".join(f"{s} {turn[s]:.4f} ms" for s in SHAPES)
              + f"; 480p B=1 max_abs {turn['max_abs_480p_b1']:.3e}, argmax agreement {turn['agree_480p_b1']:.6f}"
              + f"; wide {turn['max_abs_wide_480p_b1']:.3e}, {turn['agree_wide_480p_b1']:.6f}", flush=True)
        turns.append(turn)
    print(json.dumps(dict(card=card, turns=turns)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
