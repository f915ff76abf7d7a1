"""The two cells added with DINO ViT-B/8, at a tiny size on the CPU: the
``vit`` family (its counts, its plain reference against the port's module,
a lockstep cell of a small ViT run correct, its spans and counters) and the
``infer_disk`` driver (a DAVIS-layout tree written, decoded and run through
the CLI's path, its PNGs judged, its host spans read)."""

import json
import shutil

import pytest
import torch

from conftest import ROOT, make_tiny_root, run_cell
from vosbench.reference import layers

# a small ViT of DINO's layout, and the tiny cells standing for the new ones
TINY_VIT = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, mlp_hidden=256, feature_dim=64)
TINY_DISK = {"driver": "infer_disk", "hw": [64, 96], "video_batch": 1, "chunk": 4, "pool": 2, "lengths": [10, 14],
             "objects": 2, "jpeg_quality": 90, "judge": {"videos": 2, "frames": 3}}


def vit_config(**change) -> dict:
    cfg = json.loads((ROOT / "vosbench" / "configs" / "dino_vitb8.json").read_text())
    cfg.update(change)
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark with a small-ViT lockstep cell ``t-vit`` (the
    tiny lockstep traffic, the DINO cell's limits and metrics) and a disk
    cell ``t-disk`` (the single cell's limits and metrics, and the two
    host-io readers of ``infer_disk``, which no entry names yet)."""
    torch.set_num_threads(2)
    root = make_tiny_root(tmp_path_factory.mktemp("vit"))
    (root / "vosbench" / "configs" / "tiny_vit.json").write_text(json.dumps(vit_config(**TINY_VIT)))
    (root / "vosbench" / "traffic" / "t-disk.json").write_text(json.dumps(TINY_DISK))
    shutil.copy(ROOT / "vosbench" / "limits" / "dino-vitb8-480p-vb8.json", root / "vosbench" / "limits" / "t-vit.json")
    shutil.copy(ROOT / "vosbench" / "limits" / "r50-480p-single.json", root / "vosbench" / "limits" / "t-disk.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_vit", "source": "https://arxiv.org/abs/2104.14294",
                             "file": "vosbench/configs/tiny_vit.json", "reduced": [], "why": "tiny"})
    bench["workloads"] += [{"name": "t-vit", "config": "tiny_vit", "traffic": "t-lock", "chips": 1, "why": "tiny"},
                           {"name": "t-disk", "config": "resnet50", "traffic": "t-disk", "chips": 1, "why": "tiny"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for like, name in (("dino-vitb8-480p-vb8", "t-vit"), ("r50-480p-single", "t-disk")):
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    bench["per_layer"] += [{"name": name, "unit": "ms", "better": "lower", "source": "program_span", "layer": "host io",
                            "moves": "frames_per_s", "workloads": ["t-disk"]}
                           for name in ("decode_ms_per_frame", "png_ms_per_frame")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_vit_counts_at_480p():
    """2.61 TFLOP a 480p frame, 58 % of it attention (4·N²·768 a block over
    6,421 tokens), and the grid of the padded frame."""
    from vosbench import networks

    cfg = vit_config()
    vit = networks.of(cfg)
    assert vit.feature_hw(cfg, 480, 854) == (60, 107)
    total = vit.frame_flops(cfg, 480, 854)
    attention = 12 * 4.0 * 6421 ** 2 * 768
    assert round(total / 1e12, 2) == 2.61 and round(attention / total, 2) == 0.58
    assert vit.sdpa_call_bound(1, 12, 6421, 6421, 64) == pytest.approx(4.0 * 12 * 6421 ** 2 * 64 / 989e12)


def test_vit_refuses_training_and_bad_keys():
    from vosbench import networks

    vit = networks.of(vit_config())
    for fn, args in ((vit.train_weights, (vit_config(), 1, "cpu")), (vit.train_forward_flops, (vit_config(), 2, 64)),
                     (vit.parameter_keys, ({},))):
        with pytest.raises(NotImplementedError, match="inference only"):
            fn(*args)
    with pytest.raises(ValueError, match="feature_dim 256 is not embed_dim 768"):
        networks.of(vit_config(feature_dim=256))


def test_control_rounding_moves_the_vit_features():
    """The float8 control departs from the float32 reference by far more
    than bf16 rounding does (4.8 % relative at this size, against 0.39 %)."""
    from vosbench import networks

    cfg = vit_config(**TINY_VIT)
    vit = networks.of(cfg)
    frames = torch.randint(0, 255, (2, 32, 48, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    sd = vit.inference_weights(cfg, 3, frames, "cpu")
    with layers.float32_exact():
        ref = vit.forward(sd, cfg, layers.normalize(frames))
        ctl = vit.forward(sd, cfg, layers.normalize(frames), round_to=torch.float8_e4m3fn)
        half = vit.forward(sd, cfg, layers.normalize(frames), round_to=torch.bfloat16)
    rel = lambda a: float((a - ref).norm() / ref.norm())  # noqa: E731
    assert rel(ctl) > 10 * rel(half) > 0


def test_a_vit_lockstep_cell_runs_correct(root, capsys):
    from semi_supervised_vos_tpu_torch.utils import profiling

    line = run_cell(root, "t-vit", capsys)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["frames_per_s.vb8"]["value"] > 0 and "chunk_p90_ms" in line["metrics"]
    profiling.reset()
    line = run_cell(root, "t-vit", capsys, seconds=4.0, trace=1)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["dispatch_ms_per_chunk.vb8"]["value"] > 0
    # the CPU engine encodes with the module, not the card path, and has no
    # device: the ViT's device readers and its span reader stay silent
    assert not any(n in line["metrics"] for n in ("attention_roofline.vb8", "vit_linear_roofline.vb8",
                                                   "vit_mlp_ms_per_frame.vb8"))
    profiling.reset()


def test_a_disk_cell_runs_correct_and_reads_its_host_spans(root, capsys):
    from semi_supervised_vos_tpu_torch.utils import profiling
    from vosbench import run

    rc = run.main(["--workload", "t-disk", "--seed", "4294967311", "--seconds", "2", "--trace", "0"], root=root,
                  device="cpu")
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["metrics"]["frames_per_s"]["value"] > 0
    # each video of the window timed: video, frames, wall, decode, step, png
    detail = json.loads(next(t for t in out.err.splitlines() if t.startswith("detail: "))[len("detail: "):])
    rows = detail["videos"]
    assert sum(r[1] for r in rows) == line["attempted"]
    assert all(len(r) == 6 and r[2] > 0 and min(r[3:]) > 0 for r in rows)
    profiling.reset()
    line = run_cell(root, "t-disk", capsys, seconds=4.0, trace=1)
    assert line["correct"] is True, line["checks"]
    for name in ("decode_ms_per_frame", "png_ms_per_frame", "host_ms_per_frame", "upload_ms_per_chunk",
                 "dispatch_ms_per_chunk"):
        assert line["metrics"][name]["value"] > 0, name
    assert not (ROOT / "build" / "vosbench_disk").exists() or not any((ROOT / "build" / "vosbench_disk").iterdir())
    profiling.reset()
