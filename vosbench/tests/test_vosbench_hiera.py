"""The cell added with SAM 2.1 Hiera-L, at a tiny size on the CPU: the
``hiera`` family (its counts by hand, its plain reference against the port's
module, its keys checked), a lockstep cell of a small Hiera run correct and
its float8 control not, its device readers silent on the CPU; and on the
card the control at the cell's own size."""

import json
import shutil

import pytest
import torch

from conftest import ROOT, make_tiny_root, run_cell
from vosbench.reference import layers

CELL = "sam2-hieral-480p-vb8"
# a small Hiera of SAM 2's layout with every mechanism: windows that pad,
# pooled transitions, one global block
TINY_HIERA = dict(embed_dim=16, num_heads=1, stages=[1, 2, 3, 2], window_spec=[4, 6, 4, 3], global_att_blocks=[4],
                  pos_embed_window=4, d_model=32, feature_dim=32)


def hiera_config(**change) -> dict:
    cfg = json.loads((ROOT / "vosbench" / "configs" / "sam2_hiera_l.json").read_text())
    cfg.update(change)
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark with a small-Hiera lockstep cell ``t-hiera`` (the
    tiny lockstep traffic, the Hiera cell's limits and metrics)."""
    torch.set_num_threads(2)
    root = make_tiny_root(tmp_path_factory.mktemp("hiera"))
    (root / "vosbench" / "configs" / "tiny_hiera.json").write_text(json.dumps(hiera_config(**TINY_HIERA)))
    shutil.copy(ROOT / "vosbench" / "limits" / f"{CELL}.json", root / "vosbench" / "limits" / "t-hiera.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_hiera", "source": "https://arxiv.org/abs/2408.00714",
                             "file": "vosbench/configs/tiny_hiera.json", "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "t-hiera", "config": "tiny_hiera", "traffic": "t-lock", "chips": 1,
                               "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("t-hiera")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_hiera_counts_at_480p():
    """2.99 TFLOP a 480p frame, stage by stage by hand: stage grids of
    103,680 / 25,920 / 6,480 / 1,620 tokens, 24·C²·T a block's products
    (qkv, proj, the 4× MLP), a transition's qkv and shortcut over the grid
    before it, 4·Lq·Lk·C a window's attention, 4·T²·C a global block's."""
    from vosbench import networks

    cfg = hiera_config()
    hiera = networks.of(cfg)
    assert hiera.feature_hw(cfg, 480, 854) == (60, 107) and hiera.stride4_grid(cfg, 480, 854) == (240, 432)
    t1, t2, t3, t4 = 240 * 432, 120 * 216, 60 * 108, 30 * 54

    def block(c, t):
        return 24.0 * c * c * t

    def transition(c, t, t_out, windows, lq, lk):
        co = 2 * c
        return 2.0 * t * c * 3 * co + 2.0 * t * c * co + 2.0 * co * co * t_out + 16.0 * co * co * t_out \
            + windows * 4.0 * lq * lk * co

    total = 2.0 * t1 * 144 * 3 * 49
    total += 2 * (block(144, t1) + 1620 * 4.0 * 64 * 64 * 144)
    total += transition(144, t1, t2, 1620, 16, 64)
    total += 5 * (block(288, t2) + 1620 * 4.0 * 16 * 16 * 288)
    total += transition(288, t2, t3, 1620, 4, 16)
    total += 35 * block(576, t3) + 32 * 28 * 4.0 * 256 * 256 * 576 + 3 * 4.0 * t3 * t3 * 576
    total += transition(576, t3, t4, 28, 64, 256)
    total += 3 * (block(1152, t4) + 28 * 4.0 * 64 * 64 * 1152)
    total += 2.0 * t3 * 576 * 256 + 2.0 * t4 * 1152 * 256
    assert hiera.frame_flops(cfg, 480, 854) == pytest.approx(total, rel=1e-12)
    assert round(total / 1e12, 2) == 2.99
    assert hiera.window_attention_call_bound(1620, 2, 64, 64, 72) == pytest.approx(
        max(4.0 * 1620 * 2 * 64 * 64 * 72 / 989e12, 2.0 * 1620 * 2 * 72 * 256 / 3.35e12,
            1620 * 2 * 64 * 64 / (16 * 132 * 1980e6)))


def test_hiera_reference_matches_the_port_and_the_control_departs():
    """The family's plain reference against the port's float32 module on
    the small Hiera (the same float32 products, 1e-5), and the float8
    control departing from it by far more than bf16 rounding does."""
    from vosbench import networks

    cfg = hiera_config(**TINY_HIERA)
    hiera = networks.of(cfg)
    frames = torch.randint(0, 255, (2, 36, 50, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    sd = hiera.inference_weights(cfg, 3, frames, "cpu")
    net = hiera.program_net(cfg, sd, "cpu")
    x = layers.normalize(frames)
    with layers.float32_exact():
        ref = hiera.forward(sd, cfg, x)
        ctl = hiera.forward(sd, cfg, x, round_to=torch.float8_e4m3fn)
        half = hiera.forward(sd, cfg, x, round_to=torch.bfloat16)
    with torch.no_grad():
        got = net(x)
    rel = lambda a: float((a - ref).norm() / ref.norm())  # noqa: E731
    assert ref.shape == (2, 32, 5, 7)
    assert rel(got) < 1e-5
    assert rel(ctl) > 10 * rel(half) > 0


def test_hiera_refuses_training_and_bad_keys():
    from vosbench import networks

    hiera = networks.of(hiera_config())
    for fn, args in ((hiera.train_weights, (hiera_config(), 1, "cpu")),
                     (hiera.train_forward_flops, (hiera_config(), 2, 64)), (hiera.parameter_keys, ({},))):
        with pytest.raises(NotImplementedError, match="inference only"):
            fn(*args)
    with pytest.raises(ValueError, match="feature_dim 768 is not d_model 256"):
        networks.of(hiera_config(feature_dim=768))
    bad = hiera_config()
    del bad["window_spec"]
    with pytest.raises(ValueError, match=r"needs the key\(s\) window_spec"):
        networks.of(bad)
    with pytest.raises(ValueError, match="pad_multiple 16"):
        networks.of(hiera_config(pad_multiple=16))


def test_a_hiera_lockstep_cell_runs_correct_and_its_control_does_not(root, capsys):
    from semi_supervised_vos_tpu_torch.utils import profiling
    from vosbench import run
    from vosbench.harness import Context

    line = run_cell(root, "t-hiera", capsys)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["frames_per_s.vb8"]["value"] > 0 and "chunk_p90_ms" in line["metrics"]
    profiling.reset()
    line = run_cell(root, "t-hiera", capsys, seconds=4.0, trace=1)
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["dispatch_ms_per_chunk.vb8"]["value"] > 0
    # the CPU engine encodes with the module and has no device: Hiera's
    # device readers and its span reader stay silent
    assert not any(n in line["metrics"] for n in ("attention_roofline.vb8", "vit_linear_roofline.vb8",
                                                   "window_attention_roofline.vb8", "hiera_window_ms_per_frame.vb8"))
    profiling.reset()
    # the float8 control in the program's place reads not correct
    cell = run.resolve(root, "t-hiera")
    driver = run.load_module(root / "vosbench" / "drivers" / "infer_stream.py", "hiera_control_driver")
    ctx = Context(workload="t-hiera", config=cell["config"], network=cell["network"], traffic=cell["traffic"],
                  seed=4294967311, seconds=1.0, trace=False, device=torch.device("cpu"), t_process=0.0, control=True)
    out = driver.run(ctx)
    assert run.correct_of(run.checks_of(out.readings, cell["limits"]))
    assert not run.correct_of(run.checks_of(out.control, cell["limits"])), out.control


@pytest.mark.cuda
def test_control_fails_a_limit_on_the_card(cuda_device):
    from vosbench import calibrate, run

    cell = run.resolve(ROOT, CELL)
    row = calibrate.infer_seed(cell, 3_141_592_653, 5.0)
    limits = cell["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items()), row["program"]
    assert any(row["control"][k] > v for k, v in limits.items()), row["control"]
