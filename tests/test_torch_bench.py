"""The port's inference bench (``semi_supervised_vos_tpu_torch/bench.py``)
against the JAX package's (``bench.py`` at the root, imported by path), on
the CPU:

  * ``make_video`` gives the same bytes for the same generator state;
  * the timed runs time the real computation: at 64x96, 17 frames and
    resnet18 (weights carried across by ``state_dict_from_jax``, float32),
    the full-resolution masks that the port's ``run_single`` /
    ``run_batched`` drain equal, byte for byte, the masks that the JAX
    engines give through the JAX bench's own runners over the same chunk
    schedule; the resident variant (frames as a tensor) gives them too;
  * ``--device cpu`` prints a line whose times, rates and ``mfu`` are null,
    with the checks and counts filled in;
  * ``gflop_per_frame`` is a frame's convolutions and affinity op, worked
    out by hand for resnet18 at 64x96;
  * without a card the default device exits non-zero and prints no value.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.infer.batched import BatchedPropagationEngine as JBatchedEngine
from semi_supervised_vos_tpu.infer.engine import EngineConfig as JConfig
from semi_supervised_vos_tpu.infer.engine import PropagationEngine as JEngine
from semi_supervised_vos_tpu_torch import bench
from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.utils import benchmarking as bm
from tests.test_torch_models import jax_variables, port_net

REPO = Path(__file__).resolve().parent.parent
H, W, N_FRAMES = 64, 96, 17
SMALL = bench.Protocol(res="64x96", hw=(H, W), frames=16, chunk=8, passes=1, batch=2, arch="resnet18",
                       train_shape=(2, 3, 64), hw_1080=(72, 128), frames_1080=8, batch_1080=2, check_hw=(H, W))


def load_root(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jbench():
    return load_root("bench")


@pytest.fixture(scope="module")
def nets():
    jnet, variables = jax_variables("resnet18", 5)
    return jnet, variables, port_net("resnet18", variables)


def two_objects(lanes=None):
    shape = (H, W) if lanes is None else (lanes, H, W)
    label = np.zeros(shape, np.int32)
    label[..., 8:40, 10:50] = 1
    label[..., 44:60, 60:90] = 2
    return label


def jax_masks(jbench, monkeypatch, run, *args):
    """The masks the JAX bench's runner drains (its ``_pipelined_masks``
    output), at this test's frame size."""
    monkeypatch.setattr(jbench, "H", H)
    monkeypatch.setattr(jbench, "W", W)
    monkeypatch.setattr(jbench, "CHUNK", 8)
    captured = []
    drain = jbench._pipelined_masks

    def capture(chunks, hw_axes):
        captured.append(drain(chunks, hw_axes))
        return captured[-1]

    monkeypatch.setattr(jbench, "_pipelined_masks", capture)
    run(*args, n_frames=16)
    return np.concatenate(captured[-1])


def test_make_video_bytes(jbench):
    got = bench.make_video(np.random.default_rng(3), 4, H, W)
    want = jbench.make_video(np.random.default_rng(3), 4, H, W)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_single_stream_masks_equal_jax(jbench, nets, monkeypatch):
    jnet, variables, net = nets
    frames, _ = bench.make_video(np.random.default_rng(0), N_FRAMES, H, W)
    label0 = two_objects()
    jcfg = JConfig(compute_dtype=np.float32, matmul_precision="highest")
    want = jax_masks(jbench, monkeypatch, jbench.run_single, JEngine(jnet, variables, (H, W), jcfg), frames, label0)

    engine = PropagationEngine(net, (H, W), EngineConfig(), "cpu")
    fps, masks = bench.run_single(engine, frames, label0, 16, 8)
    got = np.concatenate(masks)
    assert fps > 0 and got.shape == want.shape == (16, H, W) and got.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert len(np.unique(got)) > 1  # an object survives 16 frames

    # frames as a tensor (item 4 of the engine: encode reads it in place)
    _, resident = bench.run_single_resident(engine, torch.as_tensor(frames), label0, 16, 8)
    assert np.concatenate(resident).tobytes() == want.tobytes()


def test_batched_masks_equal_jax(jbench, nets, monkeypatch):
    jnet, variables, net = nets
    rng = np.random.default_rng(1)
    frames_b = np.stack([bench.make_video(rng, N_FRAMES, H, W)[0] for _ in range(2)])
    labels = two_objects(lanes=2)
    labels[1] = labels[1][::-1]
    jcfg = JConfig(compute_dtype=np.float32, matmul_precision="highest")
    jengine = JBatchedEngine(jnet, variables, (H, W), 2, jcfg)
    want = jax_masks(jbench, monkeypatch, jbench.run_batched, jengine, frames_b, labels)

    engine = BatchedPropagationEngine(net, (H, W), 2, EngineConfig(), "cpu")
    rate, masks = bench.run_batched(engine, frames_b, labels, 16, 8)
    got = np.concatenate(masks)
    assert rate > 0 and got.shape == want.shape == (16, 2, H, W)
    assert got.tobytes() == want.tobytes()
    assert len(np.unique(got)) > 1

    chunks = bench.batched_chunks(frames_b, 16, 8, torch.device("cpu"))
    _, resident = bench.run_batched_resident(engine, chunks, frames_b[:, 0], labels, 16, 8)
    assert np.concatenate(resident).tobytes() == want.tobytes()


def resnet18_conv_flops(h: int, w: int) -> float:
    """resnet18's convolutions at stride 8, by hand: (output pixels, output
    channels, input channels, kernel side) of every conv."""
    s2, s4, s8 = (h // 2) * (w // 2), (h // 4) * (w // 4), (h // 8) * (w // 8)
    convs = [(s2, 64, 3, 7)]  # the stem
    convs += [(s4, 64, 64, 3)] * 4  # layer1
    convs += [(s8, 128, 64, 3), (s8, 128, 128, 3), (s8, 128, 64, 1)] + [(s8, 128, 128, 3)] * 2  # layer2, stride 2
    convs += [(s8, 256, 128, 3), (s8, 256, 256, 3), (s8, 256, 128, 1)] + [(s8, 256, 256, 3)] * 2  # layer3
    convs += [(s8, 256, 256, 3)] * 4  # layer4 (256 wide, no downsample)
    return sum(2.0 * px * cout * cin * k * k for px, cout, cin, k in convs)


def test_cpu_line_nulls_times_and_counts_by_hand(monkeypatch, capsys):
    monkeypatch.setattr(bench.Protocol, "from_env", classmethod(lambda cls: SMALL))
    bench.main.main(["--device", "cpu"], standalone_mode=False)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert out["value"] is None and out["mfu"] is None
    for key in ("device_resident_fps", "batched_fps", "batched_resident_fps", "single_stream_fps", "fps_1080p",
                "train_steps_per_sec_bs16_10f_256", "h2d_gb_s", "d2h_gb_s"):
        assert out[key] is None, key
    assert set(out["phase_ms"]) == {"backbone", "affinity", "full_step_device", "residual", "mask_d2h"}
    assert all(v is None for v in out["phase_ms"].values())
    assert set(out["strategy_fps"]) == {"single", "hor-flip", "ver-flip", "2-scale", "hor-2-scale", "3-scale",
                                        "multimodel"}
    assert all(v is None for v in out["strategy_fps"].values())
    assert out["device"]["platform"] == "cpu" and out["dtype"] == "float32"
    assert out["protocol"] == "16f x 1 passes, chunk 8, batch 2"

    # the checks ran: the plain versions against the float32 golden
    kc, sc = out["kernel_check"], out["sharded_kernel_check"]
    assert kc["max_abs_diff"] <= 1e-6 and kc["batched_max_abs_diff"] <= 1e-6 and sc["stats_max_abs_diff"] <= 1e-6
    assert kc["argmax_agreement"] == kc["batched_argmax_agreement"] == sc["stats_argmax_agreement"] == 1.0
    assert sc["engine_mask_agreement"] == sc["batched_engine_mask_agreement"] == 1.0
    assert kc["encoder_min_cos"] >= 0.99999

    # a 64x96 frame: its convolutions, then 9 slots of 2·P²·(C + D) for the
    # similarity and the label product (8 x 12 feature pixels: every pair is
    # within the prior's reach, so every pair takes the label product)
    p = (H // 8) * (W // 8)
    affinity = 9 * 2.0 * p * p * (256 + 22)
    assert out["gflop_per_frame"] == pytest.approx((resnet18_conv_flops(H, W) + affinity) / 1e9, rel=1e-12)
    assert bm.vosnet_frame_flops("resnet18", (H, W)) == resnet18_conv_flops(H, W)


def test_published_frame_counts():
    """resnet50 at the train crop and at 480p: the counts the bench's mfu
    uses (the JAX bench's docstring said 23.5 and 147 GFLOP)."""
    assert bm.vosnet_frame_flops("resnet50", (256, 256)) / 1e9 == pytest.approx(26.61, abs=0.01)
    assert bm.vosnet_frame_flops("resnet50", (480, 854)) / 1e9 == pytest.approx(166.86, abs=0.01)


def test_no_card_exits_nonzero_without_a_value():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device would run")
    proc = subprocess.run([sys.executable, "-m", "semi_supervised_vos_tpu_torch.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"value"' not in proc.stdout
