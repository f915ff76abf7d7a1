"""Port parity for the multi-stream strategies: the dataset's flip and
second-scale items equal the JAX package's, and ``python -m
semi_supervised_vos_tpu_torch inference --device cpu`` writes PNGs
byte-identical to the JAX CLI's for hor-flip and vert-flip in label mode.
The other strategies and probability mode are in the other
``tests/test_torch_strategies_*.py`` files (split so that ``--dist
loadfile`` spreads them over workers)."""

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from semi_supervised_vos_tpu_torch.__main__ import cli
from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD
from semi_supervised_vos_tpu_torch.models.convert import save_torch_checkpoint
from semi_supervised_vos_tpu_torch.models.resnet import BasicBlock, init_weights
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from tests.helpers import make_davis_dataset


def calibrated_resnet18(seed, frames_u8):
    """A random resnet18 whose features tell the objects apart: perturbed BN
    affine parameters, each residual branch's last BN scale cut to a tenth,
    and BN running statistics estimated on ``frames_u8`` (the recipe of
    ``chip_smoke.py``). With reference initialisation alone every pixel's
    feature points one way and every propagated mask is background."""
    net = VOSNet("resnet18")
    g = torch.Generator().manual_seed(seed)
    init_weights(net, g)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.weight.normal_(1.0, 0.1, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.reset_running_stats()
            m.momentum = None
        for m in net.modules():
            if isinstance(m, BasicBlock):
                m.bn2.weight.mul_(0.1)
        x = (torch.as_tensor(frames_u8).float() / 255.0 - torch.as_tensor(IMAGENET_MEAN)) / torch.as_tensor(IMAGENET_STD)
        net.train()(x.permute(0, 3, 1, 2))
    return net.eval()


def make_tree(root):
    """The 64x80, two-video, five-frame tree of ``tests/test_torch_cli.py``
    with two calibrated resnet18 checkpoints from different seeds (the
    reference's ``.pth.tar`` format, which both CLIs load)."""
    data = make_davis_dataset(root, videos=("blackswan", "camel"), frames=5, size=(64, 80), objects=2)
    frames = np.stack([img for video in data.values() for img, _ in video])
    ckpts = []
    for seed in (1, 2):
        ckpt = root / f"ckpt{seed}.pth.tar"
        save_torch_checkpoint(calibrated_resnet18(seed, frames), ckpt)
        ckpts.append(ckpt)
    return root, ckpts[0], ckpts[1]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("davis"))


def assert_cli_matches_jax(tree, tmp_path, monkeypatch, strategy, probability=False, fusion="mean", ref_num=9,
                           video_batch=1):
    """Run the JAX CLI and the port's CLI on the CPU with the same options
    (chunks of 3 frames, so a video spans a full and a padded chunk) and
    require byte-identical PNGs whose predictions carry both objects."""
    from semi_supervised_vos_tpu.cli.inference import inference_command_impl

    root, ckpt, ckpt2 = tree
    monkeypatch.setenv("SVOS_CHUNK", "3")
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    inference_command_impl(
        ref_num=ref_num, data=str(root), resume=str(ckpt), model="resnet18", temperature=1.0, frame_range=40,
        sigma_1=8.0, sigma_2=21.0, save=str(jax_out), device="cpu", inference_strategy=strategy,
        additional_resume=str(ckpt2), additional_model_type="resnet18", probability_propagation=probability,
        scale=1.15, reduction=fusion, disable=True, video_batch=video_batch,
    )
    args = [
        "inference", "-d", str(root), "-r", str(ckpt), "-m", "resnet18", "-s", str(port_out), "--device", "cpu",
        "-n", str(ref_num), "--inference-strategy", strategy, "--additional-model", str(ckpt2),
        "--additional-model-type", "resnet18", "--fusion", fusion, "--video-batch", str(video_batch),
    ] + (["--probability"] if probability else [])
    res = CliRunner().invoke(cli, args)
    assert res.exit_code == 0, res.output
    jax_pngs = sorted(p.relative_to(jax_out) for p in jax_out.rglob("*.png"))
    assert jax_pngs == sorted(p.relative_to(port_out) for p in port_out.rglob("*.png"))
    assert len(jax_pngs) == 10
    classes = set()
    for rel in jax_pngs:
        assert (port_out / rel).read_bytes() == (jax_out / rel).read_bytes(), rel
        if rel.name != "00000.png":
            classes.update(np.unique(np.asarray(Image.open(port_out / rel))).tolist())
    assert classes == {0, 1, 2}


@pytest.mark.parametrize("strategy", ["hor-flip", "vert-flip"])
def test_label_strategy_pngs_byte_identical_to_jax(tree, tmp_path, monkeypatch, strategy):
    assert_cli_matches_jax(tree, tmp_path, monkeypatch, strategy)


@pytest.mark.parametrize("strategy", ["single", "hor-flip", "vert-flip", "2-scale", "hor-2-scale"])
def test_dataset_items_match_jax(tree, strategy):
    from semi_supervised_vos_tpu.data.davis import InferenceDataset as JDataset
    from semi_supervised_vos_tpu_torch.data.davis import InferenceDataset

    img_root = str(tree[0] / "JPEGImages" / "480p")
    port, ref = InferenceDataset(img_root, strategy, 1.15), JDataset(img_root, strategy, 1.15)
    assert len(port) == len(ref) == 10
    for i in (0, 7):
        (got, v_got), (expect, v_expect) = port[i], ref[i]
        assert v_got == v_expect
        got, expect = (got, expect) if strategy != "single" else ((got,), (expect,))
        for g, e in zip(got, expect, strict=True):
            assert g.dtype == e.dtype == np.uint8 and g.shape == e.shape
            np.testing.assert_array_equal(g, e)
    if strategy.endswith("2-scale"):
        assert port[0][0][1].shape == (74, 92, 3)  # ceil(64 * 1.15), ceil(80 * 1.15)
