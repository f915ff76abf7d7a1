"""Port parity for the lockstep engine, continued from
``tests/test_torch_batched.py``: the rest of the strategies at
``--video-batch 2``, and a tree whose groups are uneven: videos of unequal
length (the padded tail), ``--video-batch 3`` over four videos of one size
(a full and a partial group) and a second frame size (a second group). The
port's PNGs equal the JAX CLI's byte for byte and the port's own
``--video-batch 1`` masks."""

import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

from semi_supervised_vos_tpu_torch.__main__ import cli
from semi_supervised_vos_tpu_torch.models.convert import save_torch_checkpoint
from tests.helpers import make_davis_dataset
from tests.test_torch_strategies import assert_cli_matches_jax, calibrated_resnet18, make_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("davis"))


@pytest.mark.parametrize(
    "strategy,probability,fusion",
    [("hor-2-scale", True, "maximum"), ("multimodel", False, "mean"), ("multimodel", True, "minimum"),
     ("3-scale", False, "mean")],
)
def test_video_batch_pngs_byte_identical_to_jax(tree, tmp_path, monkeypatch, strategy, probability, fusion):
    assert_cli_matches_jax(tree, tmp_path, monkeypatch, strategy, probability, fusion, video_batch=2)


# video -> (frames, size): four 64x80 videos of 3 to 6 frames, two 48x64 ones
UNEVEN = {"a": (6, (64, 80)), "b": (4, (64, 80)), "c": (5, (64, 80)), "d": (3, (64, 80)),
          "e": (4, (48, 64)), "f": (5, (48, 64))}


@pytest.fixture(scope="module")
def uneven_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("uneven")
    frames = []
    for i, (video, (n, size)) in enumerate(UNEVEN.items()):
        data = make_davis_dataset(root, videos=(video,), frames=n, size=size, objects=2, seed=i)
        frames += [img for img, _ in data[video] if img.shape[:2] == (64, 80)]
    ckpt = root / "ckpt.pth.tar"
    save_torch_checkpoint(calibrated_resnet18(1, np.stack(frames)), ckpt)
    return root, ckpt


@pytest.mark.parametrize("strategy", ["single", "hor-flip"])
def test_uneven_groups_match_jax_and_one_video_at_a_time(uneven_tree, tmp_path, monkeypatch, strategy):
    from semi_supervised_vos_tpu.cli.inference import inference_command_impl

    root, ckpt = uneven_tree
    monkeypatch.setenv("SVOS_CHUNK", "3")
    inference_command_impl(
        ref_num=9, data=str(root), resume=str(ckpt), model="resnet18", temperature=1.0, frame_range=40,
        sigma_1=8.0, sigma_2=21.0, save=str(tmp_path / "jax"), device="cpu", inference_strategy=strategy,
        additional_resume=None, additional_model_type="resnet18", probability_propagation=False, scale=1.15,
        reduction="mean", disable=True, video_batch=3,
    )
    for vb in (3, 1):
        args = ["inference", "-d", str(root), "-r", str(ckpt), "-m", "resnet18", "-s", str(tmp_path / f"vb{vb}"),
                "--device", "cpu", "--inference-strategy", strategy, "--video-batch", str(vb)]
        res = CliRunner().invoke(cli, args)
        assert res.exit_code == 0, res.output
    for video, (n, size) in UNEVEN.items():
        names = [f"{t:05d}.png" for t in range(n)]
        for out in ("jax", "vb3", "vb1"):
            assert sorted(p.name for p in (tmp_path / out / video).glob("*.png")) == names, (out, video)
        classes = set()
        for name in names:
            got = (tmp_path / "vb3" / video / name).read_bytes()
            assert got == (tmp_path / "jax" / video / name).read_bytes(), (video, name)
            assert got == (tmp_path / "vb1" / video / name).read_bytes(), (video, name)
            classes.update(np.unique(np.asarray(Image.open(tmp_path / "vb3" / video / name))).tolist())
        assert classes == {0, 1, 2}, video
