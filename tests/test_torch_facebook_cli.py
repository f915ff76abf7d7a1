"""Port CLI parity for the ``facebook`` model: ``python -m
semi_supervised_vos_tpu_torch inference --device cpu`` writes PNGs
byte-identical to the JAX CLI's with ``--model facebook`` and with
``multimodel`` whose second network is a facebook
(``--additional-model-type facebook``), one video at a time and at
``--video-batch 2``, on the two-video tree of
``tests/test_torch_strategies.py``. The facebook checkpoint is a calibrated
random network saved by the port, which the JAX CLI loads too."""

import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD
from semi_supervised_vos_tpu_torch.models.convert import save_torch_checkpoint
from semi_supervised_vos_tpu_torch.models.resnet import Bottleneck, init_weights
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from tests.test_torch_strategies import assert_cli_matches_jax, make_tree


def calibrated_facebook(seed, frames_u8):
    """The recipe of ``calibrated_resnet18`` (and of ``chip_smoke.py``) on a
    facebook network: perturbed BN affine parameters, each residual
    branch's last BN scale cut to a tenth, BN running statistics estimated
    on ``frames_u8``."""
    net = VOSNet("facebook")
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
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(0.1)
        x = (torch.as_tensor(frames_u8).float() / 255.0 - torch.as_tensor(IMAGENET_MEAN)) / torch.as_tensor(IMAGENET_STD)
        net.train()(x.permute(0, 3, 1, 2))
    return net.eval()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(root, facebook, facebook) for ``--model facebook`` and (root,
    resnet18, facebook) for multimodel."""
    from PIL import Image

    root, ckpt1, _ = make_tree(tmp_path_factory.mktemp("davis"))
    frames = np.stack([np.asarray(Image.open(p)) for p in sorted((root / "JPEGImages" / "480p").rglob("*.jpg"))])
    fb = root / "facebook.pth.tar"
    save_torch_checkpoint(calibrated_facebook(3, frames), fb)
    return {"single": (root, fb, fb), "multimodel": (root, ckpt1, fb)}


@pytest.mark.parametrize("video_batch", [1, 2])
def test_facebook_pngs_byte_identical_to_jax(trees, tmp_path, monkeypatch, video_batch):
    assert_cli_matches_jax(trees["single"], tmp_path, monkeypatch, "single", video_batch=video_batch,
                           model="facebook", additional_model_type="facebook")


@pytest.mark.parametrize("video_batch", [1, 2])
def test_multimodel_with_facebook_pngs_byte_identical_to_jax(trees, tmp_path, monkeypatch, video_batch):
    assert_cli_matches_jax(trees["multimodel"], tmp_path, monkeypatch, "multimodel", video_batch=video_batch,
                           model="resnet18", additional_model_type="facebook")
