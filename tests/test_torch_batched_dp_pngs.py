"""Port parity for the CLI over a mesh on the CPU: ``--bank-shards`` /
``--dp-shards`` on a virtual CPU mesh against the port's unsharded runs, for
all seven strategies and probability mode, and
``strategies.inference_single_sharded``."""

import numpy as np
import pytest
import torch
from PIL import Image

from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig
from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_batched_dp_cli import STRATEGIES, _run, davis_and_ckpt, one_compute_thread  # noqa: F401


@pytest.fixture(scope="module")
def unsharded(davis_and_ckpt, tmp_path_factory):
    """Each strategy's PNGs from the port's unsharded run, one video at a
    time, made once."""
    root, ckpt = davis_and_ckpt
    out = {}
    for strategy, flags in STRATEGIES.items():
        save = tmp_path_factory.mktemp(f"unsharded_{strategy}")
        res = _run(root, ckpt, save, *flags)
        assert res.exit_code == 0, res.output
        out[strategy] = {p.relative_to(save): p.read_bytes() for p in sorted(save.rglob("*.png"))}
    return out


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("mesh_flags", [["--bank-shards", "2"],
                                        ["--video-batch", "4", "--dp-shards", "2", "--bank-shards", "2"]],
                         ids=["bank2", "vb4-dp2-bank2"])
def test_cli_mesh_pngs_equal_unsharded(davis_and_ckpt, unsharded, tmp_path, strategy, mesh_flags):
    """``--device cpu`` on a virtual mesh (the CPU named 2 or 4 times):
    every strategy's PNGs, and probability mode's, byte-identical to the
    port's unsharded run (3 videos: the lockstep group of 4 pads to whole
    videos per data row)."""
    root, ckpt = davis_and_ckpt
    res = _run(root, ckpt, tmp_path, *STRATEGIES[strategy], *mesh_flags)
    assert res.exit_code == 0, res.output
    got = {p.relative_to(tmp_path): p.read_bytes() for p in sorted(tmp_path.rglob("*.png"))}
    expect = unsharded[strategy]
    assert len(expect) == 15 and got.keys() == expect.keys()
    assert got == expect
    classes = set()
    for rel in got:
        classes.update(np.unique(np.asarray(Image.open(tmp_path / rel))).tolist())
    assert classes == {0, 1, 2}


def test_inference_single_sharded_is_single_with_a_mesh(davis_and_ckpt, unsharded, tmp_path):
    """``strategies.inference_single_sharded``, the JAX package's alias, on
    a 3-shard CPU mesh writes the unsharded run's PNGs."""
    from semi_supervised_vos_tpu_torch.data.davis import InferenceDataset
    from semi_supervised_vos_tpu_torch.infer import strategies
    from semi_supervised_vos_tpu_torch.models.convert import load_torch_checkpoint
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    root, ckpt = davis_and_ckpt
    net = load_torch_checkpoint(ckpt, VOSNet("resnet18"))
    dataset = InferenceDataset(str(root / "JPEGImages" / "480p"), inference_strategy="single")
    mesh = make_mesh(1, 3, devices=[torch.device("cpu")] * 3)
    strategies.inference_single_sharded(dataset, root / "Annotations" / "480p", tmp_path, net, EngineConfig(), mesh)
    got = {p.relative_to(tmp_path): p.read_bytes() for p in sorted(tmp_path.rglob("*.png"))}
    assert got == unsharded["single"]

