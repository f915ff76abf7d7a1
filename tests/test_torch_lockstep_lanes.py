"""The lockstep runner keeps a strategy's streams that share a network and a
resolution in one engine: hor-flip at ``--video-batch 2`` runs one engine of
four lanes (two videos x the frames and their mirror), so each lockstep step
is one propagation over all of them (on the card, one bank-kernel launch)."""

import math

from click.testing import CliRunner

from semi_supervised_vos_tpu_torch.__main__ import cli
from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
from tests.test_torch_strategies import make_tree


def test_hor_flip_lanes_share_one_propagation_per_step(tmp_path, monkeypatch):
    root, ckpt, _ = make_tree(tmp_path / "davis")  # two videos of five frames
    monkeypatch.setenv("SVOS_CHUNK", "3")
    lanes = []
    propagate = BatchedPropagationEngine._propagate

    def spy(self, targets, state, frame_idx):
        lanes.append(targets.shape[0])
        return propagate(self, targets, state, frame_idx)

    monkeypatch.setattr(BatchedPropagationEngine, "_propagate", spy)
    args = ["inference", "-d", str(root), "-r", str(ckpt), "-m", "resnet18", "-s", str(tmp_path / "out"),
            "--device", "cpu", "--inference-strategy", "hor-flip", "--video-batch", "2"]
    res = CliRunner().invoke(cli, args)
    assert res.exit_code == 0, res.output
    # frames 1..4 in lockstep chunks of 3, the last padded to a whole chunk
    assert lanes == [4] * (math.ceil(4 / 3) * 3)
    for video in ("blackswan", "camel"):
        assert len(list((tmp_path / "out" / video).glob("*.png"))) == 5
