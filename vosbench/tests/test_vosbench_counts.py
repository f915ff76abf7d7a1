"""The frozen counts equal the port's own counting
(``utils/benchmarking.py``, ``bench_train.py``) at 480p, for each
configuration file through its network family's module."""

import pytest
import torch

from conftest import CONFIGS, config_of
from vosbench import counts


@pytest.mark.parametrize("config", CONFIGS)
def test_conv_flops_equal_the_ports_hooks(config):
    from semi_supervised_vos_tpu_torch.utils import benchmarking as bm

    cfg, network = config_of(config)
    assert network.frame_flops(cfg, 480, 854) == bm.vosnet_frame_flops(cfg["model"], (480, 854))


def test_resnet50_480p_is_166_86_gflop():
    cfg, network = config_of("resnet50")
    assert round(network.frame_flops(cfg, 480, 854) / 1e9, 2) == 166.86


@pytest.mark.parametrize("t", [10, 16, 50, 64])
def test_affinity_count_equals_the_ports(t):
    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops.affinity import slot_table
    from semi_supervised_vos_tpu_torch.utils import benchmarking as bm

    idx, valid, dense = sample_frames(t, 40, 9)
    _, inv, _ = slot_table(idx, valid, dense, 8.0, 21.0, True)
    sim, lab, exps = bm.affinity_work(len(idx), 60 * 107, 107, 256, 22, inv)
    assert counts.affinity_work(len(idx), 60 * 107, 107, 256, 22, inv) == (sim, lab, exps)
    # every slot is valid past frame 9, so the frozen per-frame count is the same work
    assert counts.propagation_flops(t, 60 * 107, 107, 256, 22, 9, 40, 8.0, 21.0) == sim + lab


def test_train_step_count_equals_bench_train():
    from semi_supervised_vos_tpu_torch.bench_train import step_flops

    cfg, network = config_of("resnet50")
    hd, wd = network.feature_hw(cfg, 256, 256)
    forward = network.train_forward_flops(cfg, 16 * 10, 256)
    assert counts.train_step_flops(forward, hd * wd, 16, 10) == step_flops("resnet50", 16, 10, 256)


@pytest.mark.parametrize("config", CONFIGS)
def test_feature_grid_equals_the_ports(config):
    from semi_supervised_vos_tpu_torch.models.resnet import out_spatial

    cfg, network = config_of(config)
    for hw in [(480, 854), (1080, 1920), (64, 96), (255, 257)]:
        assert network.feature_hw(cfg, *hw) == out_spatial(*hw)


def test_large_grid_near_count_matches_the_dense_count():
    inv = [1 / 64, 1 / 441]
    small = counts.affinity_work(9, 40 * 52, 52, 256, 22, inv)
    y = torch.arange(40 * 52, dtype=torch.float32) / 52
    dy2 = (y[:, None] - y[None, :]) ** 2
    near = sum(int((dy2 * s < 36.0).sum()) for s in torch.tensor(inv, dtype=torch.float32).tolist())
    assert small[1] == 2.0 * near * 22
