"""The frozen counts equal the port's own counting
(``utils/benchmarking.py``, ``bench_train.py``) at 480p."""

import pytest
import torch

from vosbench import counts


@pytest.mark.parametrize("arch", ["resnet50", "facebook"])
def test_conv_flops_equal_the_ports_hooks(arch):
    from semi_supervised_vos_tpu_torch.utils import benchmarking as bm

    assert counts.conv_flops(arch, 480, 854) == bm.vosnet_frame_flops(arch, (480, 854))


def test_resnet50_480p_is_166_86_gflop():
    assert round(counts.conv_flops("resnet50", 480, 854) / 1e9, 2) == 166.86


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

    assert counts.train_step_flops("resnet50", 16, 10, 256) == step_flops("resnet50", 16, 10, 256)


def test_feature_grid_equals_the_ports():
    from semi_supervised_vos_tpu_torch.models.resnet import out_spatial

    for hw in [(480, 854), (1080, 1920), (64, 96), (255, 257)]:
        assert counts.feature_hw(*hw) == out_spatial(*hw)


def test_large_grid_near_count_matches_the_dense_count():
    inv = [1 / 64, 1 / 441]
    small = counts.affinity_work(9, 40 * 52, 52, 256, 22, inv)
    y = torch.arange(40 * 52, dtype=torch.float32) / 52
    dy2 = (y[:, None] - y[None, :]) ** 2
    near = sum(int((dy2 * s < 36.0).sum()) for s in torch.tensor(inv, dtype=torch.float32).tolist())
    assert small[1] == 2.0 * near * 22
