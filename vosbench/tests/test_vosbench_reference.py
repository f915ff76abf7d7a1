"""The plain reference agrees with the port's CPU paths at a tiny size:
the network, the propagation, the schedule and the train step."""

import numpy as np
import pytest
import torch

from vosbench.reference import propagation, schedule, train, vosnet
from vosbench.weights import make_state_dict, train_state_dict


def port_net(arch, sd):
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet(arch)
    net.load_state_dict(sd)
    return net.eval()


@pytest.mark.parametrize("arch", ["resnet50", "facebook"])
def test_network_equals_the_ports_module(arch):
    torch.manual_seed(0)
    frames = torch.randint(0, 255, (2, 64, 80, 3), dtype=torch.uint8)
    sd = make_state_dict(arch, 5, "cpu")
    vosnet.calibrate_bn(sd, arch, vosnet.normalize(frames))
    with torch.no_grad():
        ref = vosnet.forward(sd, arch, vosnet.normalize(frames))
        got = port_net(arch, sd)(vosnet.normalize(frames))
    assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_schedule_equals_the_ports():
    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames

    for t in range(1, 200):
        ours, theirs = schedule.sample_frames(t, 40, 9), sample_frames(t, 40, 9)
        for a, b in zip(ours, theirs):
            assert np.array_equal(np.asarray(a), np.asarray(b)), t


@pytest.mark.parametrize("t", [3, 12, 50])
def test_scores_equal_the_ports_golden(t):
    from semi_supervised_vos_tpu_torch.core.propagation import affinity_propagate
    from semi_supervised_vos_tpu_torch.core.spatial import spatial_weight

    g = torch.Generator().manual_seed(t)
    hd, wd, c = 6, 9, 16
    idx, valid, dense = schedule.sample_frames(t, 40, 9)
    k = int(valid.sum())
    feats = torch.randn(k, hd * wd, c, generator=g)
    target = torch.randn(hd * wd, c, generator=g)
    labels = torch.randint(0, 3, (k, hd * wd), generator=g)
    ours = propagation.scores(feats, target, labels, valid, dense, (hd, wd), 8.0, 21.0, block=7)
    theirs = affinity_propagate(feats, target, torch.nn.functional.one_hot(labels, 22).float(), temperature=1.0,
                                dense=torch.as_tensor(dense[valid]),
                                weight_dense=spatial_weight((hd, wd), 8.0), weight_sparse=spatial_weight((hd, wd), 21.0))
    assert torch.allclose(ours, theirs, rtol=1e-5, atol=1e-6)


def test_preimage_reads_back_each_cell():
    for small, full in [(60, 480), (107, 854), (135, 1080), (240, 1920), (8, 64), (12, 96)]:
        assert np.array_equal(propagation.nearest_index(full, small)[propagation.preimage_index(small, full)],
                              np.arange(small))


def test_train_steps_equal_the_ports():
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec, make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    from vosbench import videos

    tr = {"bs": 2, "frames": 4, "crop": 64, "ring": 2, "objects": 2}
    ring = videos.make_train_ring(tr, 9, "cpu")
    sd = train_state_dict("resnet50", 9, "cpu")
    net = VOSNet("resnet50")
    net.load_state_dict(sd)
    net.train()
    opt = make_optimizer(net.parameters())
    step = make_train_step(net, LossSpec(), opt)
    cent = torch.as_tensor(davis_centroids(), dtype=torch.float32)
    port_losses = [float(step(*b, cent, torch.Generator().manual_seed(1))) for b in ring]
    leaves = {k: v.clone() for k, v in sd.items() if k in dict(net.named_parameters())}
    losses, _, _ = train.run_steps(leaves, "resnet50", ring)
    assert np.allclose(port_losses, losses, rtol=1e-4)
    for k, p in net.named_parameters():
        assert torch.allclose(p.detach(), leaves[k], rtol=1e-4, atol=1e-6), k
