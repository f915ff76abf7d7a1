"""A dry run of every multi-device path on a given list of devices: the
port's counterpart of the JAX package's ``__graft_entry__.py::
dryrun_multichip``.

The device list may repeat a device (``[cuda:0] * 4`` drives the mesh code
on one card, ``[cpu] * 8`` plays the JAX tests' 8 virtual devices). On CUDA
devices the sharded engines run the bank-affinity kernel in stats mode, one
launch a shard; on the CPU its plain version.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _clips(rng, b: int, t: int = 3, size: int = 32):
    imgs = rng.integers(0, 255, (b, t, size, size, 3)).astype(np.uint8)
    anns = np.zeros((b, t, size, size, 3), np.uint8)
    anns[:, :, 8:20, 8:20] = [128, 0, 0]
    return imgs, anns


def _train_net(dev: torch.device):
    from semi_supervised_vos_tpu_torch.models.resnet import init_train_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet("resnet50")
    init_train_weights(net, torch.Generator().manual_seed(0))
    return net.to(dev).train()


def dryrun_multichip(devices: Sequence[torch.device]) -> dict:
    """Over ``devices`` (n of them): one data-parallel resnet50 train step
    (n data rows, one 32² clip of 3 frames each); one data × model step on
    an (n // min(4, n)) × min(4, n) mesh; ``sharded_affinity_propagate``
    over an n-device model axis against the unsharded propagation; the
    bank-sharded engine against the single engine (masks agree on > 99 %
    of pixels); the data-parallel lockstep engine on n + 1 videos (a padded
    row); and the 2-D lockstep mesh. Asserts finite losses, finite outputs
    of the expected shapes and the agreements; returns what it measured."""
    from semi_supervised_vos_tpu_torch.core.propagation import affinity_propagate
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.parallel.batched_dp import DataParallelBatchedEngine
    from semi_supervised_vos_tpu_torch.parallel.engine_sharded import ShardedPropagationEngine
    from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from semi_supervised_vos_tpu_torch.parallel.sharded_affinity import sharded_affinity_propagate
    from semi_supervised_vos_tpu_torch.parallel.tp import shard_tp
    from semi_supervised_vos_tpu_torch.parallel.train_mesh import MeshNet, make_mesh_train_step
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    devices = [torch.device(d) for d in devices]
    n, dev = len(devices), devices[0]
    rng = np.random.default_rng(0)
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32, device=dev)
    spec = LossSpec(name="cross_entropy")

    # data-parallel train step: BatchNorm over the global batch, one SGD step
    mesh = make_mesh(n, 1, devices)
    net = _train_net(dev)
    step = make_mesh_train_step(MeshNet(mesh, net, make_optimizer(net.parameters(), base_lr=0.01)), spec)
    imgs, anns = _clips(rng, n)
    loss = float(step(*shard_batch(mesh, imgs, anns), centroids, torch.Generator(device=dev).manual_seed(1)))
    assert np.isfinite(loss), loss

    # channel sharding composed with data parallelism
    mesh_tp = make_mesh(max(n // 4, 1), min(4, n), devices)
    net_tp = _train_net(dev)
    mnet_tp = shard_tp(mesh_tp, net_tp, make_optimizer(net_tp.parameters(), base_lr=0.01))
    step_tp = make_mesh_train_step(mnet_tp, spec)
    b_tp = mesh_tp.shape["data"]
    loss_tp = float(step_tp(*shard_batch(mesh_tp, imgs[:b_tp], anns[:b_tp]), centroids,
                            torch.Generator(device=dev).manual_seed(1)))
    assert np.isfinite(loss_tp), loss_tp

    # the memory bank sharded over the model axis
    mesh_sp = make_mesh(1, n, devices)
    k, p, c, d = 2 * n, 24, 16, 22
    ref = torch.as_tensor(rng.standard_normal((k, p, c)), dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(rng.standard_normal((p, c)), dtype=torch.float32, device=dev)
    lab = torch.as_tensor(rng.random((k, p, d)) < 0.1, dtype=torch.float32, device=dev)
    out = sharded_affinity_propagate(mesh_sp, ref, tgt, lab, temperature=1.0)
    expect = affinity_propagate(ref, tgt, lab, temperature=1.0)
    assert torch.isfinite(out).all()
    affinity_err = float((out.to(dev) - expect).abs().max())
    assert affinity_err < 1e-4, affinity_err

    # the bank-sharded engine (stats-mode kernel per shard on the card)
    cfg = EngineConfig()
    h = w = 48
    frames = rng.integers(0, 255, (3, h, w, 3)).astype(np.uint8)
    label0 = np.zeros((h, w), np.int32)
    label0[10:30, 10:30] = 1
    engine = ShardedPropagationEngine(net, (h, w), cfg, mesh_sp)
    masks, _ = engine.step_chunk_small(frames[1:], engine.start_video(frames[0], label0), 1)
    assert tuple(masks.shape) == (2, engine.hd, engine.wd), masks.shape
    single = PropagationEngine(net, (h, w), cfg, dev)
    single_masks, _ = single.step_chunk_small(frames[1:], single.start_video(frames[0], label0), 1)
    kernel_agree = float((masks.cpu() == single_masks.cpu()).float().mean())
    assert kernel_agree > 0.99, kernel_agree

    # data-parallel lockstep: n + 1 videos pad a row
    bvids = n + 1
    bframes = rng.integers(0, 255, (3, bvids, h, w, 3)).astype(np.uint8)
    blabels = np.zeros((bvids, h, w), np.int32)
    blabels[:, 10:30, 10:30] = 1
    dp = DataParallelBatchedEngine(net, (h, w), bvids, cfg, make_mesh(n, 1, devices))
    dp_masks, _ = dp.step_chunk_small(bframes[1:], dp.start_videos(bframes[0], blabels), 1)
    assert tuple(dp_masks.shape) == (2, bvids, dp.hd, dp.wd), dp_masks.shape

    # the 2-D lockstep mesh: lanes over data, bank rows over model
    vids_2d = mesh_tp.shape["data"] * 2
    eng_2d = DataParallelBatchedEngine(net, (h, w), vids_2d, cfg, mesh_tp)
    m_2d, _ = eng_2d.step_chunk_small(bframes[1:, :vids_2d], eng_2d.start_videos(bframes[0, :vids_2d],
                                                                                  blabels[:vids_2d]), 1)
    assert tuple(m_2d.shape) == (2, vids_2d, eng_2d.hd, eng_2d.wd), m_2d.shape

    result = dict(loss=loss, loss_tp=loss_tp, mesh_tp=(mesh_tp.shape["data"], mesh_tp.shape["model"]),
                  affinity_max_abs=affinity_err, kernel_agree=kernel_agree, dp_videos=bvids, masks_2d=vids_2d)
    print(f"dryrun_multichip({n}): train loss {loss:.4f}, dp{result['mesh_tp'][0]}xtp{result['mesh_tp'][1]} loss "
          f"{loss_tp:.4f}, sharded affinity max_abs {affinity_err:.2e}, {n}-shard engine agreement "
          f"{kernel_agree:.3f}, DP lockstep {bvids} videos over {n} rows, 2-D mesh lockstep {vids_2d} videos OK")
    return result
