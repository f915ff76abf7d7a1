"""The flagship forward step: the port's counterpart of the JAX package's
``__graft_entry__.py::entry`` (its other function, ``dryrun_multichip``, is
``parallel/dryrun.py``).

    from semi_supervised_vos_tpu_torch.graft_entry import entry
    step, args = entry()          # on the card; entry("cpu") on the CPU
    mask = step(*args)            # (16, 16) int64 labels

The step is the inference hot path for one frame: a VOSNet resnet50 encode
of one 128² frame, then one propagation from a 45-slot bank (K 9 sampled
slots at frame 7, C 256, 22 classes), then the argmax. On the card the
propagation launches ``ops/affinity.py::affinity_propagate_fused`` (the
port of ``affinity_propagate_pallas``, on ``csrc/affinity_bank.cu``); on
the CPU it runs the plain ``core.propagation.affinity_propagate`` with the
dense Gaussian weights, as the JAX step does.
"""

from __future__ import annotations

import numpy as np
import torch

FRAME_HW = (128, 128)
REF_NUM, FRAME_RANGE, NUM_CLASSES, FEATURES = 9, 40, 22, 256
SIGMA_1, SIGMA_2 = 8.0, 21.0


def entry(device=None):
    """(forward_step, example_args) of the flagship forward step on
    ``device`` (default: the card, ``cuda``).

    ``forward_step(net, frame, bank_feats, bank_labels, frame_idx)`` takes
    the VOSNet, a (1, 128, 128, 3) float32 frame (NHWC, the JAX step's
    layout), a (45, P, 256) float32 bank, its (45, P, 22) labels and the
    frame's index, all on one device, and returns the (16, 16) argmax
    labels. The example arguments are a resnet50 with reference-style
    random weights (``torch.Generator`` seeded 0) and inputs drawn from
    ``numpy.random.default_rng(0)`` in the JAX step's order."""
    from semi_supervised_vos_tpu_torch.core.propagation import affinity_propagate
    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.core.spatial import spatial_weight
    from semi_supervised_vos_tpu_torch.models.resnet import init_weights, out_spatial
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
    from semi_supervised_vos_tpu_torch.ops.affinity import affinity_propagate_fused

    dev = torch.device("cuda" if device is None else device)
    h, w = FRAME_HW
    hd, wd = out_spatial(h, w)
    p = hd * wd

    net = VOSNet("resnet50")
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.eval().to(dev)

    def forward_step(net, frame, bank_feats, bank_labels, frame_idx):
        dev = frame.device
        idx, valid, dense = sample_frames(int(frame_idx), FRAME_RANGE, REF_NUM)
        sel = torch.as_tensor(idx, dtype=torch.long, device=dev)
        with torch.no_grad():
            target = net(frame.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(p, FEATURES)
            if dev.type == "cuda":
                pred = affinity_propagate_fused(bank_feats[sel], target, bank_labels[sel], feature_hw=(hd, wd),
                                                temperature=1.0, valid=valid, dense=dense, sigma_1=SIGMA_1,
                                                sigma_2=SIGMA_2)
            else:
                pred = affinity_propagate(
                    bank_feats[sel], target, bank_labels[sel], temperature=1.0,
                    valid=torch.as_tensor(valid, device=dev), dense=torch.as_tensor(dense, device=dev),
                    weight_dense=spatial_weight((hd, wd), SIGMA_1, device=dev),
                    weight_sparse=spatial_weight((hd, wd), SIGMA_2, device=dev),
                )
        return pred.argmax(0).reshape(hd, wd)

    rng = np.random.default_rng(0)
    cap = FRAME_RANGE + 5
    example_args = (
        net,
        torch.as_tensor(rng.standard_normal((1, h, w, 3)).astype(np.float32), device=dev),
        torch.as_tensor(rng.standard_normal((cap, p, FEATURES)).astype(np.float32), device=dev),
        torch.as_tensor((rng.random((cap, p, NUM_CLASSES)) < 0.1).astype(np.float32), device=dev),
        7,
    )
    return forward_step, example_args
