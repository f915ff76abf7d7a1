"""The seeded weights are frozen: the family module of each configuration
file draws, for one seed, the state dicts that the harness drew for it
before the network code moved into ``vosbench/networks/`` (sha256 of every
key, dtype, shape and byte, in order). The inference weights are those
calibrated on the first frames of the tiny single-stream cell's pool (64 x
96), with one CPU thread: another thread count sums the calibration's
convolutions in another order."""

import hashlib

import numpy as np
import pytest
import torch

from conftest import TINY, config_of

SEED = 4294967311
FROZEN = {
    ("resnet50", "inference"): "1def1aab5cf99daf65d4d90e0926cf08b064fb3ffcac4b76798d86f2f02e41f4",
    ("resnet50", "train"): "a563feffefddc0549777295b577736a7475166778bc469b0e3cb02c115763afe",
    ("facebook", "inference"): "48c7f7504925c9d9d51af7732f345575a308f871cc4e8a1421ba58b9fd2d93b1",
    ("facebook", "train"): "b8c1e1609d96f08120695d047ab07fa622ef6d32247396df4100cacaf702b243",
}


def digest(sd) -> str:
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("config, kind", sorted(FROZEN))
def test_seeded_weights_are_frozen(one_thread, config, kind):
    from vosbench import videos

    cfg, network = config_of(config)
    if kind == "train":
        sd = network.train_weights(cfg, SEED, "cpu")
    else:
        pool = videos.make_pool(TINY["t-single"][2], SEED, "cpu")
        sd = network.inference_weights(cfg, SEED, torch.as_tensor(np.stack([v.frames[0] for v in pool[:4]])), "cpu")
    assert digest(sd) == FROZEN[config, kind]
