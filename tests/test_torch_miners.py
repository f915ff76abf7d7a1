"""Port parity for the ten triplet miners: on the same embeddings and labels
the port and the JAX package mine the same (anchor, positive, negative)
triplets, for the distance-transform and skeleton miners in both mining
modes (the host path and the pipelined one). The budget is larger than the
number of candidate triplets, so neither side draws a random subset (JAX
keys and torch generators draw different numbers; the order of the
triplets may differ, the set may not). Also: the host annotation path
equals the device path, and the mode follows the device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.train import miners as jm
from semi_supervised_vos_tpu_torch.train import miners as tm

ALL_MINERS = [
    "default", "kernel_7x7", "temporal", "one_back_one_ahead",
    "euclidean", "manhattan", "chebyshev", "skeleton",
    "skeleton_nearest_negative", "skeleton_temporal",
]
MORPHOLOGY = ["euclidean", "manhattan", "chebyshev", "skeleton", "skeleton_nearest_negative", "skeleton_temporal"]


def _blob_labels(nprng, shape, n_classes=3):
    """Blobby labels: every class has coherent regions."""
    *lead, h, w = shape
    labels = np.zeros((int(np.prod(lead)), h, w), np.int64)
    for img in labels:
        for cls in range(1, n_classes):
            y, x = nprng.integers(0, h - 5), nprng.integers(0, w - 5)
            img[y : y + 5, x : x + 5] = cls
    return labels.reshape(shape)


def _inputs(name, seed=0):
    """Embeddings and labels shaped as the train step hands them to the miner."""
    nprng = np.random.default_rng(seed)
    if name in ("temporal", "one_back_one_ahead"):
        shape = (2, 5, 8, 8)
    elif name == "skeleton_temporal":
        shape = (2, 5 * 8, 8)  # five frames stacked into one tall image
    else:
        shape = (2, 14, 14)
    emb = nprng.standard_normal(shape + (8,)).astype(np.float32)
    return emb, _blob_labels(nprng, shape)


def _triplet_set(a, p, n, valid):
    """Per batch row, the set of valid gathered triplets (each embedding is a
    distinct random vector, so this is the set of index triplets)."""
    a, p, n, valid = (np.asarray(x) for x in (a, p, n, valid))
    out = []
    for bi in range(a.shape[0]):
        rows = {(a[bi, i].tobytes(), p[bi, i].tobytes(), n[bi, i].tobytes()) for i in range(a.shape[1]) if valid[bi, i]}
        assert len(rows) == int((valid[bi] > 0).sum())
        out.append(rows)
    return out


def _index_set(a, p, n, valid):
    a, p, n, valid = (np.asarray(x) for x in (a, p, n, valid))
    return [{(int(x), int(y), int(z)) for x, y, z, v in zip(a[bi], p[bi], n[bi], valid[bi]) if v > 0}
            for bi in range(a.shape[0])]


def test_registry_has_all_ten_names():
    for name in ALL_MINERS:
        assert type(tm.get_miner(name)).__name__ == type(jm.get_miner(name)).__name__, name
    assert tm.get_miner("nope") is None
    assert tm.get_miner("chebyshev").metric == "chessboard"
    assert tm.get_miner("skeleton_nearest_negative").metric == "manhattan"


@pytest.mark.parametrize("name", ALL_MINERS)
def test_host_path_triplets_match_jax(name):
    """The device miners (kernel, temporal) and the host path of the
    morphology miners."""
    emb, labels = _inputs(name)
    want = jm.get_miner(name).mine(jnp.asarray(emb), jnp.asarray(labels), None, jax.random.PRNGKey(0))
    got = tm.get_miner(name).mine(torch.as_tensor(emb), torch.as_tensor(labels), None, torch.Generator().manual_seed(0))
    want_set, got_set = _triplet_set(*want), _triplet_set(*(x.numpy() for x in got))
    assert got_set == want_set
    assert sum(map(len, got_set)) > 0


@pytest.mark.parametrize("name", MORPHOLOGY)
def test_pipelined_triplets_match_jax(name):
    """Host geometry, then the picks on the device, against the JAX
    package's pipelined mode; and the same set as the host path."""
    emb, labels = _inputs(name, seed=1)
    jminer, tminer = jm.get_miner(name), tm.get_miner(name)
    jgeom = jm.host_geometry(labels, jminer.mode, jminer.metric)
    tgeom = tm.host_geometry(labels, tminer.mode, tminer.metric)
    for a, b in zip(jgeom, tgeom):
        np.testing.assert_array_equal(a, b)
    want = jminer.mine_indices_from_geometry(jnp.asarray(emb), jnp.asarray(labels),
                                             tuple(jnp.asarray(g) for g in jgeom), jax.random.PRNGKey(0))
    got = tminer.mine_indices_from_geometry(torch.as_tensor(emb), torch.as_tensor(labels),
                                            tuple(torch.as_tensor(g) for g in tgeom), torch.Generator().manual_seed(3))
    got_set = _index_set(*got)
    assert got_set == _index_set(*want)
    assert sum(map(len, got_set)) > 0
    host = tm._host_morphology_mine(emb, labels, [5, 6], tminer.budget, tminer.mode, tminer.metric)
    assert _index_set(*host) == got_set


def test_skeletonize_matches_jax_pixel_for_pixel():
    """The port thins with a table lookup a sub-iteration, over a stack of
    masks at once; every skeleton equals the JAX package's Zhang-Suen."""
    from semi_supervised_vos_tpu.utils.morphology import skeletonize as jax_skeletonize
    from semi_supervised_vos_tpu_torch.utils.morphology import skeletonize, skeletonize_many

    nprng = np.random.default_rng(4)
    masks = []
    for i in range(60):
        if i % 3 == 0:  # noise of every density
            m = nprng.random((24, 20)) < nprng.random()
        elif i % 3 == 1:  # overlapping rectangles
            m = np.zeros((24, 20), bool)
            for _ in range(3):
                y, x = nprng.integers(0, 24), nprng.integers(0, 20)
                m[y : y + nprng.integers(1, 16), x : x + nprng.integers(1, 16)] = True
        else:  # a full frame and a disc
            yy, xx = np.mgrid[:24, :20]
            m = np.ones((24, 20), bool) if i % 2 else (yy - 12) ** 2 + (xx - 9) ** 2 < nprng.integers(4, 120)
        masks.append(m)
    want = np.stack([jax_skeletonize(m.astype(np.int32)) for m in masks])
    np.testing.assert_array_equal(skeletonize_many(np.stack(masks)), want)
    np.testing.assert_array_equal(skeletonize(masks[4]), want[4])
    assert want.sum() > 100


def test_budget_subsamples_on_the_device():
    """More candidates than the budget: a random subset of the right size,
    drawn from the generator (the same draw twice gives the same subset)."""
    emb, labels = _inputs("default")
    miner = tm.KernelMiner(kernel_size=3, stride=3, max_triplets=5)
    runs = [miner.mine(torch.as_tensor(emb), torch.as_tensor(labels), None, torch.Generator().manual_seed(9))
            for _ in range(2)]
    a, _, _, valid = runs[0]
    assert a.shape == (2, 5, 8) and valid.shape == (2, 5)
    assert torch.equal(runs[0][0], runs[1][0])


def test_host_ann_classes_match_device_and_jax():
    from semi_supervised_vos_tpu.train.loop import host_ann_classes as jax_host_ann_classes
    from semi_supervised_vos_tpu_torch.ops.onehot import color_to_class, davis_centroids
    from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize
    from semi_supervised_vos_tpu_torch.train.loop import host_ann_classes

    nprng = np.random.default_rng(2)
    anns = nprng.integers(0, 255, (2, 3, 64, 80, 3)).astype(np.uint8)
    anns[:, :, :20] = np.asarray([[128, 0, 0], [0, 128, 0], [192, 128, 0]], np.uint8)[nprng.integers(0, 3, 80)]
    centroids = davis_centroids()
    got = host_ann_classes(anns, centroids)
    small = nearest_resize(torch.as_tensor(anns).reshape(-1, 64, 80, 3), (8, 10))
    device = color_to_class(small, torch.as_tensor(centroids, dtype=torch.float32)).reshape(2, 3, 8, 10).numpy()
    np.testing.assert_array_equal(got, device)
    np.testing.assert_array_equal(got, jax_host_ann_classes(anns, centroids.astype(np.float32)))


def test_mining_mode_follows_the_device(monkeypatch):
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec, make_geometry_fn, mining_mode

    monkeypatch.delenv("SVOS_MINING", raising=False)
    spec = LossSpec(name="triplet", miner=tm.get_miner("skeleton"))
    assert mining_mode(spec, "cpu") == "callback"
    assert mining_mode(spec, "cuda") == "pipelined"
    assert mining_mode(LossSpec(name="triplet", miner=tm.get_miner("temporal")), "cuda") is None
    assert make_geometry_fn(spec, np.zeros((22, 3)), "cpu") is None
    monkeypatch.setenv("SVOS_MINING", "pipelined")
    assert mining_mode(spec, "cpu") == "pipelined"
    monkeypatch.setenv("SVOS_MINING", "bogus")
    with pytest.raises(ValueError, match="SVOS_MINING"):
        mining_mode(spec, "cpu")
