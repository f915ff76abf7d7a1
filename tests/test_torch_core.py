"""Port parity: core sampling / spatial / propagation math and the one-hot
and resize ops against the JAX package on the CPU (float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.core import propagation as jprop
from semi_supervised_vos_tpu.core import sampling as jsamp
from semi_supervised_vos_tpu.core import spatial as jspat
from semi_supervised_vos_tpu.ops import onehot as jonehot
from semi_supervised_vos_tpu.ops import resize as jresize
from semi_supervised_vos_tpu_torch.core import propagation as tprop
from semi_supervised_vos_tpu_torch.core import sampling as tsamp
from semi_supervised_vos_tpu_torch.core import spatial as tspat
from semi_supervised_vos_tpu_torch.ops import onehot as tonehot
from semi_supervised_vos_tpu_torch.ops import resize as tresize


@pytest.mark.parametrize("take_range,num_refs", [(40, 9), (20, 9), (40, 5), (12, 7), (6, 5)])
def test_sample_frames_exact(take_range, num_refs):
    for frame_idx in range(1, 130):
        assert tsamp.sample_frames_host(frame_idx, take_range, num_refs) == jsamp.sample_frames_host(
            frame_idx, take_range, num_refs
        )
        got = tsamp.sample_frames(frame_idx, take_range, num_refs)
        expect = jsamp.sample_frames(frame_idx, take_range, num_refs)
        for g, e in zip(got, expect):
            np.testing.assert_array_equal(g, np.asarray(e), err_msg=f"frame {frame_idx}")
    assert tsamp.bank_capacity(take_range) == jsamp.bank_capacity(take_range)


@pytest.mark.parametrize("shape,sigma", [((4, 7), 8.0), ((6, 5), 21.0), ((3, 3), 1.5), ((7, 9), 8.0)])
def test_spatial_exact(shape, sigma):
    np.testing.assert_array_equal(
        tspat.spatial_coords(*shape).numpy(), np.asarray(jspat.spatial_coords(*shape))
    )
    # the coordinates and squared distances are exact; the weights agree to
    # one ulp: XLA's CPU exp is not correctly rounded, torch's is
    np.testing.assert_array_max_ulp(
        tspat.spatial_weight(shape, sigma).numpy(), np.asarray(jspat.spatial_weight(shape, sigma)), maxulp=1
    )
    # the fractional-row convention: row = idx / W by true division
    np.testing.assert_allclose(tspat.spatial_coords(2, 4)[5].numpy(), [1.25, 1.0])


def test_onehot_and_palette_exact(rng):
    idx = rng.integers(0, 22, size=(5, 7))
    np.testing.assert_array_equal(
        tonehot.index_to_onehot(torch.as_tensor(idx), 22).numpy(),
        np.asarray(jonehot.index_to_onehot(jnp.asarray(idx), 22)),
    )
    np.testing.assert_array_equal(tonehot.davis_palette(), jonehot.davis_palette())


@pytest.mark.parametrize("in_hw,out_hw", [((8, 14), (60, 107)), ((60, 107), (8, 14)), ((5, 5), (7, 3))])
def test_nearest_resize_exact(rng, in_hw, out_hw):
    x = rng.integers(0, 255, size=in_hw + (3,), dtype=np.uint8)
    expect = np.asarray(jresize.nearest_resize(jnp.asarray(x), out_hw))
    np.testing.assert_array_equal(tresize.nearest_resize(torch.as_tensor(x), out_hw).numpy(), expect)
    np.testing.assert_array_equal(tresize.nearest_resize_host(x, out_hw), expect)
    stack = rng.integers(0, 22, size=(3,) + in_hw, dtype=np.uint8)
    np.testing.assert_array_equal(
        tresize.nearest_resize_host(stack, out_hw, hw_axes=(1, 2)),
        jresize.nearest_resize_host(stack, out_hw, hw_axes=(1, 2)),
    )


@pytest.mark.parametrize("frame_idx", [3, 9, 20])
@pytest.mark.parametrize("spatial", [True, False])
def test_affinity_propagate_matches_jax(rng, frame_idx, spatial):
    hd, wd, k, c, d = 6, 8, 9, 32, 22
    p = hd * wd
    ref = (rng.standard_normal((k, p, c)) * 0.3).astype(np.float32)
    tgt = (rng.standard_normal((p, c)) * 0.3).astype(np.float32)
    labels = np.zeros((k, p, d), np.float32)
    labels[np.arange(k)[:, None], np.arange(p)[None], rng.integers(0, 5, size=(k, p))] = 1.0
    _, valid, dense = tsamp.sample_frames(frame_idx, 40, k)
    wdm = tspat.spatial_weight((hd, wd), 8.0) if spatial else None
    wsm = tspat.spatial_weight((hd, wd), 21.0) if spatial else None
    got = tprop.affinity_propagate(
        torch.as_tensor(ref), torch.as_tensor(tgt), torch.as_tensor(labels), temperature=1.9,
        valid=torch.as_tensor(valid), dense=torch.as_tensor(dense), weight_dense=wdm, weight_sparse=wsm,
    ).numpy()
    expect = np.asarray(
        jprop.affinity_propagate(
            ref, tgt, labels, temperature=1.9, valid=valid, dense=dense,
            weight_dense=None if wdm is None else wdm.numpy(),
            weight_sparse=None if wsm is None else wsm.numpy(), precision="highest",
        )
    )
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
