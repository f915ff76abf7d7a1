"""Port parity: ``affinity_propagate_fused`` (the port of
``affinity_propagate_pallas``) on the CPU, where it runs its plain version,
against the JAX Pallas kernel in interpret mode on the cases of
``tests/test_pallas_affinity.py`` with that file's tolerances; and K = 20
reference slots through both affinity ops against the float32 golden. The
CUDA kernel against the plain versions is in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.core.propagation import affinity_propagate as j_golden
from semi_supervised_vos_tpu.core.spatial import spatial_weight as j_spatial_weight
from semi_supervised_vos_tpu.ops.affinity_pallas import affinity_propagate_pallas
from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
from semi_supervised_vos_tpu_torch.ops import affinity as tap
from tests.test_pallas_affinity import _assert_argmax_close, _inputs


def _both(ref, tgt, labels, hd, wd, temperature, valid, dense, **kw):
    """(port, JAX interpret) (D, P) scores on the same numpy inputs."""
    port_kw = dict(kw)
    if port_kw.get("label_dtype") is jnp.float32:
        port_kw["label_dtype"] = torch.float32
    got = tap.affinity_propagate_fused(
        torch.as_tensor(ref), torch.as_tensor(tgt), torch.as_tensor(labels), feature_hw=(hd, wd),
        temperature=temperature, valid=np.asarray(valid), dense=np.asarray(dense), **port_kw,
    ).numpy()
    expect = np.asarray(
        affinity_propagate_pallas(
            ref, tgt, labels, feature_hw=(hd, wd), temperature=temperature, valid=valid, dense=dense,
            interpret=True, block_r=128, block_t=128, **kw,
        )
    )
    assert got.shape == expect.shape == (labels.shape[-1], hd * wd)
    return got, expect


@pytest.mark.parametrize("frame_idx", [3, 9, 20])
@pytest.mark.parametrize("spatial", [True, False])
def test_fused_plain_matches_pallas_interpret(rng, frame_idx, spatial):
    hd, wd = 6, 8
    ref, tgt, labels = _inputs(rng, hd=hd, wd=wd)
    _, valid, dense = sample_frames(frame_idx, 40, 9)
    got, expect = _both(ref, tgt, labels, hd, wd, 1.9, valid, dense, spatial=spatial)
    _assert_argmax_close(got, expect)
    np.testing.assert_allclose(got, expect, rtol=0.05, atol=5e-3)


def test_fused_plain_f32_labels_matches_pallas_interpret(rng):
    hd, wd = 4, 8
    ref, tgt, labels = _inputs(rng, k=4, hd=hd, wd=wd, c=16)
    _, valid, _ = sample_frames(4, 40, 4)
    got, expect = _both(
        ref, tgt, labels, hd, wd, 1.0, valid, np.ones(4, bool), sigma_1=8.0, sigma_2=8.0,
        label_dtype=jnp.float32,
    )
    np.testing.assert_allclose(got, expect, rtol=0.02, atol=1e-3)


def test_fused_plain_padding_matches_pallas_interpret(rng):
    """P = 35 and C = 16: no multiple of the TPU kernel's blocks, and the
    class axis (22) padded to 24 on the port's side."""
    hd, wd = 5, 7
    ref, tgt, labels = _inputs(rng, k=3, hd=hd, wd=wd, c=16)
    _, valid, dense = sample_frames(3, 40, 3)
    got, expect = _both(ref, tgt, labels, hd, wd, 1.0, valid, dense)
    _assert_argmax_close(got, expect)
    np.testing.assert_allclose(got, expect, rtol=0.05, atol=5e-3)


def _bf16_values(x):
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("op", ["from_bank", "fused"])
def test_k20_matches_golden(rng, op):
    """K = 20 reference slots (``inference -n 20``), past the schedule's
    dense/sparse switch, against the float32 golden. Features are
    bf16-valued and the labels soft, so the fused op's float32 labels go
    through both bf16 halves; what is left is its e·w split (~16 bits)."""
    hd, wd, c, d, k, cap, t = 6, 8, 32, 5, 20, 45, 30
    p = hd * wd
    idx, valid, dense = sample_frames(t, 40, k)
    assert k == len(idx) and valid.all() and not dense.all()
    bank = _bf16_values(rng.standard_normal((cap, p, c)) * 0.3)
    labels = rng.dirichlet(np.ones(d), size=(cap, p)).astype(np.float32)
    tgt = _bf16_values(rng.standard_normal((p, c)) * 0.3)
    slots = idx % cap
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    expect = np.asarray(
        j_golden(
            bank[slots], tgt, labels[slots], temperature=1.0, valid=valid, dense=dense,
            weight_dense=np.asarray(j_spatial_weight((hd, wd), 8.0)),
            weight_sparse=np.asarray(j_spatial_weight((hd, wd), 21.0)), precision="highest",
        )
    )
    if op == "from_bank":
        got = tap.affinity_from_bank(
            torch.as_tensor(bank), torch.as_tensor(labels), torch.as_tensor(tgt), slots, **kw
        ).numpy()
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)
    else:
        got = tap.affinity_propagate_fused(
            torch.as_tensor(bank[slots]), torch.as_tensor(tgt), torch.as_tensor(labels[slots]),
            label_dtype=torch.float32, **kw,
        ).numpy()
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=5e-5)
    assert got.shape == (d, p)


def test_fused_rejects_other_devices_and_label_types():
    x = torch.zeros((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tap.affinity_propagate_fused(x, x[0], x, feature_hw=(2, 4), temperature=1.0)
    cpu = torch.zeros((2, 8, 16))
    with pytest.raises(TypeError, match="label_dtype"):
        tap.affinity_propagate_fused(cpu, cpu[0], cpu, feature_hw=(2, 4), temperature=1.0,
                                     label_dtype=torch.float16)
