"""Port parity for the training losses: the same random features and labels
go through the JAX package's losses and the port's on the CPU, in float32.
Values agree to rtol 1e-5, gradients with respect to the reference and
target features to rtol 1e-4.

The triplet loss mines with the 3x3 kernel miner under a budget larger
than the number of triplets, so no random subset is drawn and both sides
mine the same set (JAX keys and torch generators draw different numbers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.train import losses as jl
from semi_supervised_vos_tpu.train.miners import get_miner as jax_get_miner
from semi_supervised_vos_tpu_torch.train import losses as tl
from semi_supervised_vos_tpu_torch.train.miners import get_miner as port_get_miner

B, R, H, W, C, D = 2, 3, 6, 6, 16, 22


def _inputs(seed):
    nprng = np.random.default_rng(seed)
    ref = (nprng.standard_normal((B, R, H, W, C)) * 0.5).astype(np.float32)
    target = (nprng.standard_normal((B, H, W, C)) * 0.5).astype(np.float32)
    ref_cls = nprng.integers(0, 3, (B, R, H, W))
    target_label = nprng.integers(0, 3, (B, H, W)).astype(np.int32)
    ref_label = np.eye(D, dtype=np.float32)[ref_cls]
    return ref, target, ref_label, target_label


def _jax_loss(name, ref, target, ref_label, target_label):
    if name == "cross_entropy":
        return jl.cross_entropy_loss(ref, target, ref_label, target_label, temperature=1.3)
    if name == "contrastive":
        return jl.contrastive_loss(ref, target, ref_label, target_label, temperature=1.3)
    if name == "focal":
        return jl.focal_loss(ref, target, ref_label, target_label)
    miner = jax_get_miner("default")
    miner.max_triplets = 64
    return jl.triplet_loss_with_miner(ref, target, ref_label, target_label, miner, rng=jax.random.PRNGKey(0),
                                      margin=0.4, weights=(1.0, 2.0), temperature=1.3)


def _port_loss(name, ref, target, ref_label, target_label):
    if name == "cross_entropy":
        return tl.cross_entropy_loss(ref, target, ref_label, target_label, temperature=1.3)
    if name == "contrastive":
        return tl.contrastive_loss(ref, target, ref_label, target_label, temperature=1.3)
    if name == "focal":
        return tl.focal_loss(ref, target, ref_label, target_label)
    miner = port_get_miner("default")
    miner.max_triplets = 64
    return tl.triplet_loss_with_miner(ref, target, ref_label, target_label, miner,
                                      generator=torch.Generator().manual_seed(0), margin=0.4, weights=(1.0, 2.0),
                                      temperature=1.3)


@pytest.mark.parametrize("name", ["cross_entropy", "contrastive", "focal", "triplet"])
def test_loss_value_and_gradients_match_jax(name):
    ref, target, ref_label, target_label = _inputs(3)
    (j_val, (j_gref, j_gtgt)) = jax.value_and_grad(
        lambda r, t: _jax_loss(name, r, t, jnp.asarray(ref_label), jnp.asarray(target_label)), argnums=(0, 1)
    )(jnp.asarray(ref), jnp.asarray(target))

    t_ref = torch.tensor(ref, requires_grad=True)
    t_tgt = torch.tensor(target, requires_grad=True)
    val = _port_loss(name, t_ref, t_tgt, torch.as_tensor(ref_label), torch.as_tensor(target_label).long())
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(t_ref.grad.numpy(), np.asarray(j_gref), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(t_tgt.grad.numpy(), np.asarray(j_gtgt), rtol=1e-4, atol=1e-7)
    assert np.abs(np.asarray(j_gtgt)).sum() > 0  # the comparison is not between zeros


def test_triplet_margin_loss_with_validity_matches_jax():
    nprng = np.random.default_rng(5)
    a, p, n = (nprng.standard_normal((2, 7, 8)).astype(np.float32) for _ in range(3))
    valid = (nprng.random((2, 7)) < 0.6).astype(np.float32)
    want = jl.triplet_margin_loss(a, p, n, jnp.asarray(valid), margin=0.3)
    got = tl.triplet_margin_loss(*(torch.as_tensor(x) for x in (a, p, n, valid)), margin=0.3)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
