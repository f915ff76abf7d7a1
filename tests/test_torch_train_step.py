"""Port parity for one optimizer step: the JAX package's train step and the
port's, from the same flax variables (carried across with
``state_dict_from_jax``) on the same uint8 clip, in float32 on the CPU.

  * the loss agrees to rtol 1e-5;
  * every parameter after the step to rtol 1e-4 / atol 1e-6;
  * the BN running statistics too: the port's BN moves its running variance
    toward the biased batch variance, as flax does (torch's own
    ``BatchNorm2d`` would use the unbiased one, 1 % off at these sizes).

The variables have every BN scale and bias cut to 5 %. At 32² crops the
last stages' BN sees 96 values a channel, and with full-size scales its
backward amplifies the two packages' float32 rounding (their convolutions
sum in other orders) to 0.1 % of a gradient and more (20 % in resnet50);
scaled down, the step is well conditioned and the worst gradient of the
resnet18 agrees to 2e-5 of its largest entry.

The triplet cases mine under a budget larger than the candidate count, so
both sides mine the same set; the skeleton case runs the pipelined mode
(host geometry passed into the step) on both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.models.vos_net import VOSNet as JVOSNet
from semi_supervised_vos_tpu.ops.onehot import davis_centroids
from semi_supervised_vos_tpu.train import loop as jloop
from semi_supervised_vos_tpu.train.miners import get_miner as jax_get_miner
from semi_supervised_vos_tpu.train.train_state import TrainState, make_optimizer as jax_make_optimizer
from semi_supervised_vos_tpu_torch.models.convert import state_dict_from_jax
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from semi_supervised_vos_tpu_torch.train import loop as tloop
from semi_supervised_vos_tpu_torch.train.miners import get_miner as port_get_miner
from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer
from tests.test_torch_models import jax_variables

CROP, LR = 32, 0.01


def train_variables(arch, seed, alpha=0.05):
    """``jax_variables`` (perturbed BN statistics) with every BN scale and
    bias times ``alpha``, as numpy."""
    _, variables = jax_variables(arch, seed)
    variables = jax.tree_util.tree_map(np.array, variables)
    scale = lambda path, x: x * alpha if path[-1].key in ("scale", "bias") else x  # noqa: E731
    return {"params": jax.tree_util.tree_map_with_path(scale, variables["params"]),
            "batch_stats": variables["batch_stats"]}


def make_clip(seed=0, b=2, t=3, crop=CROP):
    """Random frames and two coloured objects in the annotations."""
    nprng = np.random.default_rng(seed)
    imgs = nprng.integers(0, 255, (b, t, crop, crop, 3)).astype(np.uint8)
    anns = np.zeros((b, t, crop, crop, 3), np.uint8)
    anns[:, :, 4:20, 6:22] = [128, 0, 0]
    anns[:, :, 18:30, 16:30] = [0, 128, 0]
    return imgs, anns


def jax_step(arch, variables, spec, imgs, anns, freeze=False, dtype=jnp.float32):
    net = JVOSNet(model=arch, dtype=dtype)
    tx = jax_make_optimizer(base_lr=LR)
    state = TrainState(variables["params"], variables["batch_stats"], tx.init(variables["params"]), jnp.int32(0))
    mask = None
    if freeze:
        mask = jax.tree_util.tree_map(float, net.frozen_backbone_mask(state.params))
    step = jloop.make_train_step(net, spec, tx, mask)
    geometry_fn = jloop.make_geometry_fn(spec, davis_centroids())
    extra = (tuple(jnp.asarray(g) for g in geometry_fn(anns)),) if geometry_fn is not None else ()
    state, loss = step(state, imgs, anns, jnp.asarray(davis_centroids(), jnp.float32), jax.random.PRNGKey(1), *extra)
    return float(loss), {"params": state.params, "batch_stats": state.batch_stats}


def port_step(arch, variables, spec, imgs, anns, freeze=False, bf16=False):
    net = VOSNet(arch)
    net.load_state_dict(state_dict_from_jax(variables, net))
    if freeze:
        trainable = net.frozen_backbone_mask()
        for name, p in net.named_parameters():
            p.requires_grad_(trainable[name])
    net.train()
    step = tloop.make_train_step(net, spec, make_optimizer(net.parameters(), base_lr=LR), bf16=bf16)
    geometry_fn = tloop.make_geometry_fn(spec, davis_centroids(), "cpu")
    extra = (tuple(torch.as_tensor(g) for g in geometry_fn(anns)),) if geometry_fn is not None else ()
    loss = step(torch.as_tensor(imgs), torch.as_tensor(anns), torch.as_tensor(davis_centroids(), dtype=torch.float32),
                torch.Generator().manual_seed(1), *extra)
    return loss.item(), net


def assert_states_match(net, jax_vars, before=None):
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_vars), net)
    got = net.state_dict()
    moved = 0
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-4, atol=1e-6, err_msg=key)
        if before is not None and not torch.equal(before[key], value):
            moved += 1
    return moved


def specs(name):
    if name == "triplet_kernel":
        return (jloop.LossSpec(name="triplet", miner=jax_get_miner("default"), loss_weight=2.0),
                tloop.LossSpec(name="triplet", miner=port_get_miner("default"), loss_weight=2.0))
    if name == "triplet_skeleton_pipelined":
        return (jloop.LossSpec(name="triplet", miner=jax_get_miner("skeleton")),
                tloop.LossSpec(name="triplet", miner=port_get_miner("skeleton")))
    return jloop.LossSpec(name=name), tloop.LossSpec(name=name)


@pytest.mark.parametrize("name", ["cross_entropy", "focal", "contrastive", "triplet_kernel",
                                  "triplet_skeleton_pipelined"])
def test_train_step_matches_jax(name, monkeypatch):
    monkeypatch.setenv("SVOS_MINING", "pipelined")
    variables = train_variables("resnet18", 5)
    imgs, anns = make_clip()
    jspec, tspec = specs(name)
    if name == "triplet_skeleton_pipelined":
        assert tloop.mining_mode(tspec, "cpu") == jloop.mining_mode(jspec) == "pipelined"
    j_loss, j_vars = jax_step("resnet18", variables, jspec, imgs, anns)
    t_loss, net = port_step("resnet18", variables, tspec, imgs, anns)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    before = state_dict_from_jax(variables, net)
    moved = assert_states_match(net, j_vars, before)
    assert moved > 50, moved  # parameters and running statistics moved
