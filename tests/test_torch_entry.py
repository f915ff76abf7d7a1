"""The port's flagship forward step (``graft_entry.py::entry``) on the CPU
against the JAX package's ``__graft_entry__.entry()`` on the same weights
and inputs. The card's step, with its launch of
``affinity_propagate_fused``, is in ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from semi_supervised_vos_tpu.core.propagation import affinity_propagate as j_propagate
from semi_supervised_vos_tpu.core.sampling import sample_frames as j_sample_frames
from semi_supervised_vos_tpu.core.spatial import spatial_weight as j_spatial_weight
from semi_supervised_vos_tpu.models.vos_net import VOSNet as JVOSNet
from semi_supervised_vos_tpu_torch import graft_entry
from semi_supervised_vos_tpu_torch.models.convert import state_dict_from_jax
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from semi_supervised_vos_tpu_torch.ops import affinity as aff


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step, its example arguments, its jitted output, and the port's
    resnet50 with the same weights."""
    step, args = jentry.entry()
    out = np.asarray(jax.jit(step)(*args))
    net = VOSNet("resnet50").eval()
    net.load_state_dict(state_dict_from_jax(args[0], net))
    return step, args, out, net


def _port_args(args, net):
    return (net, *(torch.as_tensor(np.asarray(a)) for a in args[1:4]), int(args[4]))


def test_example_args_are_the_jax_steps(jax_step):
    """The port's example arguments are the JAX step's inputs (numpy's
    ``default_rng(0)`` in the same order), on the given device."""
    _, args, _, _ = jax_step
    step, ours = graft_entry.entry("cpu")
    assert isinstance(ours[0], VOSNet) and ours[0].model == "resnet50" and not ours[0].training
    for got, expect in zip(ours[1:4], args[1:4]):
        assert got.device.type == "cpu" and got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(expect))
    assert ours[4] == int(args[4]) == 7
    mask = step(*ours)
    assert mask.shape == (16, 16) and mask.dtype == torch.int64
    assert 0 <= int(mask.min()) and int(mask.max()) < graft_entry.NUM_CLASSES


def test_entry_matches_the_jax_step(jax_step):
    """The JAX step encodes in bf16 and the port's CPU step in float32, and
    the example bank (unit-normal, C 256) makes the softmax all but one-hot,
    so bf16 alone moves the argmax of a few of the 256 pixels: the JAX step
    jitted and run eagerly agree on 251 (0.9805); the port agrees with the
    jitted step on 249 (0.9727)."""
    step, args, expect, net = jax_step
    got = graft_entry.entry("cpu")[0](*_port_args(args, net)).numpy()
    assert got.shape == expect.shape == (16, 16)
    assert (got == expect).mean() >= 0.97


def test_entry_matches_the_jax_step_at_float32(jax_step):
    """The JAX step's computation with its VOSNet at float32 (the body of
    ``__graft_entry__.entry``'s ``forward_step``): the two float32 steps
    agree on every pixel but, at most, one where two classes' scores tie to
    the last bits (all 256 agree on these inputs)."""
    _, args, _, net = jax_step
    variables, frame, bank, labels, frame_idx = args
    feats = JVOSNet(model="resnet50").apply(variables, frame, train=False).reshape(256, 256)
    idx, valid, dense = j_sample_frames(frame_idx, 40, 9)
    pred = j_propagate(jnp.asarray(bank)[idx], feats, jnp.asarray(labels)[idx], temperature=1.0, valid=valid,
                       dense=dense, weight_dense=j_spatial_weight((16, 16), 8.0),
                       weight_sparse=j_spatial_weight((16, 16), 21.0))
    expect = np.asarray(jnp.argmax(pred, axis=0).reshape(16, 16))
    got = graft_entry.entry("cpu")[0](*_port_args(args, net)).numpy()
    assert (got != expect).sum() <= 1


def test_cpu_step_runs_the_plain_propagation(jax_step, monkeypatch):
    """On the CPU the step propagates with ``core.propagation.
    affinity_propagate``, never the fused op."""
    _, args, _, net = jax_step
    monkeypatch.setattr(aff, "affinity_propagate_fused", lambda *a, **k: pytest.fail("fused op on the CPU"))
    mask = graft_entry.entry("cpu")[0](*_port_args(args, net))
    assert mask.shape == (16, 16)
