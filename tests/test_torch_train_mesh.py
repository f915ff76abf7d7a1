"""The port's mesh train step (``parallel/train_mesh.py``, ``parallel/tp.py``)
against the JAX package's step on its 8 virtual CPU devices, at resnet18 on
32 x 32 clips as ``tests/test_parallel.py`` and ``tests/test_tp.py`` run it.

The port's mesh is ``[cpu] * 8`` (data parallel), ``[cpu] * 4`` as 1 x 4
and ``[cpu] * 8`` as 2 x 4 (channel sharding, alone and composed); each is
held against the JAX package's step over the same mesh shape, from the same
flax initialisation carried across, on the same seeded clips, with the JAX
tests' own bars: loss rtol 1e-5; conv1 kernel rtol 5e-2, atol 2e-3; the
conv1 update's cosine > 0.999; and the BN running statistics within 1e-5.
In float64 the mesh step equals the port's single-device step to rounding (rtol 1e-9) in
every parameter (the float32 differences are the deep net's conditioning,
as in the JAX tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.models.vos_net import VOSNet as JVOSNet
from semi_supervised_vos_tpu.ops.onehot import davis_centroids
from semi_supervised_vos_tpu.train.loop import LossSpec as JLossSpec
from semi_supervised_vos_tpu.train.loop import make_train_step as jax_make_train_step
from semi_supervised_vos_tpu.train.train_state import init_train_state
from semi_supervised_vos_tpu.train.train_state import make_optimizer as jax_make_optimizer
from semi_supervised_vos_tpu_torch.models.convert import state_dict_from_jax
from semi_supervised_vos_tpu_torch.models.vos_net import RESNET_NAMES, VOSNet
from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh
from semi_supervised_vos_tpu_torch.parallel.tp import REPLICATED, SPLIT_1D, SPLIT_4D, leaf_spec, shard_tp, tp_shardings
from semi_supervised_vos_tpu_torch.parallel.train_mesh import MeshNet, make_mesh_eval_step, make_mesh_train_step
from semi_supervised_vos_tpu_torch.train import loop as tloop
from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

LR = 0.01
CPU8 = [torch.device("cpu")] * 8
MESHES = {"dp8": (8, 1), "tp1x4": (1, 4), "dp2xtp4": (2, 4)}


def clips(b, seed=42):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (b, 3, 32, 32, 3)).astype(np.uint8)
    anns = np.zeros((b, 3, 32, 32, 3), np.uint8)
    anns[:, :, 8:20, 8:20] = [128, 0, 0]
    anns[:, :, 20:28, 4:30] = [0, 128, 0]
    return imgs, anns


def batch_size(shape):
    return 8 if shape == (8, 1) else 4


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's initial variables and, for each mesh, its loss and
    state after one step (computed once for the module)."""
    from semi_supervised_vos_tpu.parallel.mesh import make_mesh as jax_mesh
    from semi_supervised_vos_tpu.parallel.mesh import replicate, shard_batch
    from semi_supervised_vos_tpu.parallel.tp import shard_tp as jax_shard_tp

    net = JVOSNet(model="resnet18")
    tx = jax_make_optimizer(base_lr=LR)
    init = lambda: init_train_state(net, jax.random.PRNGKey(0), (1, 32, 32, 3), tx)  # noqa: E731
    first = init()
    variables = jax.tree_util.tree_map(np.array, {"params": first.params, "batch_stats": first.batch_stats})
    step = jax_make_train_step(net, JLossSpec(name="cross_entropy"), tx)
    centroids = jnp.asarray(davis_centroids(), jnp.float32)
    out = {}
    for name, (n_data, n_model) in MESHES.items():
        mesh = jax_mesh(n_data=n_data, n_model=n_model)
        state = jax_shard_tp(mesh, init()) if n_model > 1 else replicate(mesh, init())
        imgs, anns = shard_batch(mesh, *clips(batch_size((n_data, n_model))))
        state, loss = step(state, imgs, anns, replicate(mesh, centroids), jax.random.PRNGKey(3))
        out[name] = (float(loss), jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                                       "batch_stats": state.batch_stats}))
    return variables, out


def port_net(variables, arch="resnet18"):
    net = VOSNet(arch)
    net.load_state_dict(state_dict_from_jax(variables, net))
    return net.train()


def mesh_net(net, shape, devices=CPU8):
    mesh = make_mesh(*shape, devices=devices)
    optimizer = make_optimizer(net.parameters(), base_lr=LR)
    return shard_tp(mesh, net, optimizer) if shape[1] > 1 else MeshNet(mesh, net, optimizer)


def port_step(mnet, imgs, anns):
    step = make_mesh_train_step(mnet, tloop.LossSpec(name="cross_entropy"))
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32)
    loss = step(torch.as_tensor(imgs), torch.as_tensor(anns), centroids, torch.Generator().manual_seed(3))
    mnet.sync_to_net()
    return loss.item()


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_step_matches_jax(jax_steps, name):
    variables, ref = jax_steps
    shape = MESHES[name]
    net = port_net(variables)
    k0 = net.backbone[0].weight.detach().clone()
    mnet = mesh_net(net, shape)
    if shape[1] > 1:  # the conv kernels really are split over the columns
        shards = mnet.tensors["backbone.0.weight"]
        assert len(shards) == shape[1] and all(s.shape == (64 // shape[1], 3, 7, 7) for s in shards)
    loss = port_step(mnet, *clips(batch_size(shape)))
    j_loss, j_state = ref[name]
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    want = state_dict_from_jax(j_state, net)
    got = net.state_dict()
    k1, kj = got["backbone.0.weight"], want["backbone.0.weight"]
    np.testing.assert_allclose(k1.numpy(), kj.numpy(), rtol=5e-2, atol=2e-3)
    u, uj = (k1 - k0).flatten(), (kj - k0).flatten()
    cos = float(u @ uj / (u.norm() * uj.norm()))
    assert cos > 0.999, cos
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 19  # resnet18: bn1, two a block, two downsample branches
    for key in stats:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5, err_msg=key)
    assert all(int(got[k]) == 1 for k in got if k.endswith("num_batches_tracked"))


@pytest.fixture(scope="module", autouse=True)
def one_compute_thread():
    """One intra-op thread: beside the suite's other workers, float64
    convolutions on more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch,shape", [("resnet18", (1, 1)), ("resnet18", (4, 1)), ("resnet18", (2, 2)),
                                        ("resnet50", (2, 2)), ("facebook", (2, 2))])
def test_mesh_forward_and_steps_equal_single_device_in_float64(arch, shape):
    """Two steps (the second with momentum) in float64: the mesh equals the
    single-device step to rounding, for every backbone topology (the 1x1
    heads, facebook's two-conv head, the downsample branches)."""
    torch.manual_seed(0)
    imgs, anns = clips(4, seed=5)
    nets = []
    for _ in range(2):
        net = VOSNet(arch).double().train()
        torch.manual_seed(0)
        for p in net.parameters():
            p.data.normal_(0.0, 0.05) if p.ndim == 4 else p.data.uniform_(0.5, 1.5)
        nets.append(net)
    x = tloop.normalized_frames(torch.as_tensor(imgs)).double()
    single = nets[0]
    opt = make_optimizer(single.parameters(), base_lr=LR)
    mnet = mesh_net(nets[1], shape, devices=[torch.device("cpu")] * 4)
    for _ in range(2):
        opt.zero_grad()
        single(x).square().mean().backward()
        opt.step()
        mnet.optimizer.zero_grad()
        torch.cat(mnet.forward(list(x.chunk(shape[0])))).square().mean().backward()
        mnet.optimizer.step()
    mnet.sync_to_net()
    for (key, a), b in zip(single.state_dict().items(), nets[1].state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-9, atol=1e-12, err_msg=key)
    single.eval(), nets[1].eval()
    with torch.no_grad():
        np.testing.assert_allclose(torch.cat(mnet.forward(list(x.chunk(shape[0])))).numpy(), single(x).numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_eval_step_and_bf16_compose(jax_steps):
    """The mesh eval step equals the single-device one; ``bf16`` autocast
    runs on the mesh."""
    variables, _ = jax_steps
    imgs, anns = (torch.as_tensor(a) for a in clips(4))
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32)
    spec = tloop.LossSpec(name="cross_entropy")
    net = port_net(variables).eval()
    want = tloop.make_eval_step(net, spec)(imgs, anns, centroids, torch.Generator().manual_seed(3))
    got = make_mesh_eval_step(mesh_net(net, (2, 2)), spec)(imgs, anns, centroids, torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    net = port_net(variables)
    mnet = mesh_net(net, (2, 2))
    loss = make_mesh_train_step(mnet, spec, bf16=True)(imgs, anns, centroids, torch.Generator().manual_seed(3))
    single = port_net(variables)
    want = tloop.make_train_step(single, spec, make_optimizer(single.parameters(), base_lr=LR), bf16=True)(
        imgs, anns, centroids, torch.Generator().manual_seed(3))
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), want.item(), rtol=5e-2)


def test_freeze_under_tp():
    """``--freeze`` on a 2 x 2 mesh: the backbone's shards and the net keep
    their values and get no momentum; the head trains as on one device."""
    torch.manual_seed(1)
    net, single = VOSNet("resnet50"), VOSNet("resnet50")
    single.load_state_dict(net.state_dict())
    for n in (net, single):
        trainable = n.frozen_backbone_mask()
        for name, p in n.named_parameters():
            p.requires_grad_(trainable[name])
        n.train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    mnet = mesh_net(net, (2, 2), devices=[torch.device("cpu")] * 4)
    assert all(not s.requires_grad for s in mnet.tensors["backbone.0.weight"])
    imgs, anns = clips(4)
    loss = port_step(mnet, imgs, anns)
    spec = tloop.LossSpec(name="cross_entropy")
    want = tloop.make_train_step(single, spec, make_optimizer(single.parameters(), base_lr=LR))(
        torch.as_tensor(imgs), torch.as_tensor(anns), torch.as_tensor(davis_centroids(), dtype=torch.float32),
        torch.Generator().manual_seed(3))
    # a default-initialised resnet50 in float32: the statistics' summation
    # orders differ at 2e-5 of the loss
    np.testing.assert_allclose(loss, want.item(), rtol=1e-4)
    after = net.state_dict()
    for name, p in net.named_parameters():
        if name.startswith("backbone."):
            assert torch.equal(after[name], before[name]), name
            assert all("momentum_buffer" not in mnet.optimizer.state[s] for s in mnet.tensors[name])
        else:
            assert not torch.equal(after[name], before[name]), name
            np.testing.assert_allclose(after[name].numpy(), single.state_dict()[name].numpy(), rtol=1e-3,
                                       atol=1e-5)


@pytest.mark.parametrize("model_name", RESNET_NAMES)
def test_rule_covers_every_leaf(model_name):
    """Every 1-D leaf is per-channel (>= 64) and every 4-D leaf an OIHW
    kernel with O >= 64 dividing over 8, for every backbone ``train --tp``
    takes: the assumption the shape rule rests on. The rule agrees with the
    JAX package's on the same leaves (HWIO there)."""
    from semi_supervised_vos_tpu.parallel.tp import _leaf_spec as jax_leaf_spec

    net = VOSNet(model_name)
    optimizer = make_optimizer(net.parameters(), base_lr=LR)
    mesh = make_mesh(1, 8, devices=CPU8)
    specs = tp_shardings(mesh, net)
    assert set(specs) == set(net.state_dict())
    for name, t in net.state_dict().items():
        shape = tuple(t.shape)
        jax_shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape
        jspec = tuple(jax_leaf_spec(jax_shape, 8))
        if len(shape) == 4:
            assert specs[name] == SPLIT_4D and shape[0] % 8 == 0 and shape[0] >= 64, (name, shape)
            assert jspec == (None, None, None, "model")
        elif len(shape) == 1:
            assert specs[name] == SPLIT_1D and shape[0] >= 64 and shape[0] % 8 == 0, (name, shape)
            assert jspec == ("model",)
        else:
            assert specs[name] == REPLICATED and jspec == () and name.endswith("num_batches_tracked"), name
    assert leaf_spec((7,), 8) == leaf_spec((4,), 8) == leaf_spec((3, 3), 8) == REPLICATED
    mnet = shard_tp(mesh, net, optimizer)
    assert mnet.split == {k for k, s in specs.items() if s != REPLICATED}
    assert len(mnet.optimizer.param_groups[0]["params"]) == 8 * len(list(net.parameters()))


def test_sharded_momentum_round_trip():
    """The momentum goes with the shards: split from the single-device
    optimizer, stepped, and gathered back equal to the single-device
    step's."""
    torch.manual_seed(2)
    nets = [VOSNet("resnet18").double().train() for _ in range(2)]
    nets[1].load_state_dict(nets[0].state_dict())
    x = torch.randn(4, 3, 32, 32, dtype=torch.float64)
    opts = [make_optimizer(n.parameters(), base_lr=LR) for n in nets]
    for n, o in zip(nets, opts):  # one single-device step makes the momentum
        n(x).square().mean().backward()
        o.step()
        o.zero_grad()
    mnet = shard_tp(make_mesh(1, 4, devices=[torch.device("cpu")] * 4), nets[1], opts[1])
    w = mnet.tensors["backbone.4.0.conv1.weight"]
    buf = opts[1].state[nets[1].backbone[4][0].conv1.weight]["momentum_buffer"]
    assert torch.equal(mnet.optimizer.state[w[2]]["momentum_buffer"], buf.chunk(4)[2])
    nets[0](x).square().mean().backward()
    opts[0].step()
    torch.cat(mnet.forward([x])).square().mean().backward()
    mnet.optimizer.step()
    mnet.sync_to_net()
    for p0, p1 in zip(nets[0].parameters(), nets[1].parameters()):
        np.testing.assert_allclose(p1.detach().numpy(), p0.detach().numpy(), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(opts[1].state[p1]["momentum_buffer"].numpy(),
                                   opts[0].state[p0]["momentum_buffer"].numpy(), rtol=1e-9, atol=1e-12)


def test_staging_places_rows_and_geometry():
    """``run_epoch`` with a mesh: the staging thread cuts each batch over
    the data rows (``shard_batch``) and the step sees per-row lists."""
    mesh = make_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    imgs, anns = clips(4)
    seen = []

    def step(i, a, c, g, geom=None):
        seen.append(([t.shape[0] for t in i], [t.shape[0] for t in a], geom))
        return torch.tensor(1.0)

    loss = tloop.run_epoch(step, iter([(imgs, anns)] * 2), None, None, "cpu", mesh=mesh,
                           geometry_fn=lambda a: (np.zeros((a.shape[0], 2)),))
    assert loss == 1.0 and len(seen) == 2
    assert seen[0][:2] == ([2, 2], [2, 2]) and seen[0][2][0].shape == (4, 2)


def test_dryrun_multichip():
    from semi_supervised_vos_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(CPU8)
    assert np.isfinite(out["loss"]) and np.isfinite(out["loss_tp"])
    assert out["mesh_tp"] == (2, 4)
    assert out["kernel_agree"] > 0.99
