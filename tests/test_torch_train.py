"""Port parity for the rest of training, on the CPU: the optimizer and the
cosine schedule against the JAX package's, the train initialisation
against flax's, a ``--freeze`` step (resnet50) and a ``--bf16`` step against
the JAX package's, ``TrainDataset`` items byte-identical to the JAX
package's, early stopping, and the ``.pth.tar`` train state."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_davis_dataset
from tests.test_torch_train_step import (
    assert_states_match,
    jax_step,
    make_clip,
    port_step,
    specs,
    train_variables,
)


def test_optimizer_four_steps_match_jax():
    from semi_supervised_vos_tpu.train.train_state import make_optimizer as jax_make_optimizer
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer, set_learning_rate

    nprng = np.random.default_rng(0)
    w0 = nprng.standard_normal((4, 3)).astype(np.float32)
    grads = [nprng.standard_normal((4, 3)).astype(np.float32) for _ in range(4)]
    tx = jax_make_optimizer(base_lr=0.02)
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = make_optimizer([w])
    set_learning_rate(opt, 0.02)
    for g in grads:
        w.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=1e-6, atol=1e-7)


def test_cosine_schedule_matches_jax():
    """The JAX package computes the schedule in float32, the port in
    float64: they agree to float32 rounding."""
    from semi_supervised_vos_tpu.train.train_state import cosine_lr as jax_cosine_lr
    from semi_supervised_vos_tpu_torch.train.train_state import cosine_lr

    for epoch in (0, 1, 7, 119, 120, 239):
        np.testing.assert_allclose(cosine_lr(epoch, base_lr=0.02, epochs=240),
                                   float(jax_cosine_lr(epoch, base_lr=0.02, epochs=240)), rtol=1e-5)


def test_train_init_matches_flax_distribution():
    """Every conv kernel: flax ``lecun_normal`` (variance 1 / fan_in,
    truncated at two of the pre-truncation deviations). The sample standard
    deviations of the port's and flax's kernels agree within 4 % (the
    smallest kernel has 9408 entries) and stay inside the truncation bound;
    BN starts at scale 1, bias 0, mean 0, variance 1 on both sides."""
    from semi_supervised_vos_tpu.models.vos_net import VOSNet as JVOSNet
    from semi_supervised_vos_tpu_torch.models.convert import state_dict_from_jax
    from semi_supervised_vos_tpu_torch.models.resnet import init_train_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet("resnet18")
    init_train_weights(net, torch.Generator().manual_seed(42))
    variables = JVOSNet(model="resnet18").init(jax.random.PRNGKey(42), jnp.zeros((1, 32, 32, 3)))
    flax_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables), net)
    for name, value in net.state_dict().items():
        want = flax_sd[name].numpy()
        got = value.numpy()
        if name.endswith("num_batches_tracked"):
            continue
        if got.ndim == 4:
            fan_in = got.shape[1] * got.shape[2] * got.shape[3]
            bound = 2 * math.sqrt(1 / fan_in) / 0.87962566103423978
            assert np.abs(got).max() <= bound and np.abs(want).max() <= bound, name
            assert abs(got.std() / want.std() - 1) < 0.04, (name, got.std(), want.std())
            assert abs(got.std() ** 2 * fan_in - 1) < 0.06, name
            assert abs(got.mean()) < 4 * got.std() / math.sqrt(got.size), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_freeze_step_matches_jax():
    """``--freeze`` on resnet50: the backbone is bit-unchanged on both sides
    (BN running statistics still move, as in train mode), the head trains
    and matches."""
    from semi_supervised_vos_tpu_torch.models.convert import state_dict_from_jax

    variables = train_variables("resnet50", 6)
    imgs, anns = make_clip(seed=1)
    jspec, tspec = specs("cross_entropy")
    j_loss, j_vars = jax_step("resnet50", variables, jspec, imgs, anns, freeze=True)
    t_loss, net = port_step("resnet50", variables, tspec, imgs, anns, freeze=True)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    before = state_dict_from_jax(variables, net)
    after_jax = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_vars), net)
    got = net.state_dict()
    for name, _ in net.named_parameters():
        if name.startswith("backbone."):
            assert torch.equal(got[name], before[name]), name
            assert torch.equal(after_jax[name], before[name]), name
        else:
            assert not torch.equal(got[name], before[name]), name
    assert_states_match(net, j_vars)


def test_bf16_step_matches_jax():
    """One ``--bf16`` step: the JAX package computes the backbone in
    bfloat16, the port runs it under ``torch.autocast(bfloat16)``; the
    losses agree within 2e-2 relative."""
    variables = train_variables("resnet18", 5)
    imgs, anns = make_clip(seed=2)
    jspec, tspec = specs("cross_entropy")
    j_loss, _ = jax_step("resnet18", variables, jspec, imgs, anns, dtype=jnp.bfloat16)
    t_loss, net = port_step("resnet18", variables, tspec, imgs, anns, bf16=True)
    f32_loss, _ = port_step("resnet18", variables, tspec, imgs, anns)
    assert math.isfinite(t_loss)
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-2)
    assert t_loss != f32_loss  # the forward did run in bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())


@pytest.fixture(scope="module")
def davis(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis")
    make_davis_dataset(root, videos=("a", "b"), frames=6, size=(64, 80), objects=2)
    return root


@pytest.mark.parametrize("color_jitter,decode_cache", [(False, False), (True, False), (False, True), (True, True)])
def test_train_dataset_items_byte_identical_to_jax(davis, color_jitter, decode_cache):
    from semi_supervised_vos_tpu.data.davis import TrainDataset as JTrainDataset
    from semi_supervised_vos_tpu_torch.data.davis import TrainDataset

    args = (davis / "JPEGImages/480p", davis / "Annotations/480p")
    kw = dict(cropping=48, frame_num=3, color_jitter=color_jitter, decode_cache=decode_cache)
    want_ds, got_ds = JTrainDataset(*args, **kw), TrainDataset(*args, **kw)
    for epoch in range(2):  # a second epoch reads the cache when it is on
        want_ds.seed(7)
        got_ds.seed(7)
        for i in range(len(got_ds)):
            (wi, wa, wv), (gi, ga, gv) = want_ds[i], got_ds[i]
            assert gi.dtype == np.uint8 and gi.shape == (3, 48, 48, 3) and ga.shape == (3, 48, 48, 3)
            assert gi.tobytes() == wi.tobytes() and ga.tobytes() == wa.tobytes() and gv == wv, (epoch, i)


def test_batches_do_not_depend_on_worker_count(davis):
    """The port draws each item's augmentation in index order before the
    decode pool, so four workers give the JAX package's one-thread batches."""
    from semi_supervised_vos_tpu.data.davis import TrainDataset as JTrainDataset
    from semi_supervised_vos_tpu.train.loop import iterate_batches as jax_iterate_batches
    from semi_supervised_vos_tpu_torch.data.davis import TrainDataset
    from semi_supervised_vos_tpu_torch.train.loop import iterate_batches

    args = (davis / "JPEGImages/480p", davis / "Annotations/480p")
    want = list(jax_iterate_batches(JTrainDataset(*args, cropping=40, frame_num=2), 3))
    got = list(iterate_batches(TrainDataset(*args, cropping=40, frame_num=2), 3, num_workers=4))
    assert len(got) == len(want) == 4
    for (gi, ga), (wi, wa) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(ga, wa)


def test_early_stopping_matches_jax(tmp_path):
    from semi_supervised_vos_tpu.train.early_stopping import plateau_update as jax_plateau_update
    from semi_supervised_vos_tpu.train.early_stopping import PlateauMonitor as JMonitor
    from semi_supervised_vos_tpu_torch.train.early_stopping import EarlyStopping, PlateauMonitor, plateau_update

    losses = [3.0, float("nan"), 2.0, 2.5, float("nan"), 2.2, 2.1, 2.05, 1.5, 1.6, 1.7]
    mon, jmon = PlateauMonitor(), JMonitor()
    for epoch, v in enumerate(losses):
        mon, imp, stop = plateau_update(mon, v, epoch, patience=3)
        jmon, jimp, jstop = jax_plateau_update(jmon, v, epoch, patience=3)
        assert (mon.best_loss, mon.best_epoch, mon.stale, imp, stop) == (
            jmon.best_loss, jmon.best_epoch, jmon.stale, jimp, jstop)
    saved = []
    stopper = EarlyStopping(tmp_path, patience=2, save_fn=saved.append)
    assert [stopper(v, e) for e, v in enumerate([2.0, 1.0, 1.5, float("nan"), 1.2])] == [False] * 4 + [True]
    assert saved == [tmp_path / "model.pth.tar"] * 2 and stopper.best_epoch == 1


def test_train_state_checkpoint_round_trip(tmp_path):
    """``save_checkpoint`` keeps the weights, the optimizer state and the
    epoch; ``load_weights`` restores all three, and a file with only a
    ``state_dict`` restores the weights and starts at epoch 0. A directory
    (a JAX package Orbax checkpoint) is refused."""
    from semi_supervised_vos_tpu_torch.models.convert import save_torch_checkpoint
    from semi_supervised_vos_tpu_torch.models.resnet import init_train_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
    from semi_supervised_vos_tpu_torch.train.train_state import load_weights, make_optimizer, save_checkpoint

    net = VOSNet("resnet18")
    init_train_weights(net, torch.Generator().manual_seed(1))
    opt = make_optimizer(net.parameters())
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    save_checkpoint(net, opt, 5, tmp_path / "full.pth.tar")
    save_torch_checkpoint(net, tmp_path / "weights.pth.tar")

    net2 = VOSNet("resnet18")
    opt2 = make_optimizer(net2.parameters())
    assert load_weights(tmp_path / "full.pth.tar", net2, opt2) == 5
    for (k, a), b in zip(net.state_dict().items(), net2.state_dict().values()):
        assert torch.equal(a, b), k
    bufs = [opt.state[p]["momentum_buffer"] for p in net.parameters()]
    assert all(torch.equal(a, opt2.state[p]["momentum_buffer"]) for a, p in zip(bufs, net2.parameters()))
    net3 = VOSNet("resnet18")
    opt3 = make_optimizer(net3.parameters())
    assert load_weights(tmp_path / "weights.pth.tar", net3, opt3) == 0
    assert not opt3.state
    (tmp_path / "jax.ckpt").mkdir()
    with pytest.raises(ValueError, match="pth.tar"):
        load_weights(tmp_path / "jax.ckpt", net3, opt3)


def torchvision_state_dict(seed=3):
    """A torchvision-format resnet18 state dict (``conv1``, ``bn1``,
    ``layer1..4``, ``fc``) with random values; its layer4 has torchvision's
    512 channels, which the VOS topology cannot take."""
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    g = torch.Generator().manual_seed(seed)
    names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3"}
    sd = {}
    for key, value in VOSNet("resnet18").state_dict().items():
        _, seq, rest = key.split(".", 2)
        if seq in names:
            sd[f"{names[seq]}.{rest}"] = torch.randn(value.shape, generator=g) if value.is_floating_point() else value
    sd["layer4.0.conv1.weight"] = torch.randn(512, 256, 3, 3, generator=g)
    sd["fc.weight"] = torch.randn(1000, 512, generator=g)
    return sd


def test_torchvision_backbone_matches_jax_conversion():
    """``--pretrained``: layer1..3, the stem and their BN come from the file,
    layer4 and the head keep their initialisation, as the JAX package's
    ``convert_torchvision_backbone`` merges them."""
    from semi_supervised_vos_tpu.models.convert import convert_torchvision_backbone
    from semi_supervised_vos_tpu_torch.models.convert import load_torchvision_backbone, state_dict_from_jax
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
    from tests.test_torch_models import jax_variables

    _, variables = jax_variables("resnet18", 2)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    sd = torchvision_state_dict()
    merged = convert_torchvision_backbone({k: v.numpy() for k, v in sd.items()}, variables, "resnet18")
    net = VOSNet("resnet18")
    start = state_dict_from_jax(variables, net)
    net.load_state_dict(start)
    load_torchvision_backbone(net, sd)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, merged), net)
    got = net.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], value), key
    assert torch.equal(got["backbone.7.0.conv1.weight"], start["backbone.7.0.conv1.weight"])
    assert torch.equal(got["backbone.0.weight"], sd["conv1.weight"])


def test_zoo_lookup_is_off_and_reads_a_local_mirror(tmp_path, monkeypatch):
    """``SVOS_ZOO=0``: no lookup. A ``file://`` mirror lands in the cache,
    keyed by the model, and a second lookup reads the cache."""
    from semi_supervised_vos_tpu_torch.models import zoo

    monkeypatch.setenv("SVOS_ZOO", "0")
    assert zoo.auto_pretrained_path("resnet50") is None
    src = tmp_path / "weights.pth"
    torch.save(torchvision_state_dict(), src)
    cache = tmp_path / "cache"
    got = zoo.fetch_pretrained("resnet18", url=src.as_uri(), cache_dir=cache)
    assert got == str(cache / "resnet18-weights.pth")
    assert Path(got).read_bytes() == src.read_bytes()
    src.unlink()
    assert zoo.fetch_pretrained("resnet18", url=src.as_uri(), cache_dir=cache) == got
