"""Port parity for the ``facebook`` model (the torchvision-shaped resnet50:
2048-wide layer4 at stride 8, a two-conv head) against the JAX package on
the CPU, at float32 and tiny shapes:

  * the module forward, with weights carried across by
    ``state_dict_from_jax``, against ``VOSNet("facebook").apply`` (rtol and
    atol 2e-4, tighter than the 1e-3 / 2e-3 of the JAX package's own
    facebook test against the reference);
  * the BN-folded ``fast_encode`` against the module and against the JAX
    package's fast encoder (its Pallas bottleneck in interpret mode), and
    the ``head0`` / ``head`` entries of ``fold_vosnet`` against the JAX fold;
  * ``load_torchvision_backbone`` keeping layer4, against
    ``convert_torchvision_backbone``; the port's checkpoint in the JAX
    package's loader and the JAX package's export in the port's;
  * one train step and one ``--freeze`` step against the JAX package's;
  * the lane envelope of the lockstep engine for facebook, and the zoo URL;
  * the engines leave PyTorch's TF32 flags as the caller set them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.models.convert import convert_torchvision_backbone, export_torch_checkpoint
from semi_supervised_vos_tpu.models.convert import load_torch_checkpoint as jax_load_checkpoint
from semi_supervised_vos_tpu.models.fold import fold_vosnet as jax_fold_vosnet
from semi_supervised_vos_tpu.models.infer_fast import build_fast_encoder
from semi_supervised_vos_tpu_torch.infer import batched
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.models.convert import (
    load_torch_checkpoint,
    load_torchvision_backbone,
    save_torch_checkpoint,
    state_dict_from_jax,
)
from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
from semi_supervised_vos_tpu_torch.models.infer_fast import fast_encode
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from tests.test_torch_models import jax_variables, port_net
from tests.test_torch_train_step import assert_states_match, jax_step, make_clip, port_step, specs, train_variables

ARCH = "facebook"


@pytest.fixture(scope="module")
def pair():
    jnet, variables = jax_variables(ARCH, 3)
    return jnet, variables, port_net(ARCH, variables)


def test_module_topology():
    net = VOSNet(ARCH)
    sd = net.state_dict()
    assert sd["backbone.7.0.downsample.0.weight"].shape == (2048, 1024, 1, 1)  # layer4_0 widens
    assert sd["backbone.7.2.conv3.weight"].shape == (2048, 512, 1, 1)
    assert sd["adjust_dim.0.weight"].shape == (1024, 2048, 1, 1)
    assert sd["adjust_dim.1.weight"].shape == (256, 1024, 1, 1)
    assert not any(k.startswith("adjust_dim.") and "bias" in k for k in sd)
    with torch.no_grad():
        assert net.eval()(torch.zeros(1, 3, 40, 56)).shape == (1, 256, 5, 7)


def test_module_matches_flax(pair, rng):
    jnet, variables, net = pair
    x = (rng.standard_normal((2, 40, 48, 3)) * 0.7).astype(np.float32)
    expect = np.asarray(jnet.apply(variables, x, train=False))
    with torch.no_grad():
        got = net(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == expect.shape == (2, 5, 6, 256)
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-4)


def test_fast_encode_matches_module_and_jax_fast_encoder(pair, rng):
    _, variables, net = pair
    x = (rng.standard_normal((2, 48, 40, 3)) * 0.7).astype(np.float32)
    encode = build_fast_encoder(variables, dtype=jnp.float32, use_fused_stack=True, interpret=True, arch=ARCH)
    expect = np.asarray(encode(jnp.asarray(x)))
    with torch.no_grad():
        got = fast_encode(fold_vosnet(net, torch.float32), torch.as_tensor(x), torch.float32, arch=ARCH).numpy()
        module = net(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == expect.shape == (2, 6, 5, 256)
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, module, rtol=2e-4, atol=2e-4)


def test_fold_head_matches_jax_fold(pair):
    _, variables, net = pair
    jtable = jax_fold_vosnet(variables, ARCH, jnp.float32)
    table = fold_vosnet(net, torch.float32)
    for name in ("head0", "head", "layer4_0/downsample", "layer4_2/conv3"):
        kernel = table[f"{name}/kernel"].permute(2, 3, 1, 0).numpy()  # OIHW → HWIO
        np.testing.assert_allclose(kernel, np.asarray(jtable[f"{name}/kernel"]), rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(table[f"{name}/bias"].numpy(), np.asarray(jtable[f"{name}/bias"]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert not table["head0/bias"].any()
    assert table["head0/kernel"].shape == (1024, 2048, 1, 1) and table["head/kernel"].shape == (256, 1024, 1, 1)
    # every bottleneck without a downsample has its fused operands, the
    # 2048-wide layer4_1..2 too (run_block sends those to cuDNN)
    fused = sorted(k.split("/")[0] for k in table if k.endswith("/fused"))
    assert fused == sorted(f"layer{s}_{b}" for s, n in ((1, 3), (2, 4), (3, 6), (4, 3)) for b in range(1, n))
    assert {k.split("/")[0] for k in jtable} - {k.split("/")[0] for k in table} == set()


def torchvision_resnet50_state_dict(seed=4):
    """A torchvision-format resnet50 state dict with random values: the
    facebook backbone's keys under torchvision's names, plus ``fc``."""
    g = torch.Generator().manual_seed(seed)
    names = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4"}
    sd = {}
    for key, value in VOSNet(ARCH).state_dict().items():
        parts = key.split(".", 2)
        if parts[0] == "backbone" and parts[1] in names:
            sd[f"{names[parts[1]]}.{parts[2]}"] = (torch.randn(value.shape, generator=g) if value.is_floating_point()
                                                   else value)
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


def test_torchvision_backbone_keeps_layer4_like_jax(pair):
    """``--pretrained`` for facebook: the whole backbone, layer4 included,
    comes from the file and only ``fc`` is dropped, as the JAX package's
    ``convert_torchvision_backbone`` merges it; the head keeps its
    initialisation."""
    _, variables, _ = pair
    variables = jax.tree_util.tree_map(np.asarray, variables)
    sd = torchvision_resnet50_state_dict()
    merged = convert_torchvision_backbone({k: v.numpy() for k, v in sd.items()}, variables, ARCH)
    net = VOSNet(ARCH)
    start = state_dict_from_jax(variables, net)
    net.load_state_dict(start)
    load_torchvision_backbone(net, sd)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, merged), net)
    got = net.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], value), key
    assert torch.equal(got["backbone.7.2.conv3.weight"], sd["layer4.2.conv3.weight"])
    assert torch.equal(got["adjust_dim.0.weight"], start["adjust_dim.0.weight"])


def test_checkpoints_cross_both_ways(pair, tmp_path):
    """The port's ``.pth.tar`` in the JAX package's ``load_torch_checkpoint``
    and the JAX package's ``export_torch_checkpoint`` in the port's loader,
    bit for bit."""
    _, variables, net = pair
    save_torch_checkpoint(net, tmp_path / "port.pth.tar")
    back = jax_load_checkpoint(str(tmp_path / "port.pth.tar"), ARCH)
    for tree in ("params", "batch_stats"):
        flat_want = jax.tree_util.tree_leaves_with_path(variables[tree])
        flat_got = dict(jax.tree_util.tree_leaves_with_path(back[tree]))
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_want:
            np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(leaf), err_msg=str(path))
    export_torch_checkpoint(jax.tree_util.tree_map(np.array, variables), str(tmp_path / "jax.pth.tar"), ARCH)
    loaded = load_torch_checkpoint(tmp_path / "jax.pth.tar", VOSNet(ARCH))
    for key, value in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key


@pytest.mark.parametrize("freeze", [False, True])
def test_train_step_matches_jax(freeze):
    """One cross-entropy step at 32² crops from the same variables (BN scales
    and biases cut to 5 %, as in ``tests/test_torch_train_step.py``); the
    loss agrees to rtol 1e-5.

    With ``--freeze`` only ``adjust_dim.0``, ``adjust_dim.1`` and ``bn256``
    train, the backbone is bit-unchanged on both sides, and every parameter
    and running statistic agrees to rtol 1e-4 / atol 1e-6.

    The full step is held on the whole state: the difference to 1e-4 of
    the state's norm (the bar of ``tests/test_torch_train_cli.py``) and to
    2e-3 of the step's update. Per tensor, the backward through 54 BN layers
    that see 96 values a channel in layer4 moves a small update by up to a
    quarter, and the JAX package drifts from itself as far, in each of
    these measures, with its other convolution implementation
    (``conv_impl("matmul")``)."""
    variables = train_variables(ARCH, 6)
    imgs, anns = make_clip(seed=3)
    jspec, tspec = specs("cross_entropy")
    j_loss, j_vars = jax_step(ARCH, variables, jspec, imgs, anns, freeze=freeze)
    t_loss, net = port_step(ARCH, variables, tspec, imgs, anns, freeze=freeze)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    before = state_dict_from_jax(variables, net)
    trainable = [name for name, p in net.named_parameters() if p.requires_grad]
    if freeze:
        assert trainable == ["adjust_dim.0.weight", "adjust_dim.1.weight", "bn256.weight", "bn256.bias"]
        assert assert_states_match(net, j_vars, before) > 50  # the head and the running statistics moved
        got = net.state_dict()
        for name, _ in net.named_parameters():
            assert torch.equal(got[name], before[name]) == name.startswith("backbone."), name
        return
    assert len(trainable) == len(list(net.parameters()))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_vars), net)
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    flat = lambda sd: torch.cat([sd[k].flatten() for k in keys])  # noqa: E731
    diff = (flat(net.state_dict()) - flat(want)).norm()
    assert diff <= 1e-4 * flat(want).norm()
    assert diff <= 2e-3 * (flat(want) - flat(before)).norm()
    assert (flat(want) - flat(before)).norm() >= 1e-3 * flat(want).norm()  # the step moved the weights


def test_lane_envelope_per_arch():
    """facebook has its own, smaller lane envelope; resnet18/50/101 share
    the default one; multimodel clamps to the wider network's."""
    for hw in ((480, 854), (720, 1280), (1080, 1920)):
        default = batched._hbm_lanes_cap(hw)
        assert all(batched._hbm_lanes_cap(hw, arch) == default for arch in ("resnet18", "resnet50", "resnet101"))
        assert 1 <= batched._hbm_lanes_cap(hw, ARCH) < default
        for lanes in (1, 2):
            fb = batched._clamp_video_batch(10**6, lanes, hw, archs=(ARCH,))
            assert fb == max(1, batched._hbm_lanes_cap(hw, ARCH) // lanes)
            assert batched._clamp_video_batch(10**6, lanes, hw, archs=("resnet50", ARCH)) == fb
    small, large = batched._HBM_LANE_PX_ARCH[ARCH]
    assert batched._hbm_lanes_cap((480, 854), ARCH) == small // batched._HBM_ANCHOR_P_SMALL
    assert batched._hbm_lanes_cap((1080, 1920), ARCH) == large // batched._HBM_ANCHOR_P_LARGE


def test_zoo_names_the_swsl_checkpoint(tmp_path, monkeypatch):
    """``train --model facebook`` without ``--pretrained`` looks up the swsl
    resnet50 as the JAX CLI does (the same URL); ``SVOS_ZOO=0`` skips it, and
    a ``file://`` mirror of a torchvision-format file loads with layer4."""
    from semi_supervised_vos_tpu.models.zoo import MODEL_ZOO_URLS as JAX_URLS
    from semi_supervised_vos_tpu_torch.models import zoo

    assert zoo.MODEL_ZOO_URLS == JAX_URLS
    monkeypatch.setenv("SVOS_ZOO", "0")
    assert zoo.auto_pretrained_path(ARCH) is None
    src = tmp_path / "swsl.pth"
    torch.save(torchvision_resnet50_state_dict(), src)
    got = zoo.fetch_pretrained(ARCH, url=src.as_uri(), cache_dir=tmp_path / "cache")
    assert got == str(tmp_path / "cache" / "facebook-swsl.pth")
    net = load_torchvision_backbone(VOSNet(ARCH), torch.load(got, weights_only=True))
    assert torch.equal(net.state_dict()["backbone.7.0.downsample.0.weight"],
                       torch.load(src, weights_only=True)["layer4.0.downsample.0.weight"])


@pytest.mark.parametrize("flags", [(True, True), (False, False), (True, False)])
def test_engines_leave_tf32_flags_alone(flags):
    """Building a single and a lockstep engine and running one step of each
    leaves ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` as the caller set them."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        net = VOSNet("resnet18").eval()
        nprng = np.random.default_rng(0)
        frames = nprng.integers(0, 255, (2, 2, 32, 32, 3), dtype=np.uint8)
        labels = np.zeros((2, 32, 32), np.int32)
        labels[:, 8:20, 8:20] = 1
        engine = PropagationEngine(net, (32, 32), EngineConfig(), "cpu")
        engine.step_chunk_small(frames[1:, 0], engine.start_video(frames[0, 0], labels[0]), 1)
        lockstep = batched.BatchedPropagationEngine(net, (32, 32), 2, EngineConfig(), "cpu")
        lockstep.step_chunk_small(frames[1:], lockstep.start_videos(frames[0], labels), 1)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_full_float32_scope_restores_flags_on_an_exception():
    """The encoder's float32 stem runs in a scope that turns TF32 off for
    itself and puts both flags back, also when the block raises."""
    from semi_supervised_vos_tpu_torch.models.infer_fast import _full_float32

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
        with pytest.raises(RuntimeError, match="inside"):
            with _full_float32():
                assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
                raise RuntimeError("inside")
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
