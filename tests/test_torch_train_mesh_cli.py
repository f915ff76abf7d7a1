"""The port's ``train`` and ``validation`` over a mesh of devices against the
JAX package's CLIs on its 8 virtual CPU devices: ``train --tp 2`` (a 4 x 2
mesh on both sides) for two epochs, one step each, from one ``--resume``
checkpoint (the first step's loss to 1e-5 relative, the later losses to
1e-3); the ``--tp 2`` checkpoint reloaded on one device and split again;
``validation`` sharded over 4 devices; and every mesh rule's message, word
for word.

The port's mesh is passed as ``devices=[cpu] * n`` (``--device cpu`` alone
is one device, as a JAX host without virtual devices). The resume
checkpoint and the learning rate are ``tests/test_torch_train_cli.py``'s
well-conditioned ones."""

import re

import click
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.models.convert import export_torch_checkpoint
from semi_supervised_vos_tpu_torch.cli.train import train_command_impl
from semi_supervised_vos_tpu_torch.cli.validation import validation_command_impl
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh
from semi_supervised_vos_tpu_torch.parallel.tp import shard_tp
from semi_supervised_vos_tpu_torch.train.train_state import load_weights, make_optimizer
from tests.helpers import make_davis_dataset
from tests.test_torch_train_step import train_variables

CPU = torch.device("cpu")
NAME = re.compile(r"checkpoint-epoch-(\d{3})-\s*([0-9.a-z]+)-\s*([0-9.a-z]+)\.(ckpt|pth\.tar)$")
ARGS = dict(frame_num=3, epochs=2, bs=4, lr=0.002, loss="cross_entropy", freeze=False, miner="default", margin=0.1,
            loss_weight=1.0, max_triplets=0, early_stop=False, model_name="resnet18", device="cpu", disable=True)


@pytest.fixture(scope="module", autouse=True)
def one_compute_thread():
    """One intra-op thread for the port's side: beside the suite's other
    workers, more only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The same two-epoch ``--tp 2`` run through both CLIs: 4 clips, one
    step an epoch (``--bs 4``), validation at epoch 0 (``--bs 2``, which
    does not divide over 8 devices: unsharded, channel-sharded on the first
    data row)."""
    from semi_supervised_vos_tpu.cli.train import train_command_impl as jax_train

    root = tmp_path_factory.mktemp("train_mesh")
    make_davis_dataset(root / "davis", videos=("a",), frames=4, size=(32, 40), objects=2)
    resume = root / "resume.pth.tar"
    export_torch_checkpoint(train_variables("resnet18", 7), str(resume), "resnet18")
    data = dict(training=str(root / "davis"), validation=str(root / "davis"), resume=str(resume))
    mp = pytest.MonkeyPatch()
    mp.setenv("SVOS_NUM_WORKERS", "1")
    try:
        jax_train(save_model=str(root / "jax"), tp=2, **data, **ARGS)
        net = train_command_impl(save_model=str(root / "port"), tp=2, devices=[CPU] * 8, **data, **ARGS)
    finally:
        mp.undo()
    return root, net


def _names(directory):
    return sorted(NAME.match(p.name).groups()[:3] for p in directory.iterdir() if NAME.match(p.name))


def test_tp_train_cli_matches_jax(trained):
    root, _ = trained
    jax_names, port_names = _names(root / "jax"), _names(root / "port")
    assert [n[0] for n in port_names] == [n[0] for n in jax_names] == ["000", "001"]
    (_, jt0, jv0), (_, jt1, jv1) = jax_names
    (_, pt0, pv0), (_, pt1, pv1) = port_names
    np.testing.assert_allclose(float(pt0), float(jt0), rtol=1e-5)  # the first step
    np.testing.assert_allclose(float(pt1), float(jt1), rtol=1e-3)
    np.testing.assert_allclose(float(pv0), float(jv0), rtol=1e-3)  # after the first step
    assert jv1 == pv1 == "nan"


def test_tp_checkpoint_reloads_on_one_device_and_splits_again(trained):
    root, net = trained
    last = sorted((root / "port").glob("checkpoint-epoch-001-*.pth.tar"))[0]
    ckpt = torch.load(last, weights_only=True)
    assert ckpt["epoch"] == 2
    single = VOSNet("resnet18")
    optimizer = make_optimizer(single.parameters())
    assert load_weights(last, single, optimizer) == 2
    for key, value in net.state_dict().items():
        assert torch.equal(single.state_dict()[key], value), key
    # every parameter has its gathered momentum, in the single-device layout
    assert len(ckpt["optimizer"]["state"]) == len(list(single.parameters()))
    mnet = shard_tp(make_mesh(2, 2, devices=[CPU] * 4), single, optimizer)
    name = "backbone.5.0.conv2.weight"
    full = single.state_dict()[name]
    buf = optimizer.state[dict(single.named_parameters())[name]]["momentum_buffer"]
    for m, part in enumerate(mnet.tensors[name]):
        assert torch.equal(part, full.chunk(2)[m])
        assert torch.equal(mnet.optimizer.state[part]["momentum_buffer"], buf.chunk(2)[m])


def test_resume_onto_another_mesh(trained, tmp_path, monkeypatch):
    """A ``--tp 2`` checkpoint resumes data-parallel on two devices."""
    root, _ = trained
    last = sorted((root / "port").glob("checkpoint-epoch-001-*.pth.tar"))[0]
    monkeypatch.setenv("SVOS_NUM_WORKERS", "1")
    args = dict(ARGS, epochs=1)
    train_command_impl(training=str(root / "davis"), validation=str(root / "davis"), resume=str(last),
                       save_model=str(tmp_path), tp=1, devices=[CPU] * 2, **args)
    names = _names(tmp_path)
    assert [n[0] for n in names] == ["002"] and np.isfinite(float(names[0][1]))


def test_validation_cli_on_a_mesh_matches_jax(trained, monkeypatch):
    from semi_supervised_vos_tpu.cli.validation import validation_command_impl as jax_validation

    root, _ = trained
    lines = []
    monkeypatch.setattr("semi_supervised_vos_tpu_torch.utils.logging.logger.info", lines.append)
    args = (str(root / "davis"), str(root / "port"), 4, "cross_entropy", "default", 0.1, 6.0, None)
    got = validation_command_impl(*args, model_name="resnet18", device="cpu", disable=True, frame_num=3,
                                  devices=[CPU] * 4)
    want = jax_validation(*args, model_name="resnet18", device="cpu", disable=True, frame_num=3)
    assert "mesh: data=4 over 4 devices" in lines
    assert sorted(got) == sorted(want) and len(got) == 2
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5)


def _jax_message(tmp_path, **kw):
    from semi_supervised_vos_tpu.cli.train import train_command_impl as jax_train

    with pytest.raises(click.ClickException) as err:
        jax_train(training=str(tmp_path), validation=str(tmp_path), resume=None, save_model=str(tmp_path / "j"),
                  **dict(ARGS, **kw))
    return err.value.message


@pytest.mark.parametrize("tp,bs", [(16, 4), (3, 4), (2, 3)])
def test_train_mesh_errors_are_the_jax_cli_messages(trained, tmp_path, tp, bs):
    """--tp beyond the devices, --tp not dividing them, and a batch that
    does not divide over the data rows under --tp > 1."""
    root, _ = trained
    want = _jax_message(root / "davis", tp=tp, bs=bs, epochs=0)
    expect = {16: "--tp 16 must be between 1 and the 8 available device(s).",
              3: "--tp 3 must divide the device count (8); 2 device(s) would sit idle.",
              2: "--tp 2 needs batch size divisible by the data-parallel degree 4 (got --bs 3)."}[tp]
    assert want == expect
    with pytest.raises(click.ClickException) as err:
        train_command_impl(training=str(root / "davis"), validation=str(root / "davis"), resume=None,
                           save_model=str(tmp_path / "p"), **dict(ARGS, tp=tp, bs=bs, epochs=0, devices=[CPU] * 8))
    assert err.value.message == expect
    assert not (tmp_path / "p").exists()


def test_mesh_warnings_are_the_jax_cli_messages(trained, tmp_path, monkeypatch):
    """A batch that does not divide over the devices runs on one device,
    with the JAX CLIs' warning; a divisible one logs the mesh."""
    from semi_supervised_vos_tpu.cli.train import train_command_impl as jax_train
    from semi_supervised_vos_tpu.cli.validation import validation_command_impl as jax_validation

    root, _ = trained
    seen = {"jax": [], "port": []}
    monkeypatch.setattr("semi_supervised_vos_tpu.utils.logging.logger.warning", seen["jax"].append)
    monkeypatch.setattr("semi_supervised_vos_tpu_torch.utils.logging.logger.warning", seen["port"].append)
    port_info = []
    monkeypatch.setattr("semi_supervised_vos_tpu_torch.utils.logging.logger.info", port_info.append)
    data = dict(training=str(root / "davis"), validation=str(root / "davis"), resume=None)
    jax_train(save_model=str(tmp_path / "j"), **data, **dict(ARGS, bs=3, epochs=0))
    train_command_impl(save_model=str(tmp_path / "p"), **data, **dict(ARGS, bs=3, epochs=0, devices=[CPU] * 8))
    empty = tmp_path / "empty"
    empty.mkdir()
    val = (str(root / "davis"), str(empty), 3, "cross_entropy", "default", 0.1, 6.0, None)
    jax_validation(*val, model_name="resnet18", device="cpu", disable=True)
    validation_command_impl(*val, model_name="resnet18", device="cpu", disable=True, devices=[CPU] * 8)
    want = ["batch size 3 does not divide over 8 devices; running single-device (pick a divisible --bs to engage "
            "the mesh)"] * 2
    assert seen["jax"] == seen["port"] == want
    assert not any(line.startswith("mesh:") for line in port_info)
    train_command_impl(save_model=str(tmp_path / "p2"), **data, **dict(ARGS, tp=2, epochs=0, devices=[CPU] * 8))
    assert "mesh: data=4 x model=2 over 8 devices" in port_info
