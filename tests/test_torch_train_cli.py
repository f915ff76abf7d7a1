"""Port CLI parity for training: ``python -m semi_supervised_vos_tpu_torch
train --device cpu`` against the JAX package's ``train_command_impl`` for
two epochs from one ``--resume`` checkpoint (the losses in the checkpoint
names agree to 1e-4 relative, and the final weights, all tensors in one
vector, to 1e-4 of its norm), ``validation`` against
the JAX package's on the port's checkpoints, the port's checkpoints in the
JAX package's loader and in the port's ``inference``; the options that are
not ported, a missing card, and a run that never imports JAX.

The resume checkpoint holds flax variables with BN scales and biases cut to
5 % (``tests/test_torch_train_step.py`` says why). Training a batch this
small is chaotic: at ``--lr 0.02`` and ``--bs 2`` the JAX package drifts
from itself, with its other convolution implementation (``matmul``), by
2e-4 of the loss at the third step and 2e-2 at the fifth, exactly as far as
the port drifts from it. At ``--lr 0.002`` and ``--bs 5`` (two steps an
epoch) both drifts stay under 5e-5 of the loss over the four steps, and
7e-6 of the weights' norm (measured: the JAX package's matmul variant
7.3e-6, the port 6.6e-6). Both sides draw
their augmentation on one thread (``SVOS_NUM_WORKERS=1``): the JAX
package's thread pool would hand the draws to items in thread order."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from semi_supervised_vos_tpu.models.convert import export_torch_checkpoint
from semi_supervised_vos_tpu_torch.__main__ import cli
from semi_supervised_vos_tpu_torch.models.convert import state_dict_from_jax
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from tests.helpers import make_davis_dataset
from tests.test_torch_cli import FORBIDDEN
from tests.test_torch_train_step import train_variables

REPO = Path(__file__).resolve().parent.parent
EPOCHS = 2
NAME = re.compile(r"checkpoint-epoch-(\d{3})-\s*([0-9.a-z]+)-\s*([0-9.a-z]+)\.(ckpt|pth\.tar)$")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The same two-epoch run through both CLIs."""
    from semi_supervised_vos_tpu.cli.train import train_command_impl

    root = tmp_path_factory.mktemp("train")
    # 32x40 frames: the default crop (256) takes the whole frame on both sides
    make_davis_dataset(root / "davis", videos=("a", "b"), frames=5, size=(32, 40), objects=2)
    resume = root / "resume.pth.tar"
    export_torch_checkpoint(train_variables("resnet18", 7), str(resume), "resnet18")
    mp = pytest.MonkeyPatch()
    mp.setenv("SVOS_NUM_WORKERS", "1")
    mp.setenv("SVOS_ZOO", "0")
    try:
        state = train_command_impl(
            frame_num=3, training=str(root / "davis"), validation=str(root / "davis"), resume=str(resume),
            save_model=str(root / "jax"), epochs=EPOCHS, bs=5, lr=0.002, loss="cross_entropy", freeze=False,
            miner="default", margin=0.1, loss_weight=1.0, max_triplets=0, early_stop=False, model_name="resnet18",
            device="cpu", disable=True,
        )
        res = CliRunner().invoke(cli, [
            "train", "-t", str(root / "davis"), "-v", str(root / "davis"), "-r", str(resume), "-m", str(root / "port"),
            "--epochs", str(EPOCHS), "--bs", "5", "--lr", "0.002", "-n", "3", "--model", "resnet18",
            "--device", "cpu", "--no-early-stop",
        ], env={"SVOS_NUM_WORKERS": "1"})
        assert res.exit_code == 0, res.output
    finally:
        mp.undo()
    return root, state


def _names(directory):
    return sorted(NAME.match(p.name).groups()[:3] for p in directory.iterdir() if NAME.match(p.name))


def test_train_cli_matches_jax(trained):
    root, state = trained
    jax_names, port_names = _names(root / "jax"), _names(root / "port")
    assert [n[0] for n in port_names] == [n[0] for n in jax_names] == ["000", "001"]
    for (_, jt, jv), (_, pt, pv) in zip(jax_names, port_names):
        np.testing.assert_allclose(float(pt), float(jt), rtol=1e-4)
        assert (jv == "nan") == (pv == "nan")
        if jv != "nan":
            np.testing.assert_allclose(float(pv), float(jv), rtol=1e-4)
    last = sorted((root / "port").glob("checkpoint-epoch-001-*.pth.tar"))[0]
    ckpt = torch.load(last, weights_only=True)
    assert ckpt["epoch"] == EPOCHS and "optimizer" in ckpt
    net = VOSNet("resnet18")
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                                    "batch_stats": state.batch_stats}), net)
    start = torch.load(root / "resume.pth.tar", weights_only=True)["state_dict"]
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    flat = lambda sd: torch.cat([sd[k].flatten().float() for k in keys])  # noqa: E731
    # the whole state in norm: single tensors drift by up to 5 % of their
    # largest entry, as far from the JAX package as its own matmul variant
    assert (flat(ckpt["state_dict"]) - flat(want)).norm() <= 1e-4 * flat(want).norm()
    assert (flat(want) - flat(start)).norm() >= 1e-3 * flat(want).norm()  # training moved the weights


def test_validation_cli_matches_jax(trained, tmp_path):
    from semi_supervised_vos_tpu.cli.validation import validation_command_impl as jax_validation

    root, _ = trained
    out = tmp_path / "val.json"
    res = CliRunner().invoke(cli, ["validation", "-d", str(root / "davis"), "-c", str(root / "port"), "--bs", "2",
                                   "--model", "resnet18", "--device", "cpu", "-o", str(out)])
    assert res.exit_code == 0, res.output
    import json

    got = json.loads(out.read_text())
    want = jax_validation(str(root / "davis"), str(root / "port"), 2, "cross_entropy", "default", 0.1, 6.0, None,
                          model_name="resnet18", device="cpu", disable=True)
    assert sorted(got) == sorted(want) and len(got) == EPOCHS
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4)


def test_port_checkpoint_loads_in_jax_and_port_inference(trained, tmp_path):
    from semi_supervised_vos_tpu.models.convert import load_torch_checkpoint as jax_load

    root, _ = trained
    last = sorted((root / "port").glob("checkpoint-epoch-001-*.pth.tar"))[0]
    variables = jax_load(str(last), "resnet18")
    net = VOSNet("resnet18")
    sd = torch.load(last, weights_only=True)["state_dict"]
    for key, value in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables), net).items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(value, sd[key]), key
    res = CliRunner().invoke(cli, ["inference", "-d", str(root / "davis"), "-r", str(last), "-m", "resnet18",
                                   "-s", str(tmp_path / "pred"), "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert len(list((tmp_path / "pred").rglob("*.png"))) == 10


def test_validation_refuses_orbax_checkpoints(trained, tmp_path):
    root, _ = trained
    res = CliRunner().invoke(cli, ["validation", "-d", str(root / "davis"), "-c", str(root / "jax"),
                                   "--model", "resnet18", "--device", "cpu"])
    assert res.exit_code != 0
    assert "Orbax" in res.output and "pth.tar" in res.output


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--model", "facebook", "--tp", "2"]])
def test_unported_train_options_raise(trained, tmp_path, flags):
    """``--tp 2`` on the one CPU device is refused with the JAX CLI's rule
    (``--device cpu`` is one device, as a JAX host without virtual
    devices); every model takes ``--tp``. The rules on more devices:
    ``tests/test_torch_train_mesh_cli.py``."""
    root, _ = trained
    res = CliRunner().invoke(cli, ["train", "-t", str(root / "davis"), "-v", str(root / "davis"),
                                   "-m", str(tmp_path / "ck"), "--device", "cpu", *flags])
    assert res.exit_code != 0
    assert "--tp 2 must be between 1 and the 1 available device(s)." in res.output
    assert not (tmp_path / "ck").exists() or not list((tmp_path / "ck").iterdir())


def test_validation_refuses_facebook_like_jax(trained):
    """The JAX validation CLI offers resnet18, resnet50 and resnet101 only:
    ``--model facebook`` is a usage error in both."""
    from semi_supervised_vos_tpu.cli.validation import validation_command as jax_validation_command

    root, _ = trained
    args = ["-d", str(root / "davis"), "-c", str(root / "port"), "--model", "facebook", "--device", "cpu"]
    port = CliRunner().invoke(cli, ["validation", *args])
    ref = CliRunner().invoke(jax_validation_command, args)
    assert port.exit_code == ref.exit_code == 2  # click's usage error
    assert "Invalid value for '--model'" in port.output and "Invalid value for '--model'" in ref.output


def test_missing_card_is_an_error_for_train_and_validation(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device would run")
    root, _ = trained
    for args in (["train", "-t", str(root / "davis"), "-v", str(root / "davis"), "-m", str(tmp_path / "ck")],
                 ["validation", "-d", str(root / "davis"), "-c", str(root / "port")]):
        res = CliRunner().invoke(cli, args + ["--model", "resnet18"], env={"SVOS_ZOO": "0"})
        assert res.exit_code != 0
        assert "no CUDA device" in res.output
    assert not (tmp_path / "ck").exists() or not list((tmp_path / "ck").iterdir())


def test_train_path_never_imports_jax(trained, tmp_path):
    """train from a torchvision ``--pretrained`` file with a triplet loss and
    a morphology miner, then validation."""
    from tests.test_torch_train import torchvision_state_dict

    root, _ = trained
    torch.save(torchvision_state_dict(), tmp_path / "imagenet.pth")
    train = ["train", "-t", str(root / "davis"), "-v", str(root / "davis"), "-m", str(tmp_path / "ck"),
             "--epochs", "1", "--bs", "2", "-n", "3", "--model", "resnet18", "--device", "cpu",
             "--loss", "triplet", "--miner", "skeleton", "--pretrained", str(tmp_path / "imagenet.pth")]
    val = ["validation", "-d", str(root / "davis"), "-c", str(tmp_path / "ck"), "--bs", "2", "--model", "resnet18",
           "--device", "cpu", "--loss", "triplet", "--miner", "skeleton"]
    code = (
        "import os, sys\n"
        "os.environ['SVOS_ZOO'] = '0'\n"
        "from semi_supervised_vos_tpu_torch.__main__ import cli\n"
        f"cli({train!r}, standalone_mode=False)\n"
        f"cli({val!r}, standalone_mode=False)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    # one compute thread: beside the suite's other workers, more only contend
    env = dict(os.environ, OMP_NUM_THREADS="1", SVOS_NUM_WORKERS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
    assert len(list((tmp_path / "ck").glob("checkpoint-epoch-000-*.pth.tar"))) == 1
