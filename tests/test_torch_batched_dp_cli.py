"""The port CLI's ``--bank-shards`` / ``--dp-shards`` refusals on the CPU,
with the JAX CLI's messages (the CLI's mesh runs are in
``test_torch_batched_dp_pngs.py``)."""

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from semi_supervised_vos_tpu.models.convert import export_torch_checkpoint
from semi_supervised_vos_tpu_torch.__main__ import cli
from tests.helpers import make_davis_dataset
from tests.test_torch_models import jax_variables


@pytest.fixture(scope="module", autouse=True)
def one_compute_thread():
    """One intra-op thread (imported by the other ``test_torch_batched_dp``
    files): beside the suite's other workers, more threads only contend
    (alone those files' tests took a twentieth of their time in the
    suite)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def davis_and_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis_dp")
    make_davis_dataset(root, videos=("blackswan", "camel", "dog"), frames=5, size=(40, 48), objects=2)
    _, variables = jax_variables("resnet18", 1)
    ckpt = root / "ckpt.pth.tar"
    export_torch_checkpoint(jax.tree_util.tree_map(np.array, variables), str(ckpt), "resnet18")
    return root, ckpt


# every strategy, and probability mode with one stream and with two fused
STRATEGIES = {name: ["--inference-strategy", name]
              for name in ("single", "hor-flip", "vert-flip", "2-scale", "hor-2-scale", "multimodel", "3-scale")}
STRATEGIES["single-probability"] = ["--probability"]
STRATEGIES["hor-flip-probability-maximum"] = ["--inference-strategy", "hor-flip", "--probability",
                                              "--fusion", "maximum"]


def _run(root, ckpt, save, *flags):
    args = ["inference", "-d", str(root), "-r", str(ckpt), "-m", "resnet18", "-s", str(save), "--device", "cpu",
            *flags]
    if "multimodel" in flags:
        args += ["--additional-model", str(ckpt), "--additional-model-type", "resnet18"]
    return CliRunner().invoke(cli, args)


@pytest.mark.parametrize(
    "flags,message",
    [(["--bank-shards", "0"], "--dp-shards and --bank-shards must be >= 1."),
     (["--video-batch", "2", "--dp-shards", "0"], "--dp-shards and --bank-shards must be >= 1."),
     (["--dp-shards", "2"], "--dp-shards requires --video-batch > 1 (it shards lockstep video lanes over chips)."),
     (["--dp-shards", "2", "--bank-shards", "2"], "--dp-shards requires --video-batch > 1")],
)
def test_cli_mesh_refusals(davis_and_ckpt, tmp_path, flags, message):
    """The JAX CLI's refusals, with its messages, before any PNG is written."""
    root, ckpt = davis_and_ckpt
    res = _run(root, ckpt, tmp_path, *flags)
    assert res.exit_code != 0
    assert message in res.output
    assert not list(tmp_path.rglob("*.png"))
