"""The port's train bench (``semi_supervised_vos_tpu_torch/bench_train.py``)
against the JAX package's (``bench_train.py`` at the root, imported by
path), on the CPU:

  * the staged batches are byte-equal to the ones the JAX bench's default
    and loss-family modes build for seed 0, at a cut batch (its train step
    is replaced by one that keeps its arguments);
  * one port train step on that batch has the JAX ``make_train_step``'s
    loss within 1e-5 relative (resnet18, the weights of
    ``tests/test_torch_train_step.py``, bs 2 x 3 x 128²: the object's box
    starts at row 64, so a 64² crop would hold background only);
  * ``_build_disk_dataset`` writes the same files;
  * ``step_tflop`` comes from the count (conv_flops and the loss's products)
    and ``--device cpu`` nulls every rate;
  * without a card the default device exits non-zero and prints no value.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.train import loop as jloop
from semi_supervised_vos_tpu_torch import bench_train as bt
from semi_supervised_vos_tpu_torch.models.convert import state_dict_from_jax
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from semi_supervised_vos_tpu_torch.train import loop as tloop
from semi_supervised_vos_tpu_torch.utils import benchmarking as bm
from tests.test_torch_bench import REPO, load_root
from tests.test_torch_train_step import jax_step, train_variables


@pytest.fixture
def jbt(monkeypatch):
    """The JAX bench at a cut batch, its backend set-up, train state and
    train step replaced: each step keeps its batch and returns loss 1."""
    import semi_supervised_vos_tpu.train.loop as jax_loop
    import semi_supervised_vos_tpu.train.train_state as jax_state
    import semi_supervised_vos_tpu.utils.runtime as jax_runtime

    module = load_root("bench_train")
    monkeypatch.setattr(module, "BS", 1)
    monkeypatch.setattr(module, "FRAMES", 2)
    batches = []

    def make_train_step(*args, **kwargs):
        def step(state, imgs, anns, *rest):
            batches.append((np.asarray(imgs), np.asarray(anns)))
            return state, jnp.float32(1.0)

        return step

    monkeypatch.setattr(jax_runtime, "setup_backend", lambda: None)
    monkeypatch.setattr(jax_state, "init_train_state", lambda *a, **k: None)
    monkeypatch.setattr(jax_loop, "make_train_step", make_train_step)
    module.batches = batches
    return module


def test_staged_batches_equal_jax(jbt, monkeypatch, capsys):
    jbt.main()
    want = bt.synthetic_batch(np.random.default_rng(0), 1, 2, 256)
    assert len(jbt.batches) == 1 + jbt.PASSES
    for got, w in zip(jbt.batches[0], want):
        assert got.dtype == w.dtype and got.tobytes() == w.tobytes()

    monkeypatch.setenv("SVOS_BENCH_LOSS", "cross_entropy")
    jbt.batches.clear()
    jbt.loss_family_bench()
    want = bt.synthetic_batch(np.random.default_rng(0), 1, 2, 256, second_object=True)
    for got, w in zip(jbt.batches[0], want):
        assert got.tobytes() == w.tobytes()
    assert len(np.unique(want[1].reshape(-1, 3), axis=0)) == 3  # background and two objects
    capsys.readouterr()


def test_one_step_loss_matches_jax():
    variables = train_variables("resnet18", 5)
    imgs, anns = bt.synthetic_batch(np.random.default_rng(0), 2, 3, 128)
    j_loss, _ = jax_step("resnet18", variables, jloop.LossSpec(name="cross_entropy"), imgs, anns)

    net = VOSNet("resnet18")
    net.load_state_dict(state_dict_from_jax(variables, net))
    net.train()
    step = bt.make_step(net, tloop.LossSpec(name="cross_entropy"), False, torch.device("cpu"))
    t_loss = step(torch.as_tensor(imgs), torch.as_tensor(anns)).item()
    assert j_loss > 0.01  # two classes in the crop: a real loss
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)


def test_disk_dataset_files_equal_jax(tmp_path):
    jbt = load_root("bench_train")
    jroot = jbt._build_disk_dataset(tmp_path / "jax", videos=1, frames=2)
    root = bt._build_disk_dataset(tmp_path / "port", videos=1, frames=2)
    want = sorted(p.relative_to(jroot) for p in jroot.rglob("*") if p.is_file())
    assert want == sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())
    assert len(want) == 5  # two JPEGs, two PNGs, the marker
    for rel in want:
        assert (root / rel).read_bytes() == (jroot / rel).read_bytes(), rel


def test_step_tflop_from_the_count_and_cpu_nulls():
    proto = bt.TrainProtocol(bs=2, frames=3, crop=64, passes=1, arch="resnet18", bf16=False)
    out = bt.train_bench(proto, torch.device("cpu"))
    conv = bm.conv_flops(VOSNet("resnet18"), torch.zeros(1, 3, 64, 64))  # real tensors, not the meta count
    p = 8 * 8
    loss = 2.0 * 2 * 2 * p * p * (256 + 22)  # 2 clips x 2 reference frames: similarity and label product
    assert out["step_tflop"] == pytest.approx(3 * (2 * 3 * conv + loss) / 1e12, rel=1e-12)
    assert out["metric"] == "train_steps_per_sec_bs2_3f_64"
    for key in ("value", "median_steps_per_sec", "effective_tflops", "mfu"):
        assert out[key] is None, key
    assert out["device"]["platform"] == "cpu"
    json.dumps(out, allow_nan=False)


def test_no_card_exits_nonzero_without_a_value():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device would run")
    proc = subprocess.run([sys.executable, "-m", "semi_supervised_vos_tpu_torch.bench_train"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"value"' not in proc.stdout
