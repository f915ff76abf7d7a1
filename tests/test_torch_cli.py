"""Port CLI: ``python -m semi_supervised_vos_tpu_torch inference --device
cpu`` writes PNGs byte-identical to the JAX CLI's on a synthetic DAVIS tree,
``evaluation`` runs on them, the port never imports JAX, and a missing card
is an error rather than a silent CPU run."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from semi_supervised_vos_tpu.models.convert import export_torch_checkpoint
from semi_supervised_vos_tpu_torch.__main__ import cli
from tests.helpers import make_davis_dataset
from tests.test_torch_models import jax_variables, port_net

REPO = Path(__file__).resolve().parent.parent
# JAX, the JAX package, and the JAX package's benches at the root of the repo
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "semi_supervised_vos_tpu", "bench", "bench_train"}


@pytest.fixture(scope="module")
def davis_and_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("davis")
    make_davis_dataset(root, videos=("blackswan", "camel"), frames=5, size=(64, 80), objects=2)
    _, variables = jax_variables("resnet18", 1)
    ckpt = root / "ckpt.pth.tar"
    export_torch_checkpoint(jax.tree_util.tree_map(np.array, variables), str(ckpt), "resnet18")
    return root, ckpt


def _inference_args(root, ckpt, save):
    return ["inference", "-d", str(root), "-r", str(ckpt), "-m", "resnet18", "-s", str(save)]


def test_cli_pngs_byte_identical_to_jax(davis_and_ckpt, tmp_path):
    from semi_supervised_vos_tpu.cli.inference import inference_command_impl
    from semi_supervised_vos_tpu.eval.evaluation import evaluation_command_impl

    root, ckpt = davis_and_ckpt
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    inference_command_impl(
        ref_num=9, data=str(root), resume=str(ckpt), model="resnet18", temperature=1.0,
        frame_range=40, sigma_1=8.0, sigma_2=21.0, save=str(jax_out), device="cpu",
        inference_strategy="single", additional_resume=None, additional_model_type="resnet18",
        probability_propagation=False, scale=1.15, reduction="mean", disable=True,
    )
    res = CliRunner().invoke(cli, _inference_args(root, ckpt, port_out) + ["--device", "cpu"])
    assert res.exit_code == 0, res.output
    jax_pngs = sorted(p.relative_to(jax_out) for p in jax_out.rglob("*.png"))
    assert jax_pngs == sorted(p.relative_to(port_out) for p in port_out.rglob("*.png"))
    assert len(jax_pngs) == 10
    classes = set()
    for rel in jax_pngs:
        assert (port_out / rel).read_bytes() == (jax_out / rel).read_bytes(), rel
        classes.update(np.unique(np.asarray(Image.open(port_out / rel))).tolist())
    assert classes == {0, 1, 2}

    gt = root / "Annotations" / "480p"
    res = CliRunner().invoke(cli, ["evaluation", "-g", str(gt), "-c", str(port_out), "--processes", "1"])
    assert res.exit_code == 0, res.output
    from semi_supervised_vos_tpu_torch.eval.evaluation import evaluation_command_impl as port_eval

    assert port_eval(gt, port_out, processes=1) == evaluation_command_impl(gt, jax_out, processes=1)


def test_inference_path_never_imports_jax(davis_and_ckpt, tmp_path):
    """The single path, a two-stream strategy in probability mode, and the
    lockstep engine."""
    root, ckpt = davis_and_ckpt
    multi = ["--inference-strategy", "2-scale", "--probability", "--fusion", "maximum"]
    lockstep = ["--inference-strategy", "hor-flip", "--video-batch", "2"]
    code = (
        "import sys\n"
        "from semi_supervised_vos_tpu_torch.__main__ import cli\n"
        f"cli({_inference_args(root, ckpt, tmp_path / 'out') + ['--device', 'cpu']!r}, standalone_mode=False)\n"
        f"cli({_inference_args(root, ckpt, tmp_path / 'multi') + ['--device', 'cpu'] + multi!r}, "
        "standalone_mode=False)\n"
        f"cli({_inference_args(root, ckpt, tmp_path / 'lockstep') + ['--device', 'cpu'] + lockstep!r}, "
        "standalone_mode=False)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
    assert len(list((tmp_path / "out").rglob("*.png"))) == 10
    assert len(list((tmp_path / "multi").rglob("*.png"))) == 10
    assert len(list((tmp_path / "lockstep").rglob("*.png"))) == 10


def test_package_source_never_imports_jax():
    files = sorted((REPO / "semi_supervised_vos_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_encode_takes_a_tensor_as_a_numpy_batch():
    """``PropagationEngine.encode`` gives the same features for a numpy
    batch and for the same batch as a uint8 tensor (read in place on the
    engine's device); another dtype is refused."""
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine

    _, variables = jax_variables("resnet18", 1)
    engine = PropagationEngine(port_net("resnet18", variables), (40, 48), EngineConfig(), "cpu")
    frames = np.random.default_rng(0).integers(0, 255, (3, 40, 48, 3), dtype=np.uint8)
    want = engine.encode(frames)
    assert want.shape == (3, engine.p, 256)
    assert torch.equal(engine.encode(torch.as_tensor(frames)), want)
    with pytest.raises(TypeError, match="uint8"):
        engine.encode(torch.as_tensor(frames).float())


def test_missing_card_is_an_error(davis_and_ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device would run")
    root, ckpt = davis_and_ckpt
    res = CliRunner().invoke(cli, _inference_args(root, ckpt, tmp_path / "out"))
    assert res.exit_code != 0
    assert "no CUDA device" in res.output
    assert not list(tmp_path.rglob("*.png"))


@pytest.mark.parametrize(
    "flags",
    [["--video-batch", "2", "--bank-shards", "2"], ["--dp-shards", "2"], ["--video-batch", "2", "--dp-shards", "2"],
     ["--bank-shards", "2"]],
)
def test_unported_options_raise(davis_and_ckpt, tmp_path, flags):
    """The multi-device options run on the CPU's virtual mesh; only what the
    JAX CLI refuses is refused, with its message (``--dp-shards`` without
    ``--video-batch``). ``tests/test_torch_batched_dp.py`` holds their PNGs
    against the unsharded runs."""
    root, ckpt = davis_and_ckpt
    res = CliRunner().invoke(cli, _inference_args(root, ckpt, tmp_path / "out") + ["--device", "cpu"] + flags)
    if "--video-batch" not in flags and "--dp-shards" in flags:
        assert res.exit_code != 0
        assert "--dp-shards requires --video-batch > 1" in res.output
        assert not list(tmp_path.rglob("*.png"))
    else:
        assert res.exit_code == 0, res.output
        assert len(list((tmp_path / "out").rglob("*.png"))) == 10


def test_multimodel_needs_its_second_checkpoint(davis_and_ckpt, tmp_path):
    root, ckpt = davis_and_ckpt
    flags = ["--device", "cpu", "--inference-strategy", "multimodel"]
    res = CliRunner().invoke(cli, _inference_args(root, ckpt, tmp_path / "out") + flags)
    assert res.exit_code != 0
    assert "--additional-model" in res.output
    assert not list(tmp_path.rglob("*.png"))
