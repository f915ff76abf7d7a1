"""Port parity for lockstep inference over a mesh on the CPU:
``DataParallelBatchedEngine`` (lanes over the data rows, optionally bank rows
over each row's devices) against the JAX package's on the 8 virtual host
devices and against the port's one-device lockstep engine; the CLI's
``--bank-shards`` / ``--dp-shards`` on a virtual CPU mesh against the port's
unsharded runs, for all seven strategies; the CLI's refusals."""

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from semi_supervised_vos_tpu.infer.batched import LaneFusion as JLaneFusion
from semi_supervised_vos_tpu.infer.engine import EngineConfig as JConfig
from semi_supervised_vos_tpu.models.convert import export_torch_checkpoint
from semi_supervised_vos_tpu.parallel.batched_dp import DataParallelBatchedEngine as JDataParallel
from semi_supervised_vos_tpu.parallel.mesh import make_mesh as jmake_mesh
from semi_supervised_vos_tpu_torch.__main__ import cli
from semi_supervised_vos_tpu_torch.infer import batched
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig
from semi_supervised_vos_tpu_torch.parallel.batched_dp import BankShardedBatchedEngine, DataParallelBatchedEngine
from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh
from tests.helpers import make_davis_dataset
from tests.test_torch_models import jax_variables, port_net

H, W = 40, 48  # a 5 x 6 feature grid: P = 30, ragged over 4 bank shards
N_FRAMES = 9


@pytest.fixture(scope="module")
def nets():
    jnet, variables = jax_variables("resnet18", 5)
    return jnet, variables, port_net("resnet18", variables)


def _lanes(rng, videos, flips):
    """(N, videos x lanes, H, W, 3) frames and lane labels, video-major, each
    video's lanes its frames flipped by ``flips``."""
    vids = rng.integers(0, 255, size=(N_FRAMES, videos, H, W, 3), dtype=np.uint8)
    labels = np.zeros((videos, H, W), np.int32)
    for v in range(videos):
        labels[v, 8 + 2 * v : 30 + 2 * v, 10 : 36 + 3 * v] = 1 + v % 2
        labels[v, 30:, :12] = 2 - v % 2
    frames = np.stack([vids[:, v][:, :, ::-1] if f == "h" else vids[:, v] for v in range(videos) for f in flips],
                      axis=1)
    lane_labels = np.stack([labels[v][:, ::-1] if f == "h" else labels[v] for v in range(videos) for f in flips])
    return np.ascontiguousarray(frames), np.ascontiguousarray(lane_labels)


# (id, data rows, bank shards, videos, fused hor-flip lanes, probability)
CASES = [
    ("dp2-pad", 2, 1, 3, False, False),
    ("dp2xbank2", 2, 2, 2, False, False),
    ("dp2xbank2-prob", 2, 2, 3, False, True),
    ("dp2-fused-pad", 2, 1, 3, True, False),
    ("dp2xbank2-fused", 2, 2, 2, True, False),
]


@pytest.mark.parametrize("name,n_data,n_bank,videos,fused,prob", CASES, ids=[c[0] for c in CASES])
def test_mesh_engine_matches_jax_and_lockstep(rng, nets, name, n_data, n_bank, videos, fused, prob):
    """The mesh engine on the port's CPU mesh (the CPU named n_data x n_bank
    times) against the JAX mesh engine on the virtual devices and the port's
    one-device lockstep engine, at the global, unpadded shapes: masks equal
    with lanes over data rows alone (as the JAX tests demand of the JAX
    engine), >= 99.9 % of pixels with bank shards (float32 sums in another
    order may flip a near-tie); in probability mode the scores within float32
    rounding (the encode batch differs, and the CPU sums a dilated
    convolution of one image in another order than of several)."""
    jnet, variables, net = nets
    flips = (None, "h") if fused else (None,)
    temperature = 0.02 if prob else 1.0
    jcfg = JConfig(ref_num=5, frame_range=6, temperature=temperature, probability_propagation=prob,
                   compute_dtype=np.float32, use_pallas=False)
    cfg = EngineConfig(ref_num=5, frame_range=6, temperature=temperature, probability_propagation=prob)
    b = videos * len(flips)
    jfusion = JLaneFusion(pred_flips=flips) if fused else None
    fusion = batched.LaneFusion(flips) if fused else None
    jmesh = jmake_mesh(n_data=n_data, n_model=n_bank, devices=jax.devices()[: n_data * n_bank])
    jengine = JDataParallel(jnet, variables, (H, W), b, jcfg, jfusion, mesh=jmesh)
    mesh = make_mesh(n_data, n_bank, devices=[torch.device("cpu")] * (n_data * n_bank))
    engine = DataParallelBatchedEngine(net, (H, W), b, cfg, mesh, fusion)
    lockstep = batched.BatchedPropagationEngine(net, (H, W), b, cfg, "cpu", fusion)
    assert engine.b_pad == jengine.b_pad and engine.per_row == jengine.inner.b
    assert all(isinstance(e, BankShardedBatchedEngine) == (n_bank > 1) for e in engine.engines)
    frames, labels = _lanes(rng, videos, flips)
    jst, st, lst = (e.start_videos(frames[0], labels) for e in (jengine, engine, lockstep))
    agree, seen = [], set()
    for start in range(1, N_FRAMES, 4):
        batch = frames[start : start + 4]
        if prob:
            got, st = engine.step_chunk_scores(batch, st, start)
            jgot, jst = jengine.step_chunk_scores(batch, jst, start)
            ref, lst = lockstep.step_chunk_scores(batch, lst, start)
            assert got.shape == (len(batch), b, cfg.num_classes, engine.p)
            np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
            got, jgot, ref = got.argmax(2), np.asarray(jgot).argmax(2), ref.argmax(2)
        else:
            step = "step_chunk" if fused else "step_chunk_small"
            got, st = getattr(engine, step)(batch, st, start)
            jgot, jst = getattr(jengine, step)(batch, jst, start)
            ref, lst = getattr(lockstep, step)(batch, lst, start)
            assert got.shape == ((len(batch), videos, H, W) if fused else (len(batch), b, engine.hd, engine.wd))
        agree += [float((got.numpy() == np.asarray(jgot)).mean()), (got == ref).float().mean().item()]
        seen.update(np.unique(ref.numpy()).tolist())
    assert len(seen) > 1  # the masks are not constant
    assert min(agree) >= (0.999 if n_bank > 1 else 1.0), agree


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


@pytest.fixture(scope="module")
def unsharded(davis_and_ckpt, tmp_path_factory):
    """Each strategy's PNGs from the port's unsharded run, one video at a
    time, made once."""
    root, ckpt = davis_and_ckpt
    out = {}
    for strategy, flags in STRATEGIES.items():
        save = tmp_path_factory.mktemp(f"unsharded_{strategy}")
        res = _run(root, ckpt, save, *flags)
        assert res.exit_code == 0, res.output
        out[strategy] = {p.relative_to(save): p.read_bytes() for p in sorted(save.rglob("*.png"))}
    return out


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("mesh_flags", [["--bank-shards", "2"],
                                        ["--video-batch", "4", "--dp-shards", "2", "--bank-shards", "2"]],
                         ids=["bank2", "vb4-dp2-bank2"])
def test_cli_mesh_pngs_equal_unsharded(davis_and_ckpt, unsharded, tmp_path, strategy, mesh_flags):
    """``--device cpu`` on a virtual mesh (the CPU named 2 or 4 times):
    every strategy's PNGs, and probability mode's, byte-identical to the
    port's unsharded run (3 videos: the lockstep group of 4 pads to whole
    videos per data row)."""
    root, ckpt = davis_and_ckpt
    res = _run(root, ckpt, tmp_path, *STRATEGIES[strategy], *mesh_flags)
    assert res.exit_code == 0, res.output
    got = {p.relative_to(tmp_path): p.read_bytes() for p in sorted(tmp_path.rglob("*.png"))}
    expect = unsharded[strategy]
    assert len(expect) == 15 and got.keys() == expect.keys()
    assert got == expect
    classes = set()
    for rel in got:
        classes.update(np.unique(np.asarray(Image.open(tmp_path / rel))).tolist())
    assert classes == {0, 1, 2}


def test_inference_single_sharded_is_single_with_a_mesh(davis_and_ckpt, unsharded, tmp_path):
    """``strategies.inference_single_sharded``, the JAX package's alias, on
    a 3-shard CPU mesh writes the unsharded run's PNGs."""
    from semi_supervised_vos_tpu_torch.data.davis import InferenceDataset
    from semi_supervised_vos_tpu_torch.infer import strategies
    from semi_supervised_vos_tpu_torch.models.convert import load_torch_checkpoint
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    root, ckpt = davis_and_ckpt
    net = load_torch_checkpoint(ckpt, VOSNet("resnet18"))
    dataset = InferenceDataset(str(root / "JPEGImages" / "480p"), inference_strategy="single")
    mesh = make_mesh(1, 3, devices=[torch.device("cpu")] * 3)
    strategies.inference_single_sharded(dataset, root / "Annotations" / "480p", tmp_path, net, EngineConfig(), mesh)
    got = {p.relative_to(tmp_path): p.read_bytes() for p in sorted(tmp_path.rglob("*.png"))}
    assert got == unsharded["single"]


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


def test_cli_counts_cards_on_the_card_only(monkeypatch):
    """On the card ``--dp-shards x --bank-shards`` may not exceed the cards
    (the JAX message); with ``--device cpu`` the mesh is virtual, so the CPU
    takes any count."""
    import click

    from semi_supervised_vos_tpu_torch.cli.inference import make_meshes

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(click.ClickException, match=r"--dp-shards 1 x --bank-shards 2 exceeds the 1 available"):
        make_meshes(torch.device("cuda"), 1, 2, 1)
    mesh, mesh_dp = make_meshes(torch.device("cpu"), 8, 4, 2)
    assert mesh is None and mesh_dp.shape == {"data": 2, "model": 4}
    assert mesh_dp.distinct_devices == [torch.device("cpu")]
    mesh, mesh_dp = make_meshes(torch.device("cpu"), 1, 3, 1)
    assert mesh_dp is None and mesh.shape == {"data": 1, "model": 3}
    assert make_meshes(torch.device("cpu"), 4, 1, 1) == (None, None)


def test_lane_cap_scales_by_distinct_cards():
    """The lockstep lane cap scales by the distinct cards that encode: a
    virtual mesh naming one card in every row keeps one card's cap, a mesh
    over two cards doubles it (no card is touched: devices are names)."""
    from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh

    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    virtual = Mesh([[cuda0, cuda0], [cuda0, cuda0]])
    two_cards = Mesh([[cuda0], [cuda1]])
    assert batched._mesh_data_chips(None) == 1
    assert batched._mesh_data_chips(virtual) == 1
    assert batched._mesh_data_chips(two_cards) == 2
    assert batched._mesh_data_chips(make_mesh(4, 1, devices=[torch.device("cpu")] * 4)) == 1
    hw = (480, 854)
    one = batched._clamp_video_batch(10_000, 1, hw)
    assert batched._clamp_video_batch(10_000, 1, hw, n_chips=batched._mesh_data_chips(virtual)) == one
    assert batched._clamp_video_batch(10_000, 1, hw, n_chips=batched._mesh_data_chips(two_cards)) == 2 * one
