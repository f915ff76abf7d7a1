"""DINO's ViT in the port (``models/vit.py``) against the plain float32
reference (``tests/plain_dino_vit.py``), at a small size on the CPU: 2
blocks, width 64, 4 heads, patch 8, 32 x 48 frames (and a 30 x 45 one,
padded), seeded weights in DINO's key layout. The module, its bf16 card path
(run here on the CPU), the loading of DINO's checkpoint layout, both engines
stepped over a short clip, and the inference CLI with ``--model
dino_vitb8``; training and float32 card features are refused."""

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD, EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.models import vit as vit_mod
from semi_supervised_vos_tpu_torch.models.convert import dino_state_dict, save_torch_checkpoint
from semi_supervised_vos_tpu_torch.models.vit import DinoViT
from semi_supervised_vos_tpu_torch.models.vos_net import build_vos_net
from tests.helpers import make_davis_dataset

import plain_dino_vit as plain

TINY = dict(dim=64, depth=2, heads=4, hidden=256, patch=8, grid=28)
HW = (32, 48)


def tiny_net(seed: int = 3) -> DinoViT:
    net = DinoViT("dino_vitb8", **TINY).eval()
    net.load_state_dict(plain.seeded_state_dict(seed, TINY["dim"], TINY["depth"], TINY["hidden"]))
    return net


def normalised(frames_u8: np.ndarray) -> torch.Tensor:
    """(N, H, W, 3) uint8 → (N, 3, H, W) float32, the engine's normalisation."""
    x = (torch.as_tensor(frames_u8).float() / 255.0 - torch.as_tensor(IMAGENET_MEAN)) / torch.as_tensor(IMAGENET_STD)
    return x.permute(0, 3, 1, 2)


def clip(seed: int, t: int = 7, hw=HW):
    """A short clip of two moving blocks over a blocky background, and its
    first frame's labels."""
    rng = np.random.default_rng(seed)
    h, w = hw
    bg = np.kron(rng.integers(0, 160, (h // 8 + 1, w // 8 + 1, 3)), np.ones((8, 8, 1)))[:h, :w]
    frames = np.empty((t, h, w, 3), np.uint8)
    label0 = np.zeros((h, w), np.int64)
    for i in range(t):
        f = bg + rng.integers(0, 20, (h, w, 3))
        f[8:20, 4 + 2 * i:20 + 2 * i] = (220, 40, 40)
        f[20:30, 30 - i:44 - i] = (30, 200, 90)
        frames[i] = np.clip(f, 0, 255)
    label0[8:20, 4:20] = 1
    label0[20:30, 30:44] = 2
    return frames, label0


@pytest.mark.parametrize("hw", [(32, 48), (30, 45)])
def test_module_matches_plain_reference(hw):
    """The float32 module (the CPU engine's path) against the reference,
    on a grid the table is interpolated to, with and without padding: the
    same products in float32, summed in another order, so 2e-5 on unit
    vectors (measured ~2e-6)."""
    sd = plain.seeded_state_dict(3, TINY["dim"], TINY["depth"], TINY["hidden"])
    net = tiny_net(3)
    x = normalised(clip(0, 2, hw)[0])
    with torch.no_grad():
        got = net(x)
    want = plain.forward(sd, x, TINY["heads"])
    assert got.shape == want.shape == (2, 64, -(-hw[0] // 8), -(-hw[1] // 8))
    assert (got - want).abs().max() < 2e-5


def test_card_path_matches_plain_reference_in_bf16():
    """The bf16 path the card runs (``DinoViT.encode``), here on the CPU:
    bf16 products and activations against the float32 reference. bf16 keeps
    8 bits, so each rounding moves a value by up to 2^-9 relative; through
    two blocks the features move by ~0.5 % relative (2 % allowed), and the
    path is not the float32 module's (1e-3 would fail it)."""
    from semi_supervised_vos_tpu_torch.utils import profiling

    sd = plain.seeded_state_dict(5, TINY["dim"], TINY["depth"], TINY["hidden"])
    net = tiny_net(5)
    x = normalised(clip(1, 3)[0])
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = net.encode(x.permute(0, 2, 3, 1).contiguous(), torch.bfloat16).float().permute(0, 3, 1, 2)
    want = plain.forward(sd, x, TINY["heads"])
    rel = ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()
    assert 1e-4 < rel < 0.02, rel
    # its spans and counters: one embedding, an attention and an MLP span a block
    s = profiling.summary()
    profiling.reset()
    assert s["counters"] == {"vit.frames": 3, "vit.tokens": 3 * (1 + 4 * 6)}
    assert [s["spans"][n]["count"] for n in ("vit.embed", "vit.attention", "vit.mlp")] == [1, 2, 2]


def test_dino_checkpoint_layout_loads():
    """A checkpoint as DINO's training saves it (the teacher's weights under
    ``backbone.``, DataParallel's ``module.``, the projection head beside
    them) loads into the module; a wrong width is refused by name."""
    sd = plain.seeded_state_dict(7, TINY["dim"], TINY["depth"], TINY["hidden"])
    ckpt = {"teacher": {**{f"module.backbone.{k}": v for k, v in sd.items()},
                        "module.head.last_layer.weight": torch.zeros(4, 64)}, "epoch": 3}
    net = DinoViT("dino_vitb8", **TINY)
    net.load_state_dict(dino_state_dict(ckpt, net))
    for k, v in sd.items():
        assert torch.equal(net.state_dict()[k], v), k
    wide = DinoViT("dino_vitb8", **dict(TINY, dim=32, heads=2))
    with pytest.raises(ValueError, match="shapes differ"):
        dino_state_dict(ckpt, wide)


class _Reference(torch.nn.Module):
    """The plain reference as an encoder for the port's CPU engine."""

    def __init__(self, sd):
        super().__init__()
        self.sd, self.model, self.feature_dim = sd, "dino_vitb8", TINY["dim"]

    def forward(self, x):
        return plain.forward(self.sd, x, TINY["heads"])


CFG = EngineConfig(ref_num=4, frame_range=5, temperature=10.0, feature_dim=TINY["dim"])


def test_single_engine_matches_reference_features():
    """``PropagationEngine`` over a clip that wraps the ring bank, against
    the same engine fed the reference's features: the bank's features agree
    to float32 summation (2e-5) and every mask is the same."""
    sd = plain.seeded_state_dict(9, TINY["dim"], TINY["depth"], TINY["hidden"])
    frames, label0 = clip(2, 13)
    engines = [PropagationEngine(m, HW, CFG, "cpu") for m in (tiny_net(9), _Reference(sd))]
    states = [e.start_video(frames[0], label0) for e in engines]
    seen = set()
    for start in range(1, len(frames), 4):
        out = [e.step_chunk_small(frames[start:start + 4], s, start) for e, s in zip(engines, states)]
        np.testing.assert_array_equal(out[0][0].numpy(), out[1][0].numpy(), err_msg=f"chunk at {start}")
        seen.update(np.unique(out[0][0].numpy()).tolist())
    assert seen == {0, 1, 2}
    assert (states[0].feats - states[1].feats).abs().max() < 2e-5


def test_lockstep_engine_matches_reference_features():
    """``BatchedPropagationEngine`` with two lanes of different clips against
    the single engine fed the reference's features, lane by lane: the same
    masks."""
    sd = plain.seeded_state_dict(11, TINY["dim"], TINY["depth"], TINY["hidden"])
    clips = [clip(3, 9), clip(4, 9)]
    lockstep = BatchedPropagationEngine(tiny_net(11), HW, 2, CFG, "cpu")
    ref = PropagationEngine(_Reference(sd), HW, CFG, "cpu")
    state = lockstep.start_videos(np.stack([c[0][0] for c in clips]), np.stack([c[1] for c in clips]))
    refs = [ref.start_video(f[0], l0) for f, l0 in clips]
    for start in range(1, 9, 4):
        n = min(4, 9 - start)
        frames = np.stack([np.stack([f[t] for f, _ in clips]) for t in range(start, start + n)])
        masks, state = lockstep.step_chunk_small(frames, state, start)
        for lane, (f, _) in enumerate(clips):
            want, refs[lane] = ref.step_chunk_small(f[start:start + n], refs[lane], start)
            np.testing.assert_array_equal(masks[:, lane].numpy(), want.numpy(), err_msg=f"lane {lane} at {start}")


@pytest.fixture
def tiny_vitb8(monkeypatch):
    """``dino_vitb8`` cut to the tests' size wherever the port builds it."""
    monkeypatch.setitem(vit_mod.VIT_ARCH, "dino_vitb8", dict(TINY))


def test_cli_runs_dino_vitb8_single_and_lockstep(tiny_vitb8, tmp_path, monkeypatch):
    """``inference --model dino_vitb8 --device cpu`` on a DAVIS-layout tree
    from a DINO-layout checkpoint, one video at a time and at
    ``--video-batch 2``: the same PNGs, the features 64 wide (the model's)
    and the temperature 10 unless given."""
    from semi_supervised_vos_tpu_torch.__main__ import cli
    from semi_supervised_vos_tpu_torch.infer import batched, strategies

    make_davis_dataset(tmp_path / "davis", videos=("a", "b"), frames=6, size=HW, objects=2)
    sd = plain.seeded_state_dict(13, TINY["dim"], TINY["depth"], TINY["hidden"])
    ckpt = tmp_path / "dino.pth"
    torch.save({"teacher": {f"backbone.{k}": v for k, v in sd.items()}}, ckpt)
    seen = []
    for mod, name in ((strategies, "inference_single"), (batched, "inference_batched")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, **k):
            seen.append((a[4].temperature, a[4].feature_dim))
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    outs = []
    for vb in (1, 2):
        out = tmp_path / f"out{vb}"
        args = ["inference", "-d", str(tmp_path / "davis"), "-r", str(ckpt), "-m", "dino_vitb8", "-s", str(out),
                "--device", "cpu", "--video-batch", str(vb)]
        res = CliRunner().invoke(cli, args)
        assert res.exit_code == 0, res.output
        outs.append(out)
    assert seen == [(10.0, 64), (10.0, 64)]
    for video in ("a", "b"):
        pngs = sorted((outs[0] / video).glob("*.png"))
        assert len(pngs) == 6
        for p in pngs:
            assert np.array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(outs[1] / video / p.name))), p


@pytest.mark.parametrize("mesh", [["--bank-shards", "2"], ["--video-batch", "2", "--dp-shards", "2"],
                                  ["--video-batch", "2", "--dp-shards", "2", "--bank-shards", "2"]],
                         ids=["bank2", "dp2", "dp2-bank2"])
def test_cli_meshes_write_the_one_device_pngs(tiny_vitb8, tmp_path, mesh):
    """The ViT through the mesh engines on a virtual CPU mesh (banks sharded
    in stats mode, lanes over data rows, each row's engine encoding with the
    one module): the PNGs of one device."""
    from semi_supervised_vos_tpu_torch.__main__ import cli

    make_davis_dataset(tmp_path / "davis", videos=("a", "b"), frames=6, size=HW, objects=2)
    torch.save(plain.seeded_state_dict(17, TINY["dim"], TINY["depth"], TINY["hidden"]), tmp_path / "dino.pth")
    outs = []
    for extra in ([], mesh):
        out = tmp_path / f"out{len(outs)}"
        args = ["inference", "-d", str(tmp_path / "davis"), "-r", str(tmp_path / "dino.pth"), "-m", "dino_vitb8", "-s",
                str(out), "--device", "cpu", *extra]
        res = CliRunner().invoke(cli, args)
        assert res.exit_code == 0, res.output
        outs.append(out)
    pngs = sorted(outs[0].rglob("*.png"))
    assert len(pngs) == 12
    for p in pngs:
        assert np.array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(outs[1] / p.relative_to(outs[0])))), p


def test_ported_checkpoint_round_trips(tiny_vitb8, tmp_path):
    """A ViT saved by the port loads back through the same loader."""
    from semi_supervised_vos_tpu_torch.models.convert import load_torch_checkpoint

    net = tiny_net(15)
    save_torch_checkpoint(net, tmp_path / "vit.pth.tar")
    back = load_torch_checkpoint(tmp_path / "vit.pth.tar", build_vos_net("dino_vitb8"))
    assert isinstance(back, DinoViT)
    for k, v in net.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_training_and_float32_card_features_are_refused(tiny_vitb8, tmp_path, monkeypatch):
    """``train --model dino_vitb8`` and ``SVOS_INFER_DTYPE=float32`` with it
    on the card each stop with a message that says why."""
    from semi_supervised_vos_tpu_torch.__main__ import cli
    from semi_supervised_vos_tpu_torch.utils import runtime

    res = CliRunner().invoke(cli, ["train", "-t", str(tmp_path), "-v", str(tmp_path), "--model", "dino_vitb8",
                                   "--device", "cpu"])
    assert res.exit_code != 0 and "not ported" in res.output and "frozen" in res.output, res.output
    monkeypatch.setenv("SVOS_INFER_DTYPE", "float32")
    monkeypatch.setattr(runtime, "resolve_device", lambda device: torch.device("cuda"))
    res = CliRunner().invoke(cli, ["inference", "-d", str(tmp_path), "-r", str(tmp_path / "x"), "-m", "dino_vitb8",
                                   "-s", str(tmp_path / "o")])
    assert res.exit_code != 0 and "float32" in res.output and "256 channels" in res.output, res.output
