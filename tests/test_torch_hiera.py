"""SAM 2.1's Hiera in the port (``models/hiera.py``) against the plain float32
reference (``tests/plain_sam2_hiera.py``), at a small size on the CPU that
has every mechanism of Hiera-L: width 16, 1 head, stages [1, 2, 3, 2],
windows [4, 6, 4, 3], block 4 global, a transition at the head of stages
2–4, frames of 36 x 50 and 44 x 70 (not multiples of 32). Stage 1's grid
tiles its window by construction (the window table's tiling needs it); the
later stages' windows, and the two later transitions' pooled windows, pad
their grids (stage 2: 12 x 16 into windows of 6; stage 3: 6 x 8 into 4;
stage 4: 3 x 4 into 3). The weights are seeded with non-zero biases, so the
padded tokens' keys (the ``qkv`` bias) count. The module, its bf16 card
path (run here on the CPU), the window layout, the loading of SAM 2's
checkpoint layout, both engines stepped over a short clip, and the inference
CLI with ``--model sam2_hiera_l``; training and float32 card features are
refused."""

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD, EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.models import hiera as hiera_mod
from semi_supervised_vos_tpu_torch.models.convert import sam2_state_dict, save_torch_checkpoint
from semi_supervised_vos_tpu_torch.models.hiera import SamHiera, window_partition, window_unpartition
from semi_supervised_vos_tpu_torch.models.vos_net import build_vos_net
from tests.helpers import make_davis_dataset

import plain_sam2_hiera as plain

TINY = dict(embed_dim=16, num_heads=1, stages=(1, 2, 3, 2), window_spec=(4, 6, 4, 3), global_att_blocks=(4,),
            q_pool=3, bkg=(7, 7), d_model=32, mlp_ratio=4)
HW = (36, 50)


def tiny_net(seed: int = 3) -> SamHiera:
    net = SamHiera("sam2_hiera_l", **TINY).eval()
    net.load_state_dict(plain.seeded_state_dict(seed, TINY))
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
        f[20:32, 30 - i:44 - i] = (30, 200, 90)
        frames[i] = np.clip(f, 0, 255)
    label0[8:20, 4:20] = 1
    label0[20:32, 30:44] = 2
    return frames, label0


def rel_err(got, want) -> float:
    return ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()


@pytest.mark.parametrize("hw", [(36, 50), (44, 70)])
def test_module_matches_plain_reference(hw):
    """The float32 module (the CPU engine's path) against the reference: the
    same float32 products summed in another order (the port runs ``qkv``
    before the windows' padding and ``proj`` after their unpartition, and
    attention through ``scaled_dot_product_attention``), so ~4e-7 relative
    on unit vectors; 1e-5 allowed."""
    sd = plain.seeded_state_dict(3, TINY)
    x = normalised(clip(0, 2, hw)[0])
    with torch.no_grad():
        got = tiny_net(3)(x)
    want = plain.forward(sd, x, TINY)
    assert got.shape == want.shape == (2, 32, -(-hw[0] // 8), -(-hw[1] // 8))
    assert rel_err(got, want) < 1e-5


def test_card_path_matches_plain_reference_in_bf16():
    """The bf16 path the card runs (``SamHiera.encode``), here on the CPU:
    bf16 products and activations against the float32 reference. Each bf16
    rounding moves a value by up to 2^-9 relative; through 8 blocks and the
    neck the features move by ~0.7 % (2 % allowed), and the path is not the
    float32 module's (1e-4 would fail it)."""
    from semi_supervised_vos_tpu_torch.utils import profiling

    sd = plain.seeded_state_dict(5, TINY)
    x = normalised(clip(1, 3)[0])
    net = tiny_net(5)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = net.encode(x.permute(0, 2, 3, 1).contiguous(), torch.bfloat16)
    s = profiling.summary()
    profiling.reset()
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 7, 32)
    rel = rel_err(got.float().permute(0, 3, 1, 2), plain.forward(sd, x, TINY))
    assert 1e-4 < rel < 0.02, rel
    # 96 x 128 padded frames: a 24 x 32 stride-4 grid; windows a frame by
    # block: 48 (24 x 32 in 4s), 48 (transition, the same windows), 6 (12 x
    # 16 in 6s), 6 (transition), global, 4 (6 x 8 in 4s), 4 (transition), 2
    # (3 x 4 in 3s)
    assert s["counters"] == {"hiera.frames": 3, "hiera.tokens": 3 * 24 * 32,
                             "hiera.windows": 3 * (48 + 48 + 6 + 6 + 4 + 4 + 2)}
    spans = {n: s["spans"][n]["count"] for n in ("hiera.embed", "hiera.window_attention", "hiera.global_attention",
                                                 "hiera.mlp", "hiera.neck")}
    assert spans == {"hiera.embed": 1, "hiera.window_attention": 7, "hiera.global_attention": 1, "hiera.mlp": 8,
                     "hiera.neck": 1}


@pytest.mark.parametrize("hw, window", [((7, 9), 4), ((5, 11), 3), ((8, 8), 8), ((3, 2), 4)])
def test_window_partition_then_unpartition_is_identity(hw, window):
    """On odd grids (and one smaller than a window): the windows, padded
    with zeros, are SAM 2's ``window_partition``'s; padded with a vector,
    its pad tokens are that vector; putting them back gives the grid."""
    x = torch.randint(-50, 50, (2,) + hw + (5,), generator=torch.Generator().manual_seed(0)).float()
    grid = (-(-hw[0] // window), -(-hw[1] // window))
    windows = window_partition(x, window)
    ref, _ = plain.window_partition(x, window)
    assert torch.equal(windows, ref.reshape(windows.shape))
    assert torch.equal(window_unpartition(windows, 2, grid, hw), x)
    fill = torch.arange(5.0) + 100
    ref, _ = plain.window_partition(x - fill, window)
    assert torch.equal(window_partition(x, window, fill), ref.reshape(windows.shape) + fill)


def test_sam2_checkpoint_layout_loads():
    """A checkpoint as SAM 2 ships it (``{"model": ...}``, the image encoder
    under ``image_encoder.``, the neck's four laterals, the other modules
    beside them) loads into the module; a wrong width is refused by name."""
    sd = plain.seeded_state_dict(7, TINY)
    extra = {"image_encoder.neck.convs.2.conv.weight": torch.zeros(32, 32, 1, 1),
             "image_encoder.neck.convs.3.conv.bias": torch.zeros(32),
             "memory_attention.layers.0.norm1.weight": torch.ones(32), "sam_mask_decoder.iou_token.weight": torch.ones(1)}
    ckpt = {"model": {**{f"image_encoder.{k}": v for k, v in sd.items()}, **extra}}
    net = SamHiera("sam2_hiera_l", **TINY)
    net.load_state_dict(sam2_state_dict(ckpt, net))
    for k, v in sd.items():
        assert torch.equal(net.state_dict()[k], v), k
    wide = SamHiera("sam2_hiera_l", **dict(TINY, embed_dim=24))
    with pytest.raises(ValueError, match="shapes differ"):
        sam2_state_dict(ckpt, wide)


class _Reference(torch.nn.Module):
    """The plain reference as an encoder for the port's CPU engine."""

    def __init__(self, sd):
        super().__init__()
        self.sd, self.model, self.feature_dim = sd, "sam2_hiera_l", TINY["d_model"]

    def forward(self, x):
        return plain.forward(self.sd, x, TINY)


# the tiny network's features of one frame lie within ~0.13 of each other
# in cosine: at temperature 10 or 30 every pixel votes background, at 300
# both objects carry through the clip
CFG = EngineConfig(ref_num=4, frame_range=5, temperature=300.0, feature_dim=TINY["d_model"])


def test_engines_match_reference_features():
    """``PropagationEngine`` over a clip that wraps the ring bank, and
    ``BatchedPropagationEngine`` with two lanes of different clips, each
    against the single engine fed the reference's features: every mask the
    same, and the bank's features to float32 summation (1e-5)."""
    sd = plain.seeded_state_dict(9, TINY)
    frames, label0 = clip(2, 11)
    engines = [PropagationEngine(m, HW, CFG, "cpu") for m in (tiny_net(9), _Reference(sd))]
    states = [e.start_video(frames[0], label0) for e in engines]
    seen = set()
    for start in range(1, len(frames), 4):
        out = [e.step_chunk_small(frames[start:start + 4], s, start) for e, s in zip(engines, states)]
        np.testing.assert_array_equal(out[0][0].numpy(), out[1][0].numpy(), err_msg=f"chunk at {start}")
        seen.update(np.unique(out[0][0].numpy()).tolist())
    assert seen == {0, 1, 2}
    assert (states[0].feats - states[1].feats).abs().max() < 1e-5

    clips = [clip(3, 6), clip(4, 6)]
    lockstep = BatchedPropagationEngine(tiny_net(9), HW, 2, CFG, "cpu")
    ref = engines[1]
    state = lockstep.start_videos(np.stack([c[0][0] for c in clips]), np.stack([c[1] for c in clips]))
    refs = [ref.start_video(f[0], l0) for f, l0 in clips]
    masks, state = lockstep.step_chunk_small(np.stack([np.stack([f[t] for f, _ in clips]) for t in range(1, 6)]),
                                             state, 1)
    for lane, (f, _) in enumerate(clips):
        want, refs[lane] = ref.step_chunk_small(f[1:6], refs[lane], 1)
        np.testing.assert_array_equal(masks[:, lane].numpy(), want.numpy(), err_msg=f"lane {lane}")


@pytest.fixture
def tiny_hiera(monkeypatch):
    """``sam2_hiera_l`` cut to the tests' size wherever the port builds it."""
    monkeypatch.setitem(hiera_mod.HIERA_ARCH, "sam2_hiera_l", dict(TINY))


def test_cli_runs_sam2_hiera_l_single_and_lockstep(tiny_hiera, tmp_path, monkeypatch):
    """``inference --model sam2_hiera_l --device cpu`` on a DAVIS-layout tree
    from a SAM 2-layout checkpoint, one video at a time and at
    ``--video-batch 2``: the same PNGs, the features the model's width and
    the temperature 10 unless given; a checkpoint the port saved loads back."""
    from semi_supervised_vos_tpu_torch.__main__ import cli
    from semi_supervised_vos_tpu_torch.infer import batched, strategies
    from semi_supervised_vos_tpu_torch.models.convert import load_torch_checkpoint

    make_davis_dataset(tmp_path / "davis", videos=("a", "b"), frames=5, size=HW, objects=2)
    sd = plain.seeded_state_dict(13, TINY)
    ckpt = tmp_path / "sam2.pt"
    torch.save({"model": {f"image_encoder.{k}": v for k, v in sd.items()}}, ckpt)
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
        args = ["inference", "-d", str(tmp_path / "davis"), "-r", str(ckpt), "-m", "sam2_hiera_l", "-s", str(out),
                "--device", "cpu", "--video-batch", str(vb)]
        res = CliRunner().invoke(cli, args)
        assert res.exit_code == 0, res.output
        outs.append(out)
    assert seen == [(10.0, 32), (10.0, 32)]
    for video in ("a", "b"):
        pngs = sorted((outs[0] / video).glob("*.png"))
        assert len(pngs) == 5
        for p in pngs:
            assert np.array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(outs[1] / video / p.name))), p
    net = tiny_net(15)
    save_torch_checkpoint(net, tmp_path / "hiera.pth.tar")
    back = load_torch_checkpoint(tmp_path / "hiera.pth.tar", build_vos_net("sam2_hiera_l"))
    assert isinstance(back, SamHiera)
    for k, v in net.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_training_and_float32_card_features_are_refused(tiny_hiera, tmp_path, monkeypatch):
    """``train --model sam2_hiera_l`` and ``SVOS_INFER_DTYPE=float32`` with
    it on the card each stop with a message that says why."""
    from semi_supervised_vos_tpu_torch.__main__ import cli
    from semi_supervised_vos_tpu_torch.utils import runtime

    res = CliRunner().invoke(cli, ["train", "-t", str(tmp_path), "-v", str(tmp_path), "--model", "sam2_hiera_l",
                                   "--device", "cpu"])
    assert res.exit_code != 0 and "not ported" in res.output and "frozen" in res.output, res.output
    monkeypatch.setenv("SVOS_INFER_DTYPE", "float32")
    monkeypatch.setattr(runtime, "resolve_device", lambda device: torch.device("cuda"))
    res = CliRunner().invoke(cli, ["inference", "-d", str(tmp_path), "-r", str(tmp_path / "x"), "-m", "sam2_hiera_l",
                                   "-s", str(tmp_path / "o")])
    assert res.exit_code != 0 and "float32" in res.output and "card path runs in bfloat16" in res.output, res.output
