"""The port's CUDA kernels against their plain PyTorch versions, on an NVIDIA
Hopper card. Every test here needs the card and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
from semi_supervised_vos_tpu_torch.ops import affinity as tap
from semi_supervised_vos_tpu_torch.ops import bottleneck as tb

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90)")
    return torch.device("cuda")


@pytest.fixture
def nprng():
    return np.random.default_rng(7)


def _bank(nprng, card, cap, b, p, c, d_pad, n_cls=22):
    feats = torch.as_tensor(nprng.standard_normal((cap, b, p, c)) * 0.2, dtype=torch.float32)
    cls = torch.as_tensor(nprng.integers(0, n_cls, size=(cap, b, p)))
    labels = torch.nn.functional.one_hot(cls, d_pad).float()
    return feats.to(card, torch.bfloat16), labels.to(card, torch.bfloat16)


@pytest.mark.parametrize(
    "hd,wd,b,row_base,stats",
    [(16, 20, 1, 0, False), (16, 20, 2, 0, False), (16, 20, 1, 160, True), (60, 107, 1, 0, False),
     (13, 27, 1, 0, False), (60, 107, 2, 0, False), (60, 107, 1, 3200, True)],
)
def test_affinity_kernel_matches_plain(card, nprng, hd, wd, b, row_base, stats):
    c, d_pad, cap, k = 256, 24, 45, 9
    p = hd * wd
    feats, labels = _bank(nprng, card, cap, b, p - row_base, c, d_pad)
    # the target holds bf16 values, as the encoder emits them on the main path
    tgt = torch.as_tensor(nprng.standard_normal((b, p, c)) * 0.2, dtype=torch.float32)
    tgt = tgt.to(card, torch.bfloat16).float()
    idx, valid, dense = sample_frames(50, 40, k)
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense,
              row_base=row_base, return_stats=stats)
    before = tap.affinity_from_bank_batched.launches
    got = tap.affinity_from_bank_batched(feats, labels, tgt, idx % cap, **kw)
    torch.cuda.synchronize()
    assert tap.affinity_from_bank_batched.launches == before + 1
    expect = tap.affinity_from_bank_plain(feats.float(), labels.float(), tgt, idx % cap, **kw)
    got = got if stats else (got,)
    expect = expect if stats else (expect,)
    # summation order and exp differ; e·w keeps ~16 bits (bf16 hi + lo)
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, rtol=1e-4, atol=3.4e-5)
    if not stats:
        assert (got[0][:, 22:] == 0).all()  # padded classes exactly zero


@pytest.mark.parametrize(
    "n,h,w,c,c4",
    [(1, 60, 107, 512, 128), (2, 60, 107, 1024, 256), (1, 13, 27, 512, 128), (1, 69, 123, 1024, 256),
     (1, 54, 97, 512, 128), (3, 60, 107, 512, 128), (3, 13, 27, 1024, 256)],
)
def test_bottleneck_kernel_matches_plain(card, nprng, n, h, w, c, c4):
    x = torch.as_tensor(nprng.standard_normal((n, h, w, c)) * 0.5, dtype=torch.float32).to(card, torch.bfloat16)
    shapes = [(c, c4), (c4,), (3, 3, c4, c4), (c4,), (c4, c), (c,)]
    wts = [torch.as_tensor(nprng.standard_normal(s) * (0.05 if len(s) > 1 else 0.1), dtype=torch.float32)
           for s in shapes]
    wts = [t.to(card, torch.bfloat16 if i % 2 == 0 else torch.float32) for i, t in enumerate(wts)]
    before = tb.bottleneck_block.launches
    got = tb.bottleneck_block(x, *wts).float()
    torch.cuda.synchronize()
    assert tb.bottleneck_block.launches == before + 1
    expect = tb.bottleneck_block_plain(x.float(), *[t.float() for t in wts])
    # bf16 rounding of y1, y2 and the output: ~3e-3 of the output's range
    cos = torch.nn.functional.cosine_similarity(got.flatten(), expect.flatten(), dim=0)
    assert cos >= 0.9999
    assert (got - expect).abs().max() / expect.abs().max() <= 2e-2


@pytest.mark.parametrize(
    "hd,wd,k,c,frame_idx,temperature,spatial,f32_labels",
    [(6, 8, 9, 32, 3, 1.9, True, False), (6, 8, 9, 32, 20, 1.9, False, False), (4, 8, 4, 16, 4, 1.0, True, True),
     (5, 7, 3, 16, 3, 1.0, True, False), (16, 20, 9, 256, 50, 1.0, True, False)],
)
def test_fused_kernel_matches_plain(card, nprng, hd, wd, k, c, frame_idx, temperature, spatial, f32_labels):
    """``affinity_propagate_fused`` on the recipes of
    ``tests/test_pallas_affinity.py`` and the 16x20 grid; float32 labels are
    soft, so both bf16 label halves carry weight."""
    p, d = hd * wd, 22
    ref = torch.as_tensor(nprng.standard_normal((k, p, c)) * 0.3, dtype=torch.float32, device=card)
    tgt = torch.as_tensor(nprng.standard_normal((p, c)) * 0.3, dtype=torch.float32, device=card)
    if f32_labels:
        labels = torch.as_tensor(nprng.dirichlet(np.ones(d), size=(k, p)), dtype=torch.float32, device=card)
    else:
        labels = torch.nn.functional.one_hot(torch.as_tensor(nprng.integers(0, 5, size=(k, p))), d).float().to(card)
    _, valid, dense = sample_frames(frame_idx, 40, k)
    kw = dict(feature_hw=(hd, wd), temperature=temperature, valid=valid, dense=dense, spatial=spatial,
              label_dtype=torch.float32 if f32_labels else torch.bfloat16)
    before = tap.affinity_propagate_fused.launches
    got = tap.affinity_propagate_fused(ref, tgt, labels, **kw)
    torch.cuda.synchronize()
    assert tap.affinity_propagate_fused.launches == before + 1
    expect = tap.affinity_propagate_fused_plain(ref, tgt, labels, **kw)
    assert got.shape == expect.shape == (d, p)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=3.4e-5)
    assert (got.argmax(0) == expect.argmax(0)).all()


@pytest.mark.parametrize("case", ["k1", "one_valid", "c16", "c32", "d48"])
def test_affinity_kernel_slot_and_width_cases(card, nprng, case):
    """K = 1, one valid slot of nine, feature widths 16 and 32, and a
    48-wide label block, against the plain version."""
    hd, wd, cap, k = 16, 20, 45, 9
    c = {"c16": 16, "c32": 32}.get(case, 256)
    d_pad = 48 if case == "d48" else 24
    p = hd * wd
    feats, labels = _bank(nprng, card, cap, 1, p, c, d_pad, n_cls=40 if case == "d48" else 22)
    tgt = torch.as_tensor(nprng.standard_normal((1, p, c)) * 0.2, dtype=torch.float32).to(card, torch.bfloat16).float()
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    if case == "k1":
        slots, valid, dense = slots[:1], valid[:1], dense[:1]
    if case == "one_valid":
        valid = np.zeros(k, bool)
        valid[4] = True
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    got = tap.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)
    torch.cuda.synchronize()
    expect = tap.affinity_from_bank_plain(feats.float(), labels.float(), tgt, slots, **kw)
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=3.4e-5)
    assert (got.argmax(1) == expect.argmax(1)).all()


@pytest.mark.parametrize("stats", [False, True])
def test_combine_kernel_matches_plain(card, nprng, stats):
    """The combine kernel on random partials, one part all invalid (m =
    -1e30)."""
    s, b, d_pad, p = 5, 2, 24, 351
    m = torch.as_tensor(nprng.standard_normal((s, b, p)) * 3, dtype=torch.float32, device=card)
    m[1] = -1e30
    l = torch.as_tensor(nprng.uniform(0.5, 50, (s, b, p)), dtype=torch.float32, device=card)
    acc = torch.as_tensor(nprng.uniform(0, 1, (s, b, d_pad, p)), dtype=torch.float32, device=card) * l[:, :, None]
    got = tap.combine_partials(m, l, acc, return_stats=stats)
    torch.cuda.synchronize()
    expect = tap.combine_partials_plain(m, l, acc, return_stats=stats)
    got, expect = (got, expect) if stats else ((got,), (expect,))
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["from_bank", "fused"])
def test_twenty_slots_match_plain(card, nprng, op):
    """K = 20 slots (``inference -n 20``), all valid, past the dense/sparse
    switch, through each affinity entry point."""
    hd, wd, c, d_pad, cap, k = 16, 20, 256, 24, 45, 20
    p = hd * wd
    feats, labels = _bank(nprng, card, cap, 1, p, c, d_pad)
    feats, labels = feats[:, 0].contiguous(), labels[:, 0].contiguous()
    tgt = torch.as_tensor(nprng.standard_normal((p, c)) * 0.2, dtype=torch.float32).to(card, torch.bfloat16).float()
    idx, valid, dense = sample_frames(40, 40, k)
    assert valid.all() and not dense.all()
    slots = idx % cap
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    if op == "from_bank":
        got = tap.affinity_from_bank(feats, labels, tgt, slots, **kw)
        expect = tap.affinity_from_bank_plain(feats[:, None].float(), labels[:, None].float(), tgt[None], slots, **kw)[0]
    else:
        sel = torch.as_tensor(slots, device=card)
        args = (feats[sel], tgt, labels[sel][..., :22])
        got = tap.affinity_propagate_fused(*args, **kw)
        expect = tap.affinity_propagate_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:22], expect[:22], rtol=1e-4, atol=3.4e-5)
    assert (got[:22].argmax(0) == expect[:22].argmax(0)).all()


def test_card_tensors_never_take_the_plain_version(card):
    """A CUDA tensor the kernel does not take raises; it is not handed to the
    plain version."""
    x = torch.zeros((1, 4, 4, 512), device=card)  # float32, the kernel takes bf16
    w = [torch.zeros(s, device=card) for s in [(512, 128), (128,), (3, 3, 128, 128), (128,), (128, 512), (512,)]]
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        tb.bottleneck_block(x, *w)
    bank = torch.zeros((4, 1, 16, 32), device=card)  # float32
    with pytest.raises(TypeError, match="bfloat16"):
        tap.affinity_from_bank_batched(bank, bank, bank[0], [0], feature_hw=(4, 4), temperature=1.0)
    ref = torch.zeros((2, 16, 32), device=card)
    with pytest.raises(ValueError, match="target_feat is on cpu"):
        tap.affinity_propagate_fused(ref, ref[0].cpu(), ref, feature_hw=(4, 4), temperature=1.0)


def test_bank_kernel_eight_lanes_at_480p(card, nprng):
    """B = 8 lanes at 480p, the bank of ``--video-batch 8``, against the
    plain version lane by lane (the plain version holds a lane's (K, P, P)
    scores at once)."""
    hd, wd, c, d_pad, cap, k, b = 60, 107, 256, 24, 45, 9, 8
    p = hd * wd
    feats, labels = _bank(nprng, card, cap, b, p, c, d_pad)
    tgt = torch.as_tensor(nprng.standard_normal((b, p, c)) * 0.2, dtype=torch.float32).to(card, torch.bfloat16).float()
    idx, valid, dense = sample_frames(50, 40, k)
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    got = tap.affinity_from_bank_batched(feats, labels, tgt, idx % cap, **kw)
    torch.cuda.synchronize()
    for lane in range(b):
        expect = tap.affinity_from_bank_plain(feats[:, lane : lane + 1].float(), labels[:, lane : lane + 1].float(),
                                              tgt[lane : lane + 1], idx % cap, **kw)[0, :22]
        torch.testing.assert_close(got[lane, :22], expect, rtol=1e-4, atol=3.4e-5)
        assert (got[lane, :22].argmax(0) == expect.argmax(0)).double().mean().item() >= 0.999


def _moving_squares(nprng, videos, frames, h, w):
    """(frames, videos, h, w, 3) uint8 clips of two squares moving over a
    textured background, and their (videos, h, w) first-frame labels."""
    clips = np.zeros((frames, videos, h, w, 3), np.uint8)
    labels = np.zeros((videos, h, w), np.int64)
    for v in range(videos):
        bg = nprng.integers(0, 90, size=(h, w, 3), dtype=np.uint8)
        for t in range(frames):
            img = bg.copy()
            y, x = h // 4 + 2 * v, w // 6 + 3 * t
            img[y : y + h // 3, x : x + w // 5] = [210, 50 + 20 * v, 40]
            y2, x2 = 2 * h // 3, w // 2 - 2 * t
            img[y2 : y2 + h // 6, x2 : x2 + w // 6] = [40, 90, 220]
            clips[t, v] = img
            if t == 0:
                labels[v, y : y + h // 3, x : x + w // 5] = 1
                labels[v, y2 : y2 + h // 6, x2 : x2 + w // 6] = 2
    return clips, labels


def test_lockstep_engine_matches_single_engines(card, nprng):
    """The lockstep engine at B = 4 (resnet50, both kernels, one bank-kernel
    launch per step) against four single engines on the card; the encode
    batches differ (B x 8 frames against 8), so cuDNN may take other
    algorithms and bf16 moves a near-tied argmax now and then."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
    from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD, EngineConfig, PropagationEngine
    from semi_supervised_vos_tpu_torch.models.resnet import Bottleneck, init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    b, n, h, w = 4, 17, 128, 224
    clips, labels = _moving_squares(nprng, b, n, h, w)
    # a random resnet50 whose features tell the objects apart: BN statistics
    # estimated on the clips, residual branches scaled down (chip_smoke.py's recipe)
    net = VOSNet("resnet50")
    init_weights(net, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.reset_running_stats()
                m.momentum = None
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(0.1)
        x = torch.as_tensor(clips.reshape(-1, h, w, 3), device=card).float() / 255.0
        x = (x - torch.as_tensor(IMAGENET_MEAN, device=card)) / torch.as_tensor(IMAGENET_STD, device=card)
        net.to(card).train()(x.permute(0, 3, 1, 2))
    net.eval()
    cfg = EngineConfig()
    engine = BatchedPropagationEngine(net, (h, w), b, cfg, card)
    state = engine.start_videos(clips[0], labels)
    before = tap.affinity_from_bank_batched.launches
    lockstep = torch.cat([engine.step_chunk_small(clips[s : s + 8], state, s)[0] for s in range(1, n, 8)])
    torch.cuda.synchronize()
    assert tap.affinity_from_bank_batched.launches == before + n - 1
    single = PropagationEngine(net, (h, w), cfg, card)
    for v in range(b):
        st = single.start_video(clips[0, v], labels[v])
        masks = torch.cat([single.step_chunk_small(clips[s : s + 8, v], st, s)[0] for s in range(1, n, 8)])
        assert masks.max().item() >= 1  # the comparison is not between constant masks
        assert (lockstep[:, v] == masks).double().mean().item() >= 0.999, v
