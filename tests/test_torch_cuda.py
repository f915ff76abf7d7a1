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
    """A CUDA tensor the kernels do not take raises; it is not handed to the
    plain version, nor rounded to another dtype: float16 (the kernels take
    bf16 or float32), float32 labels (both bank kernels take bf16), bf16
    weights under float32 activations."""
    x = torch.zeros((1, 4, 4, 512), device=card, dtype=torch.float16)
    w = [torch.zeros(s, device=card) for s in [(512, 128), (128,), (3, 3, 128, 128), (128,), (128, 512), (512,)]]
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        tb.bottleneck_block(x, *w)
    w16 = [t.to(torch.bfloat16) if i % 2 == 0 else t for i, t in enumerate(w)]
    with pytest.raises(ValueError, match="expected torch.float32"):
        tb.bottleneck_block(x.float(), *w16)
    bank = torch.zeros((4, 1, 16, 32), device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        tap.affinity_from_bank_batched(bank, bank, bank[0], [0], feature_hw=(4, 4), temperature=1.0)
    bank = bank.float()
    with pytest.raises(TypeError, match="bank_labels must be torch.bfloat16"):
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


def _calibrated_resnet50(card, clips):
    """A random resnet50 whose features tell the objects apart: BN statistics
    estimated on the clips, residual branches scaled down (chip_smoke.py's
    recipe)."""
    from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD
    from semi_supervised_vos_tpu_torch.models.resnet import Bottleneck, init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet("resnet50")
    init_weights(net, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.reset_running_stats()
                m.momentum = None
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(0.1)
        x = torch.as_tensor(clips.reshape((-1,) + clips.shape[-3:]), device=card).float() / 255.0
        x = (x - torch.as_tensor(IMAGENET_MEAN, device=card)) / torch.as_tensor(IMAGENET_STD, device=card)
        net.to(card).train()(x.permute(0, 3, 1, 2))
    return net.eval()


def test_lockstep_engine_matches_single_engines(card, nprng):
    """The lockstep engine at B = 4 (resnet50, both kernels, one bank-kernel
    launch per step) against four single engines on the card; the encode
    batches differ (B x 8 frames against 8), so cuDNN may take other
    algorithms and bf16 moves a near-tied argmax now and then."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine

    b, n, h, w = 4, 17, 128, 224
    clips, labels = _moving_squares(nprng, b, n, h, w)
    net = _calibrated_resnet50(card, clips)
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


def test_sharded_engine_matches_single_engine(card, nprng):
    """``ShardedPropagationEngine`` on a virtual mesh that names the card
    twice (two bank shards, the stats-mode kernel per shard, the combine
    kernel) against the single engine: two bank-kernel launches a frame, and
    the masks differ only where bf16 and the split softmax move a near-tie."""
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
    from semi_supervised_vos_tpu_torch.parallel.engine_sharded import ShardedPropagationEngine
    from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh

    n, h, w = 17, 128, 224
    clips, labels = _moving_squares(nprng, 1, n, h, w)
    net = _calibrated_resnet50(card, clips)
    cfg = EngineConfig()
    sharded = ShardedPropagationEngine(net, (h, w), cfg, make_mesh(1, 2, devices=[card] * 2))
    assert sharded.p_loc * 2 >= sharded.p and all(f.is_cuda for f in sharded.init_state().feats)
    single = PropagationEngine(net, (h, w), cfg, card)
    out = {}
    for name, engine in (("sharded", sharded), ("single", single)):
        state = engine.start_video(clips[0, 0], labels[0])
        before = tap.affinity_from_bank_batched.launches
        out[name] = torch.cat([engine.step_chunk_small(clips[s : s + 8, 0], state, s)[0] for s in range(1, n, 8)])
        torch.cuda.synchronize()
        assert tap.affinity_from_bank_batched.launches == before + (2 if name == "sharded" else 1) * (n - 1)
    assert out["single"].max().item() >= 1  # the comparison is not between constant masks
    assert (out["sharded"] == out["single"]).double().mean().item() >= 0.995


def test_kernels_launch_on_their_tensors_device(card, nprng):
    """With card 0 current, tensors on card 1 run both kernels there (the
    libraries' host code and launches follow the runtime's current device),
    match their plain versions, and leave card 0 current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: with one, every tensor lies on the current card")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    hd, wd, c, d_pad, cap, k = 16, 20, 256, 24, 45, 9
    p = hd * wd
    feats, labels = _bank(nprng, other, cap, 1, p, c, d_pad)
    tgt = torch.as_tensor(nprng.standard_normal((1, p, c)) * 0.2, dtype=torch.float32).to(other, torch.bfloat16)
    tgt = tgt.float()
    idx, valid, dense = sample_frames(50, 40, k)
    for stats in (False, True):
        kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense, return_stats=stats)
        got = tap.affinity_from_bank_batched(feats, labels, tgt, idx % cap, **kw)
        torch.cuda.synchronize(other)
        expect = tap.affinity_from_bank_plain(feats.float(), labels.float(), tgt, idx % cap, **kw)
        for g, e in zip(got if stats else (got,), expect if stats else (expect,)):
            assert g.device == other
            torch.testing.assert_close(g, e, rtol=1e-4, atol=3.4e-5)
    x = torch.as_tensor(nprng.standard_normal((1, 13, 27, 512)) * 0.5, dtype=torch.float32).to(other, torch.bfloat16)
    shapes = [(512, 128), (128,), (3, 3, 128, 128), (128,), (128, 512), (512,)]
    wts = [torch.as_tensor(nprng.standard_normal(s) * (0.05 if len(s) > 1 else 0.1), dtype=torch.float32)
           .to(other, torch.bfloat16 if i % 2 == 0 else torch.float32) for i, s in enumerate(shapes)]
    got = tb.bottleneck_block(x, *wts).float()
    torch.cuda.synchronize(other)
    expect = tb.bottleneck_block_plain(x.float(), *[t.float() for t in wts])
    assert got.device == other
    assert torch.nn.functional.cosine_similarity(got.flatten(), expect.flatten(), dim=0) >= 0.9999
    assert (got - expect).abs().max() / expect.abs().max() <= 2e-2
    assert torch.cuda.current_device() == 0


def _train_clip(nprng, b, t, crop):
    """Random frames; annotations with two objects of the DAVIS palette."""
    imgs = nprng.integers(0, 255, (b, t, crop, crop, 3)).astype(np.uint8)
    anns = np.zeros((b, t, crop, crop, 3), np.uint8)
    anns[:, :, crop // 8 : crop // 2, crop // 6 : crop * 2 // 3] = [128, 0, 0]
    anns[:, :, crop * 9 // 16 : crop * 15 // 16, crop // 2 : crop * 15 // 16] = [0, 128, 0]
    return imgs, anns


def _train_step(card, arch, spec, imgs, anns, geometry_fn=None):
    from semi_supervised_vos_tpu_torch.cli.train import build_train_net
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    net = build_train_net(arch, card).train()
    step = make_train_step(net, spec, make_optimizer(net.parameters()))
    extra = ()
    if geometry_fn is not None:
        extra = (tuple(torch.as_tensor(g, device=card) for g in geometry_fn(anns)),)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    loss = step(torch.as_tensor(imgs, device=card), torch.as_tensor(anns, device=card),
                torch.as_tensor(davis_centroids(), dtype=torch.float32, device=card),
                torch.Generator(device=card).manual_seed(0), *extra)
    return loss.item(), net, before


def test_full_width_train_step(card, nprng):
    """One cross-entropy step of resnet50 at the train CLI's defaults (bs 16
    x 10 frames x 256^2): the loss is finite and every parameter moves."""
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec

    imgs, anns = _train_clip(nprng, 16, 10, 256)
    loss, net, before = _train_step(card, "resnet50", LossSpec(name="cross_entropy"), imgs, anns)
    assert np.isfinite(loss)
    after = net.state_dict()
    for name, _ in net.named_parameters():
        assert not torch.equal(after[name], before[name]), name


def test_pipelined_skeleton_step_matches_host_path(card, nprng, monkeypatch):
    """The skeleton miner on the card: pipelined by default (host geometry
    into the step, the picks on the card), and the same loss as the host
    path (budget above the candidates, so both mine one triplet set)."""
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec, make_geometry_fn, mining_mode
    from semi_supervised_vos_tpu_torch.train.miners import get_miner

    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.delenv("SVOS_MINING", raising=False)
    imgs, anns = _train_clip(nprng, 2, 3, 64)
    spec = LossSpec(name="triplet", miner=get_miner("skeleton"))
    assert mining_mode(spec, card) == "pipelined"
    geometry_fn = make_geometry_fn(spec, davis_centroids(), card)
    pipelined, _, _ = _train_step(card, "resnet18", spec, imgs, anns, geometry_fn)
    monkeypatch.setenv("SVOS_MINING", "callback")
    assert make_geometry_fn(spec, davis_centroids(), card) is None
    host, _, _ = _train_step(card, "resnet18", spec, imgs, anns)
    assert np.isfinite(pipelined)
    np.testing.assert_allclose(pipelined, host, rtol=1e-5)


def _facebook_net(card, clips):
    """A random facebook VOSNet whose BN statistics are estimated on
    ``clips`` and whose residual branches are scaled down (chip_smoke.py's
    recipe), on the card."""
    from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD
    from semi_supervised_vos_tpu_torch.models.resnet import Bottleneck, init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet("facebook")
    init_weights(net, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.reset_running_stats()
                m.momentum = None
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(0.1)
        x = torch.as_tensor(clips.reshape((-1,) + clips.shape[-3:]), device=card).float() / 255.0
        x = (x - torch.as_tensor(IMAGENET_MEAN, device=card)) / torch.as_tensor(IMAGENET_STD, device=card)
        net.to(card).train()(x.permute(0, 3, 1, 2))
    return net.eval()


def test_facebook_encoder_on_card(card, nprng, monkeypatch):
    """facebook's BN-folded bf16 encoder: 8 fused-bottleneck launches
    (layer2_1..3, layer3_1..5; the 2048-wide layer4 runs on cuDNN) and the
    encoder gate, min per-pixel cosine >= 0.9999 against the float32 module,
    with the JAX package's recipe (reference initialisation, perturbed BN
    running statistics)."""
    from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
    from semi_supervised_vos_tpu_torch.models.infer_fast import fast_encode
    from semi_supervised_vos_tpu_torch.models.resnet import init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # the float32 reference
    net = VOSNet("facebook").eval()
    g = torch.Generator().manual_seed(0)
    init_weights(net, g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.normal_(0.0, 1.0, generator=g).abs_().mul_(0.5).add_(0.5)
    net.to(card)
    x = torch.as_tensor(nprng.standard_normal((2, 128, 224, 3)), dtype=torch.float32, device=card)
    before = tb.bottleneck_block.launches
    with torch.no_grad():
        fast = fast_encode(fold_vosnet(net, torch.bfloat16), x, torch.bfloat16, arch="facebook").float()
        torch.cuda.synchronize()
        ref = net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tb.bottleneck_block.launches == before + 8
    assert fast.shape == ref.shape == (2, 16, 28, 256)
    cos = torch.nn.functional.cosine_similarity(fast.reshape(-1, 256), ref.reshape(-1, 256), dim=-1)
    assert cos.min().item() >= 0.9999


@pytest.mark.parametrize("flags", [(True, True), (False, False), (True, False)])
def test_engines_leave_tf32_flags_alone(card, nprng, flags):
    """Building a single and a lockstep engine on the card and running one
    step of each leaves both TF32 flags as the caller set them."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine

    clips, labels = _moving_squares(nprng, 2, 2, 64, 112)
    net = _facebook_net(card, clips)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        engine = PropagationEngine(net, (64, 112), EngineConfig(), card)
        engine.step_chunk_small(clips[1:, 0], engine.start_video(clips[0, 0], labels[0]), 1)
        lockstep = BatchedPropagationEngine(net, (64, 112), 2, EngineConfig(), card)
        lockstep.step_chunk_small(clips[1:], lockstep.start_videos(clips[0], labels), 1)
        torch.cuda.synchronize()
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---- the float32 variants (SVOS_INFER_DTYPE=float32) -----------------------


@pytest.mark.parametrize(
    "hd,wd,b,row_base,stats,spatial",
    [(16, 20, 1, 0, False, True), (16, 20, 2, 0, False, True), (16, 20, 1, 160, True, True),
     (60, 107, 1, 0, False, True), (60, 107, 1, 0, False, False), (13, 27, 1, 0, False, True),
     (60, 107, 1, 3200, True, True)],
)
def test_f32_bank_kernel_matches_plain(card, nprng, hd, wd, b, row_base, stats, spatial):
    """``csrc/affinity_bank_f32.cu`` on a float32 bank and target (bf16
    labels) against its plain version, which computes in float32 on the
    card with full-float32 products."""
    c, d_pad, cap, k = 256, 24, 45, 9
    p = hd * wd
    feats, labels = _bank(nprng, card, cap, b, p - row_base, c, d_pad)
    feats = torch.as_tensor(nprng.standard_normal(tuple(feats.shape)) * 0.2, dtype=torch.float32, device=card)
    tgt = torch.as_tensor(nprng.standard_normal((b, p, c)) * 0.2, dtype=torch.float32, device=card)
    idx, valid, dense = sample_frames(50, 40, k)
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense, spatial=spatial,
              row_base=row_base, return_stats=stats)
    before = (tap.affinity_from_bank_batched.launches, tap.affinity_from_bank_batched.launches_f32)
    got = tap.affinity_from_bank_batched(feats, labels, tgt, idx % cap, **kw)
    torch.cuda.synchronize()
    assert (tap.affinity_from_bank_batched.launches, tap.affinity_from_bank_batched.launches_f32) == (
        before[0], before[1] + 1)
    expect = tap.affinity_from_bank_plain(feats, labels, tgt, idx % cap, **kw)
    got = got if stats else (got,)
    expect = expect if stats else (expect,)
    # float32 throughout; summation order and exp2 differ
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, rtol=1e-4, atol=3.4e-5)
    if not stats:
        assert (got[0][:, :22].argmax(1) == expect[0][:, :22].argmax(1)).all()
        assert (got[0][:, 22:] == 0).all()


def test_f32_bank_kernel_eight_lanes_at_480p(card, nprng):
    """B = 8 float32 lanes at 480p against the plain version lane by lane."""
    hd, wd, c, d_pad, cap, k, b = 60, 107, 256, 24, 45, 9, 8
    p = hd * wd
    _, labels = _bank(nprng, card, cap, b, p, c, d_pad)
    feats = torch.randn((cap, b, p, c), generator=torch.Generator(device=card).manual_seed(3), device=card) * 0.2
    tgt = torch.as_tensor(nprng.standard_normal((b, p, c)) * 0.2, dtype=torch.float32, device=card)
    idx, valid, dense = sample_frames(50, 40, k)
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    got = tap.affinity_from_bank_batched(feats, labels, tgt, idx % cap, **kw)
    torch.cuda.synchronize()
    for lane in range(b):
        expect = tap.affinity_from_bank_plain(feats[:, lane : lane + 1], labels[:, lane : lane + 1],
                                              tgt[lane : lane + 1], idx % cap, **kw)[0, :22]
        torch.testing.assert_close(got[lane, :22], expect, rtol=1e-4, atol=3.4e-5)
        assert (got[lane, :22].argmax(0) == expect.argmax(0)).all()


@pytest.mark.parametrize(
    "n,h,w,c,c4",
    [(1, 60, 107, 512, 128), (2, 60, 107, 1024, 256), (1, 13, 27, 512, 128), (1, 69, 123, 1024, 256),
     (1, 54, 97, 512, 128), (3, 13, 27, 1024, 256)],
)
def test_f32_bottleneck_kernel_matches_plain(card, nprng, monkeypatch, n, h, w, c, c4):
    """``csrc/bottleneck_f32.cu`` against its plain version with TF32 off
    (cuDNN would round the plain version's 3x3 otherwise): max error <= 1e-4
    of the largest output."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.as_tensor(nprng.standard_normal((n, h, w, c)) * 0.5, dtype=torch.float32, device=card)
    shapes = [(c, c4), (c4,), (3, 3, c4, c4), (c4,), (c4, c), (c,)]
    wts = [torch.as_tensor(nprng.standard_normal(s) * (0.05 if len(s) > 1 else 0.1), dtype=torch.float32,
                           device=card) for s in shapes]
    before = (tb.bottleneck_block.launches, tb.bottleneck_block.launches_f32)
    got = tb.bottleneck_block(x, *wts)
    torch.cuda.synchronize()
    assert (tb.bottleneck_block.launches, tb.bottleneck_block.launches_f32) == (before[0], before[1] + 1)
    assert got.dtype == torch.float32
    expect = tb.bottleneck_block_plain(x, *wts)
    assert (got - expect).abs().max() <= 1e-4 * expect.abs().max()


@pytest.mark.parametrize(
    "hd,wd,b,sigma_2,row_base,stats",
    [(2, 960, 1, 21.0, 0, False), (2, 960, 2, 21.0, 0, False), (2, 960, 1, 100.0, 0, False),
     (3, 997, 1, 21.0, 0, False), (2, 960, 1, 21.0, 960, True)],
)
def test_f32_bank_kernel_wide_frames(card, nprng, hd, wd, b, sigma_2, row_base, stats):
    """The float32 bank kernel on frames of 8K width (feature width 960,
    ragged 997), where its column table holds only the prior's reach (at
    sigma_2 100 the prior is too wide for the table and the factor is taken
    per pair), and a stats shard at row_base 960: against the plain
    version, max_abs <= 3.4e-5 (stats 3.2e-5) and the argmax everywhere."""
    c, d_pad, cap, k = 256, 24, 45, 9
    p = hd * wd
    _, labels = _bank(nprng, card, cap, b, p - row_base, c, d_pad)
    feats = torch.as_tensor(nprng.standard_normal((cap, b, p - row_base, c)) * 0.2, dtype=torch.float32,
                            device=card)
    tgt = torch.as_tensor(nprng.standard_normal((b, p, c)) * 0.2, dtype=torch.float32, device=card)
    idx, valid, dense = sample_frames(50, 40, k)
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense, sigma_2=sigma_2, row_base=row_base,
              return_stats=stats)
    before = tap.affinity_from_bank_batched.launches_f32
    got = tap.affinity_from_bank_batched(feats, labels, tgt, idx % cap, **kw)
    torch.cuda.synchronize()
    assert tap.affinity_from_bank_batched.launches_f32 == before + 1
    expect = tap.affinity_from_bank_plain(feats, labels, tgt, idx % cap, **kw)
    if stats:
        for g, e in zip(got, expect):
            torch.testing.assert_close(g, e, rtol=1e-4, atol=3.2e-5)
        got, expect = got[2] / got[1][:, None], expect[2] / expect[1][:, None]
    torch.testing.assert_close(got, expect, rtol=1e-4, atol=3.4e-5)
    assert (got[:, :22].argmax(1) == expect[:, :22].argmax(1)).all()


def test_f32_plan_passes_wide_frames(monkeypatch):
    """Needs no card: ``ops/affinity.py::_plan`` hands any frame width to
    the kernel's plan unchanged (the width limit was the kernel's own shared
    memory, not the Python side's)."""
    import contextlib

    calls = []

    class Lib:
        def affinity_bank_f32_plan(self, k, b, p_loc, c, p, wd, splits, ips):
            calls.append((k, b, p_loc, c, p, wd))
            splits._obj.value, ips._obj.value = 3, 5
            return 0

    monkeypatch.setattr(tap, "_library", lambda name="affinity_bank": Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    tap._plan.cache_clear()
    try:
        assert tap._plan("affinity_bank_f32", 0, 9, 1, 540 * 960, 256, 540 * 960, 960) == (3, 5)
        assert tap._plan("affinity_bank_f32", 0, 9, 8, 4 * 4152, 256, 4 * 4152, 4152) == (3, 5)
    finally:
        tap._plan.cache_clear()
    assert calls == [(9, 1, 540 * 960, 256, 540 * 960, 960), (9, 8, 4 * 4152, 256, 4 * 4152, 4152)]


def test_entry_step_launches_kernel_3(card):
    """The flagship step (``graft_entry.py::entry``) on the card by default:
    one ``affinity_propagate_fused`` launch a step and no other kernel; its
    argmax against the same step on the CPU on >= 98 % of pixels."""
    import copy

    from semi_supervised_vos_tpu_torch.graft_entry import entry

    step, args = entry()
    assert all(a.device.type == "cuda" for a in args[1:4])
    counts = lambda: (tap.affinity_from_bank_batched.launches, tap.affinity_propagate_fused.launches,  # noqa: E731
                      tap.affinity_from_bank_batched.launches_f32, tb.bottleneck_block.launches,
                      tb.bottleneck_block.launches_f32)
    before = counts()
    mask = step(*args)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [0, 1, 0, 0, 0]
    cpu_mask = step(copy.deepcopy(args[0]).cpu(), *(a.cpu() for a in args[1:4]), args[4])
    assert (mask.cpu() == cpu_mask).double().mean() >= 0.98


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bottleneck_stack_on_card(card, nprng, monkeypatch, dtype):
    """``bottleneck_stack`` over three blocks: one launch a block of the
    dtype's kernel, against the plain blocks in sequence (bf16: the
    bottleneck gate; float32, TF32 off: 1e-4 of the largest output)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    n, h, w, c, c4 = 2, 13, 27, 1024, 256
    x = torch.relu(torch.as_tensor(nprng.standard_normal((n, h, w, c)), dtype=torch.float32, device=card)).to(dtype)
    shapes = [(c, c4), (c4,), (3, 3, c4, c4), (c4,), (c4, c), (c,)]
    blocks = [[torch.as_tensor(nprng.standard_normal(s) * (0.03 if len(s) > 1 else 0.1), dtype=torch.float32,
                               device=card) for s in shapes] for _ in range(3)]
    blocks = [tuple(t.to(dtype) if len(t.shape) > 1 else t for t in blk) for blk in blocks]
    before = (tb.bottleneck_block.launches, tb.bottleneck_block.launches_f32)
    got = tb.bottleneck_stack(x, blocks).float()
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert (tb.bottleneck_block.launches, tb.bottleneck_block.launches_f32) == (before[0] + 3 * (not f32),
                                                                                before[1] + 3 * f32)
    expect = x
    for blk in blocks:
        expect = tb.bottleneck_block_plain(expect, *blk)
    expect = expect.float()
    rel = ((got - expect).abs().max() / expect.abs().max()).item()
    if f32:
        assert rel <= 1e-4
    else:
        cos = torch.nn.functional.cosine_similarity(got.double().flatten(), expect.double().flatten(), dim=0)
        assert cos >= 0.9999 and rel <= 2e-2


@pytest.mark.parametrize(
    "c,d_pad,n_cls,hd,wd,row_base,stats",
    [(256, 8, 6, 16, 20, 0, False), (256, 16, 13, 16, 20, 0, False), (256, 24, 22, 13, 27, 0, False),
     (256, 48, 40, 16, 20, 0, False), (128, 24, 22, 16, 20, 0, False), (48, 16, 13, 13, 27, 0, False),
     (256, 16, 13, 60, 107, 3210, True), (256, 8, 6, 16, 20, 107, True)],
)
def test_f32_bank_kernel_label_groups_and_widths(card, nprng, c, d_pad, n_cls, hd, wd, row_base, stats):
    """The 3xTF32 bank kernel over every label group (8, 16, 24 columns,
    and two sweeps at d_pad 48), feature widths below 256 (the chunks past
    C run on zeros), ragged widths (27, 107) and row_base shards, against
    its float32 plain version."""
    cap, k, b = 45, 9, 1
    p = hd * wd
    _, labels = _bank(nprng, card, cap, b, p - row_base, c, d_pad, n_cls)
    feats = torch.as_tensor(nprng.standard_normal((cap, b, p - row_base, c)) * 0.2, dtype=torch.float32,
                            device=card)
    tgt = torch.as_tensor(nprng.standard_normal((b, p, c)) * 0.2, dtype=torch.float32, device=card)
    idx, valid, dense = sample_frames(50, 40, k)
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense, row_base=row_base, return_stats=stats)
    before = tap.affinity_from_bank_batched.launches_f32
    got = tap.affinity_from_bank_batched(feats, labels, tgt, idx % cap, **kw)
    torch.cuda.synchronize()
    assert tap.affinity_from_bank_batched.launches_f32 == before + 1
    expect = tap.affinity_from_bank_plain(feats, labels, tgt, idx % cap, **kw)
    got = got if stats else (got,)
    expect = expect if stats else (expect,)
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, rtol=1e-4, atol=3.4e-5)
    if not stats:
        assert (got[0][:, :n_cls].argmax(1) == expect[0][:, :n_cls].argmax(1)).all()
        assert (got[0][:, n_cls:] == 0).all()


@pytest.mark.parametrize("arch", ["resnet101", "facebook"])
def test_f32_bottleneck_fold_tables_match_plain(card, nprng, monkeypatch, arch):
    """Every fused block of a float32 fold table (resnet101: 28 blocks at C
    512 / 1024; facebook: 8) through ``csrc/bottleneck_f32.cu`` with the
    table's fold-time tf32 planes, at the 480p geometry (60 x 107), against
    the plain version with TF32 off: max error <= 1e-4 of the largest
    output; the planes reassemble to the table's weights."""
    from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
    from semi_supervised_vos_tpu_torch.models.resnet import init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    net = VOSNet(arch).eval()
    init_weights(net, torch.Generator().manual_seed(1))
    with torch.no_grad():
        table = fold_vosnet(net.to(card), torch.float32)
    names = sorted(k.split("/")[0] for k in table if k.endswith("/fused_tf32"))
    assert len(names) == {"resnet101": 28, "facebook": 8}[arch]
    for name in names:
        w1, b1, w2, b2, w3, b3 = table[f"{name}/fused"]
        planes = table[f"{name}/fused_tf32"]
        c, c4 = w1.shape
        assert (planes.w1.sum(0) - w1.t()).abs().max() <= 2.0**-21 * w1.abs().max()
        x = torch.as_tensor(np.maximum(nprng.standard_normal((1, 60, 107, c)), 0), dtype=torch.float32, device=card)
        got = tb.bottleneck_block(x, w1, b1, w2, b2, w3, b3, planes=planes)
        torch.cuda.synchronize()
        expect = tb.bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3)
        assert (got - expect).abs().max() <= 1e-4 * expect.abs().max(), name


@pytest.mark.parametrize("flags", [(True, True), (False, False)])
def test_f32_engines_one_step(card, nprng, flags):
    """A float32 single engine and a float32 lockstep engine (resnet50), one
    chunk each: only the float32 kernels launch (11 bottleneck launches an
    encode call, one bank launch a step), the lockstep masks equal the single
    engine's, and both TF32 flags are left as the caller set them."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine

    b, n, h, w = 2, 5, 128, 224
    clips, labels = _moving_squares(nprng, b, n, h, w)
    net = _calibrated_resnet50(card, clips)
    cfg = EngineConfig(compute_dtype=torch.float32)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        counters = (tap.affinity_from_bank_batched, tb.bottleneck_block)
        before = [(f.launches, f.launches_f32) for f in counters]
        single = PropagationEngine(net, (h, w), cfg, card)
        assert single.dtype == torch.float32 and single.label_dtype == torch.bfloat16
        st = single.start_video(clips[0, 0], labels[0])
        masks, st = single.step_chunk_small(clips[1:, 0], st, 1)
        lockstep = BatchedPropagationEngine(net, (h, w), b, cfg, card)
        lst = lockstep.start_videos(clips[0], labels)
        lmasks, lst = lockstep.step_chunk_small(clips[1:], lst, 1)
        torch.cuda.synchronize()
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
        after = [(f.launches, f.launches_f32) for f in counters]
        assert after[0] == (before[0][0], before[0][1] + 2 * (n - 1))  # single: n - 1 steps; lockstep: n - 1
        assert after[1] == (before[1][0], before[1][1] + 4 * 11)  # two encode calls each
        assert st.feats.dtype == lst.feats.dtype == torch.float32
        assert masks.max().item() >= 1
        assert (lmasks[:, 0] == masks).double().mean().item() >= 0.999
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_mesh_train_step_matches_single_step(card, nprng, shape):
    """DP 2 (BatchNorm over the global batch) and 1 x 2 channel sharding on
    a mesh naming the card twice, against the single-device step from the
    same weights and batch, TF32 off (resnet18, bs 4 x 3 frames x 64^2):
    loss to 1e-5 relative, the conv1 update's cosine > 0.999."""
    from semi_supervised_vos_tpu_torch.models.resnet import init_train_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh
    from semi_supervised_vos_tpu_torch.parallel.tp import shard_tp
    from semi_supervised_vos_tpu_torch.parallel.train_mesh import MeshNet, make_mesh_train_step
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec, make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    imgs, anns = (torch.as_tensor(a, device=card) for a in _train_clip(nprng, 4, 3, 64))
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32, device=card)
    spec = LossSpec(name="cross_entropy")
    nets = []
    for _ in range(2):
        net = VOSNet("resnet18")
        init_train_weights(net, torch.Generator().manual_seed(0))
        nets.append(net.to(card).train())
    k0 = nets[0].backbone[0].weight.detach().clone()
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        opt = make_optimizer(nets[0].parameters(), base_lr=0.01)
        want = make_train_step(nets[0], spec, opt)(imgs, anns, centroids, torch.Generator(device=card).manual_seed(1))
        mesh = make_mesh(*shape, devices=[card] * 2)
        opt = make_optimizer(nets[1].parameters(), base_lr=0.01)
        mnet = shard_tp(mesh, nets[1], opt) if shape[1] > 1 else MeshNet(mesh, nets[1], opt)
        got = make_mesh_train_step(mnet, spec)(imgs, anns, centroids, torch.Generator(device=card).manual_seed(1))
        mnet.sync_to_net()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    u = (nets[1].backbone[0].weight - k0).flatten()
    v = (nets[0].backbone[0].weight - k0).flatten()
    assert float(u @ v / (u.norm() * v.norm())) > 0.999


def test_native_upsampler_on_card_masks(card, nprng):
    """The native upsampler is on, and its bytes equal the numpy mapping's
    on masks the card computed (the lockstep drain's (T, B, h, w) layout)."""
    from semi_supervised_vos_tpu_torch.ops import native_upsample
    from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize_host

    assert native_upsample.available(), native_upsample.reason
    scores = torch.randn(22, 8, 2, 60, 107, device=card)
    masks = scores.argmax(0).to(torch.uint8).cpu().numpy()
    got = nearest_resize_host(masks, (480, 854), hw_axes=(2, 3))
    np.testing.assert_array_equal(got, native_upsample._numpy_twin(masks, (480, 854)))
    assert got.shape == (8, 2, 480, 854)
