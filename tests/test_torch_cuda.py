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
    [(16, 20, 1, 0, False), (16, 20, 2, 0, False), (16, 20, 1, 160, True), (60, 107, 1, 0, False)],
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


@pytest.mark.parametrize("n,h,w,c,c4", [(1, 60, 107, 512, 128), (2, 60, 107, 1024, 256), (1, 13, 27, 512, 128)])
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
