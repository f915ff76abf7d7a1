"""The bf16 bank sweep's wide variant (``csrc/affinity_bank.cu``, features
wider than 256 channels: DINO ViT-B/8's 768) against the plain PyTorch
version, on an NVIDIA Hopper card at 480p (60 x 107); every test skips
without one. Widths 512 and 768, label and probability propagation, the
prior on and off, one lane and eight, stats mode over two bank shards with
the combine; and the two consumer warpgroups' alternation at its edges: a
split of an odd number of tiles (warpgroup 1 takes one fewer), splits of one
tile (warpgroup 1 takes none and merges its empty state), and the 1080p
grid (135 x 240: its wider column tables leave the shallowest ring, 4 boxes
at C 768) against 16 row shards of the plain version. Gates as the narrow sweep's (``test_torch_cuda_affinity_pipeline.py``):
max_abs <= 3.4e-5; argmax agreement 0.999 (random unit-norm features at
temperature 10 give near-flat class scores, all 22 within ~30 % of each
other, so a few of 6,420 pixels tie: one did at C 512); combined stats
shards <= 3.2e-5. The plain version runs lane by lane (a lane's dense
(K, P, P) scores are 1.5 GB) on the bf16 bank, so that it rounds the
target after the temperature (10, the ViT's) as the kernel does.

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_affinity_wide.py
"""

import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
from semi_supervised_vos_tpu_torch.ops import affinity as tap
from semi_supervised_vos_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

GATE = 3.4e-5
STATS_GATE = 3.2e-5
HW = (60, 107)


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90)")
    return torch.device("cuda")


def _inputs(card, seed, cap, b, p_loc, p, c, d_pad=24, n_cls=22):
    """bf16 bank features (unit-norm rows, as the ViT's are) and one-hot
    labels, and a bf16-valued target."""
    g = torch.Generator(device=card).manual_seed(seed)
    feats = torch.nn.functional.normalize(torch.randn((cap, b, p_loc, c), generator=g, device=card), dim=-1)
    labels = torch.nn.functional.one_hot(torch.randint(0, n_cls, (cap, b, p_loc), generator=g, device=card), d_pad)
    tgt = torch.nn.functional.normalize(torch.randn((b, p, c), generator=g, device=card), dim=-1)
    return feats.to(torch.bfloat16), labels.to(torch.bfloat16), tgt.to(torch.bfloat16).float()


def _plain_by_lane(feats, labels, tgt, slots, **kw):
    """The plain version lane by lane, on the bf16 bank (so that it rounds
    the target to bf16 after the temperature, as the kernel does)."""
    return torch.cat([tap.affinity_from_bank_plain(feats[:, i:i + 1], labels[:, i:i + 1].float(), tgt[i:i + 1],
                                                   slots, **kw) for i in range(tgt.shape[0])])


def _gates(got, expect, n_cls=22, min_agree=0.999):
    got, expect = got[:, :n_cls], expect[:, :n_cls]
    max_abs = (got - expect).abs().max().item()
    agree = (got.argmax(-2) == expect.argmax(-2)).double().mean().item()
    assert max_abs <= GATE, f"max_abs {max_abs:.3e} > {GATE}"
    assert agree >= min_agree, f"argmax agreement {agree} < {min_agree}"


@pytest.mark.parametrize("c", [512, 768])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("spatial", [True, False], ids=["label", "probability"])
def test_wide_sweep_matches_plain(card, c, b, spatial):
    """Label mode with the prior and probability mode without it (the
    engines' two modes), at temperature 10 (the ViT's), through the planned
    split; the launch is counted as a wide sweep."""
    hd, wd = HW
    p, cap = hd * wd, 45
    feats, labels, tgt = _inputs(card, c + b + spatial, cap, b, p, p, c)
    idx, valid, dense = sample_frames(50, 40, 9)
    slots = idx % cap
    kw = dict(feature_hw=HW, temperature=10.0, valid=valid, dense=dense, spatial=spatial)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = tap.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)
        torch.cuda.synchronize()
    counters = profiling.summary()["counters"]
    assert counters.get("affinity.wide_sweeps") == counters.get("affinity.sweeps") == 1
    _gates(got, _plain_by_lane(feats, labels, tgt, slots, **kw))
    assert (got[:, 22:] == 0).all()  # padded classes exactly zero


@pytest.mark.parametrize("c", [512, 768])
def test_wide_stats_shards_combine_to_plain(card, c):
    """Two stats shards of the 480p bank (row_base 0 and 3,210), as a
    ``--bank-shards 2`` engine launches them: each shard's (m, l, acc)
    against the plain version's, and the two combined by the combine kernel
    against the unsharded plain result."""
    hd, wd = HW
    p, cap, half = hd * wd, 45, hd * wd // 2
    feats, labels, tgt = _inputs(card, c, cap, 1, p, p, c)
    idx, valid, dense = sample_frames(50, 40, 9)
    slots = idx % cap
    kw = dict(feature_hw=HW, temperature=10.0, valid=valid, dense=dense)
    parts = []
    for base in (0, half):
        shard = (feats[:, :, base:base + half].contiguous(), labels[:, :, base:base + half].contiguous())
        got = tap.affinity_from_bank_batched(*shard, tgt, slots, row_base=base, return_stats=True, **kw)
        torch.cuda.synchronize()
        expect = tap.affinity_from_bank_plain(shard[0], shard[1].float(), tgt, slots, row_base=base,
                                              return_stats=True, **kw)
        for g, e in zip(got, expect):
            torch.testing.assert_close(g, e, rtol=1e-4, atol=3.4e-5)
        parts.append(got)
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    got = tap.combine_partials(m, l, acc)  # the combine kernel
    torch.cuda.synchronize()
    expect = tap.affinity_from_bank_plain(feats, labels.float(), tgt, slots, **kw)
    assert (got[:, :22] - expect[:, :22]).abs().max().item() <= STATS_GATE
    assert (got[:, :22].argmax(-2) == expect[:, :22].argmax(-2)).double().mean().item() >= 0.999


def test_wide_widths_are_checked(card):
    """A width past 256 that is not a multiple of 64, or past 768, is
    refused before any launch."""
    for c in (272, 832):
        feats, labels, tgt = _inputs(card, 1, 4, 1, 64, 64, c)
        with pytest.raises(ValueError, match="multiple of 64"):
            tap.affinity_from_bank_batched(feats, labels, tgt, [0, 1], feature_hw=(8, 8), temperature=1.0)


def _forced_sweep(feats, labels, tgt, slots, valid, dense, hw, splits, ips, spatial, temperature=10.0):
    """The sweep with the split plan given (``splits`` blocks per target
    tile, ``ips`` tiles each) instead of chosen, then the combine kernel:
    (B, D_pad, P) scores (as ``test_torch_cuda_affinity_pipeline.py``'s, with
    the temperature folded in)."""
    dev = feats.device
    lib = tap._library()
    cap, b, p_loc, c = feats.shape
    d_pad = labels.shape[-1]
    p = hw[0] * hw[1]
    slots, inv_sigma2, bias = tap.slot_table(slots, valid, dense, 8.0, 21.0, spatial)
    table = np.stack([slots, inv_sigma2.view(np.int32), bias.view(np.int32), tap.column_tables(inv_sigma2)])
    table = torch.as_tensor(table, device=dev)
    target = (tgt * temperature).to(torch.bfloat16).contiguous()
    pm = torch.empty((splits, b, p), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((splits, b, d_pad, p), dtype=torch.float32, device=dev)
    err = lib.affinity_bank_launch(
        feats.data_ptr(), labels.data_ptr(), target.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(),
        table.data_ptr(), len(slots), cap, b, p_loc, c, d_pad, 0, d_pad, p, hw[1], 0, splits, ips,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    assert err == 0, f"cudaError {err}"
    return tap._launch_combine(lib, pm, pl, pacc, False)


@pytest.mark.parametrize(
    "case,hw,k,splits,ips",
    [("one_iteration", (2, 20), 3, 3, 1), ("two_then_one", (2, 20), 3, 2, 2), ("odd_split", HW, 9, 2, 455)],
)
@pytest.mark.parametrize("c", [512, 768])
@pytest.mark.parametrize("spatial", [True, False], ids=["label", "probability"])
def test_wide_forced_splits_match_plain(card, case, hw, k, splits, ips, c, spatial):
    """Splits given, not planned, so that the two consumer warpgroups'
    alternate tiles end unevenly: three slots of one tile each (a 2 x 20
    grid) in three splits of one tile (warpgroup 1 takes none, and its empty
    state, m = -1e30 and l = 0, merges as nothing) and in splits of 2 and 1;
    nine slots of the 480p grid (909 tiles) in splits of 455 and 454 tiles
    (warpgroup 1 takes one fewer in the first)."""
    hd, wd = hw
    p, cap = hd * wd, 45
    feats, labels, tgt = _inputs(card, c + splits + spatial, cap, 1, p, p, c)
    idx, valid, dense = sample_frames(50, 40, 9)
    slots, valid, dense = idx[:k] % cap, valid[:k], dense[:k]
    assert (splits - 1) * ips < k * -(-p // 64) <= splits * ips
    got = _forced_sweep(feats, labels, tgt, slots, valid, dense, hw, splits, ips, spatial)
    torch.cuda.synchronize()
    kw = dict(feature_hw=hw, temperature=10.0, valid=valid, dense=dense, spatial=spatial)
    _gates(got, _plain_by_lane(feats, labels, tgt, slots, **kw))


@pytest.mark.parametrize("c", [512, 768])
@pytest.mark.parametrize("spatial", [True, False], ids=["label", "probability"])
def test_wide_1080p_matches_plain(card, c, spatial):
    """The 1080p grid (135 x 240, K 9, one lane) through the planned split:
    at C 768 the box ring holds 4 boxes (5 at 480p). The plain version runs on 16 row
    shards of the bank (its (K, P_loc, P) scores at once would take 38 GB)
    and combines them with ``combine_partials_plain``."""
    hd, wd, cap, shards = 135, 240, 45, 16
    p = hd * wd
    feats, labels, tgt = _inputs(card, c + spatial, cap, 1, p, p, c)
    idx, valid, dense = sample_frames(50, 40, 9)
    slots = idx % cap
    kw = dict(feature_hw=(hd, wd), temperature=10.0, valid=valid, dense=dense, spatial=spatial)
    got = tap.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)
    torch.cuda.synchronize()
    rows = p // shards
    parts = [tap.affinity_from_bank_plain(feats[:, :, s * rows:(s + 1) * rows],
                                          labels[:, :, s * rows:(s + 1) * rows].float(), tgt, slots,
                                          row_base=s * rows, return_stats=True, **kw)
             for s in range(shards)]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    _gates(got, tap.combine_partials_plain(m, l, acc))
