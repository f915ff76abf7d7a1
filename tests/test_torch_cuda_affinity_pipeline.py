"""The bf16 bank sweep's pipeline at its edges, on an NVIDIA Hopper card,
against the plain PyTorch version. Every test here needs the card and skips
without one.

The sweep (``csrc/affinity_bank.cu``) streams bank tiles through a ring of
stages that a producer warpgroup fills and three consumer warpgroups free,
each with one similarity product in flight under its softmax of the tile
before. The cases below are where that pipeline runs short or meets masks:
a split with fewer tiles than the ring has stages, a split of one tile,
one slot, a ragged last tile, a split whose slots are all invalid, the
prior off, a stats shard past row 0, narrow features, two label groups,
the 1080p bank of two lanes, and frames wide enough to shrink the ring or
drop the column tables. Gates as in ``chip_smoke.py``: max_abs <= 3.4e-5 and
argmax agreement 1.0 (0.999 on the 1080p shape, where near-ties between
classes occur among 64,800 random pixels); combined stats shards <= 3.2e-5.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_affinity_pipeline.py
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


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90)")
    return torch.device("cuda")


@pytest.fixture
def nprng():
    return np.random.default_rng(11)


def _inputs(nprng, card, cap, b, p_loc, p, c, d_pad, n_cls=22):
    """bf16 bank features and one-hot labels, and a target holding bf16
    values (as the encoder emits them)."""
    feats = torch.as_tensor(nprng.standard_normal((cap, b, p_loc, c)) * 0.2, dtype=torch.float32)
    cls = torch.as_tensor(nprng.integers(0, n_cls, size=(cap, b, p_loc)))
    labels = torch.nn.functional.one_hot(cls, d_pad).float()
    tgt = torch.as_tensor(nprng.standard_normal((b, p, c)) * 0.2, dtype=torch.float32)
    return feats.to(card, torch.bfloat16), labels.to(card, torch.bfloat16), tgt.to(card, torch.bfloat16).float()


def _gates(got, expect, n_cls, gate=GATE, min_agree=1.0):
    got, expect = got[..., :n_cls, :], expect[..., :n_cls, :]
    max_abs = (got - expect).abs().max().item()
    agree = (got.argmax(-2) == expect.argmax(-2)).double().mean().item()
    assert max_abs <= gate, f"max_abs {max_abs:.3e} > {gate}"
    assert agree >= min_agree, f"argmax agreement {agree} < {min_agree}"


def _forced_sweep(feats, labels, tgt, slots, valid, dense, hw, splits, ips, spatial=True):
    """The sweep with the split plan given (``splits`` blocks per target
    tile, ``ips`` tiles each) instead of chosen, then the combine kernel:
    (B, D_pad, P) scores. Temperature 1."""
    dev = feats.device
    lib = tap._library()
    cap, b, p_loc, c = feats.shape
    d_pad = labels.shape[-1]
    hd, wd = hw
    p = hd * wd
    slots, inv_sigma2, bias = tap.slot_table(slots, valid, dense, 8.0, 21.0, spatial)
    table = np.stack([slots, inv_sigma2.view(np.int32), bias.view(np.int32), tap.column_tables(inv_sigma2)])
    table = torch.as_tensor(table, device=dev)
    target = tgt.to(torch.bfloat16).contiguous()
    pm = torch.empty((splits, b, p), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((splits, b, d_pad, p), dtype=torch.float32, device=dev)
    err = lib.affinity_bank_launch(
        feats.data_ptr(), labels.data_ptr(), target.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(),
        table.data_ptr(), len(slots), cap, b, p_loc, c, d_pad, 0, d_pad, p, wd, 0, splits, ips,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    assert err == 0, f"cudaError {err}"
    return tap._launch_combine(lib, pm, pl, pacc, False)


@pytest.mark.parametrize(
    "case,k,splits,ips",
    [("fewer_than_stages", 3, 1, 3), ("one_iteration", 3, 3, 1), ("two_then_one", 3, 2, 2),
     ("long_split", 9, 2, 23)],
)
def test_forced_splits_match_plain(card, nprng, case, k, splits, ips):
    """Splits given, not planned: three slots of one tile each (a 2 x 20
    grid) in one split of 3 tiles (the ring holds up to 4 stages), in three
    splits of one tile, in splits of 2 and 1; and nine slots of 5 tiles (16
    x 20) in splits of 23 and 22."""
    hd, wd = (2, 20) if k == 3 else (16, 20)
    p, cap = hd * wd, 45
    feats, labels, tgt = _inputs(nprng, card, cap, 1, p, p, 256, 24)
    idx, valid, dense = sample_frames(50, 40, 9)
    slots, valid, dense = idx[:k] % cap, valid[:k], dense[:k]
    assert (splits - 1) * ips < k * -(-p // 64) <= splits * ips
    got = _forced_sweep(feats, labels, tgt, slots, valid, dense, (hd, wd), splits, ips)
    torch.cuda.synchronize()
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    _gates(got, tap.affinity_from_bank_plain(feats.float(), labels.float(), tgt, slots, **kw), 22)


def test_split_of_invalid_slots_matches_plain(card, nprng):
    """The second split holds only invalid slots (its m is -1e30 and it
    weighs 0 in the combine); then every slot invalid (every split weighs
    1, the unsplit result)."""
    hd, wd, cap, k = 16, 20, 45, 9
    p = hd * wd
    feats, labels, tgt = _inputs(nprng, card, cap, 1, p, p, 256, 24)
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    for valid in (np.arange(k) < 5, np.zeros(k, bool)):
        got = _forced_sweep(feats, labels, tgt, slots, valid, dense, (hd, wd), 2, 25)
        torch.cuda.synchronize()
        kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
        _gates(got, tap.affinity_from_bank_plain(feats.float(), labels.float(), tgt, slots, **kw), 22)


@pytest.mark.parametrize(
    "case", ["k1", "ragged", "prior_off", "c64", "c128", "d72", "b3_ragged"],
)
def test_pipeline_cases_match_plain(card, nprng, case):
    """K = 1, a ragged last tile (13 x 27: 351 rows, the last tile 31), the
    prior off (probability mode), feature widths 64 and 128, 72 label
    columns (two label groups, 64 + 8), and three lanes on the ragged grid,
    through the planned split."""
    hd, wd = (13, 27) if case in ("ragged", "b3_ragged") else (16, 20)
    c = {"c64": 64, "c128": 128}.get(case, 256)
    d_pad, n_cls = (72, 70) if case == "d72" else (24, 22)
    b = 3 if case == "b3_ragged" else 1
    p, cap, k = hd * wd, 45, 9
    feats, labels, tgt = _inputs(nprng, card, cap, b, p, p, c, d_pad, n_cls)
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    if case == "k1":
        slots, valid, dense = slots[:1], valid[:1], dense[:1]
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense, spatial=case != "prior_off")
    before = tap.affinity_from_bank_batched.launches
    got = tap.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)
    torch.cuda.synchronize()
    assert tap.affinity_from_bank_batched.launches == before + 1
    _gates(got, tap.affinity_from_bank_plain(feats.float(), labels.float(), tgt, slots, **kw), n_cls)
    assert (got[:, n_cls:] == 0).all()  # padded classes exactly zero


def test_stats_shards_past_row_zero_match_plain(card, nprng):
    """Two stats shards of a 16 x 20 bank (row_base 0 and 160): each
    shard's (m, l, acc) against the plain version's, and the two combined
    against the unsharded plain result."""
    hd, wd, cap, k = 16, 20, 45, 9
    p = hd * wd
    feats, labels, tgt = _inputs(nprng, card, cap, 1, p, p, 256, 24)
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    parts = []
    for row_base in (0, p // 2):
        rows = slice(row_base, row_base + p // 2)
        f, lab = feats[:, :, rows].contiguous(), labels[:, :, rows].contiguous()
        got = tap.affinity_from_bank_batched(f, lab, tgt, slots, row_base=row_base, return_stats=True, **kw)
        torch.cuda.synchronize()
        expect = tap.affinity_from_bank_plain(f.float(), lab.float(), tgt, slots, row_base=row_base,
                                              return_stats=True, **kw)
        for g, e in zip(got, expect):
            torch.testing.assert_close(g, e, rtol=1e-4, atol=3.4e-5)
        parts.append(got)
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    combined = tap.combine_partials_plain(m, l, acc)
    _gates(combined, tap.affinity_from_bank_plain(feats.float(), labels.float(), tgt, slots, **kw), 22,
           gate=STATS_GATE)


def test_1080p_two_lanes_match_plain(card, nprng):
    """The 1080p bank of ``r50-1080p-vb2`` (135 x 240 feature grid, B = 2,
    K 9, C 256) through the planned split. The plain version runs on 16
    row shards of each lane's bank (its (K, P_loc, P) scores at once would
    take 38 GB) and combines them with ``combine_partials_plain``."""
    hd, wd, cap, k, b, shards = 135, 240, 45, 9, 2, 16
    p = hd * wd
    feats, labels, tgt = _inputs(nprng, card, cap, b, p, p, 256, 24)
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    got = tap.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)
    torch.cuda.synchronize()
    rows = p // shards
    for lane in range(b):
        parts = []
        for s in range(shards):
            sl = slice(s * rows, (s + 1) * rows)
            parts.append(tap.affinity_from_bank_plain(
                feats[:, lane : lane + 1, sl].float(), labels[:, lane : lane + 1, sl].float(), tgt[lane : lane + 1],
                slots, row_base=s * rows, return_stats=True, **kw))
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        _gates(got[lane : lane + 1], tap.combine_partials_plain(m, l, acc), 22, min_agree=0.999)


@pytest.mark.parametrize("wd", [2000, 4160])
def test_wide_frames_match_plain(card, nprng, wd):
    """Frames of 2 x 2000 and 2 x 4160 feature pixels: the first keeps its
    column tables with a shallower ring, the second is too wide for them
    and takes the column factor per pair."""
    hd, cap, k = 2, 12, 9
    p = hd * wd
    feats, labels, tgt = _inputs(nprng, card, cap, 1, p, p, 256, 24)
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    got = tap.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)
    torch.cuda.synchronize()
    _gates(got, tap.affinity_from_bank_plain(feats.float(), labels.float(), tgt, slots, **kw), 22)


def test_column_tables_number_each_distinct_prior():
    """Row 3 of the sweep's slot table: one column table per distinct
    nonzero inverse sigma^2 (dense and sparse slots), 0 where the prior is
    off, and no more than the sweep's two. Runs on the CPU too."""
    _, inv_sigma2, _ = tap.slot_table(np.arange(5), None, [True, False, True, False, False], 8.0, 21.0, True)
    tables = tap.column_tables(inv_sigma2)
    assert tables.dtype == np.int32 and sorted(set(tables.tolist())) == [0, 1]
    assert len({float(v) for v, k in zip(inv_sigma2, tables) if k == tables[0]}) == 1
    assert (tap.column_tables(np.zeros(3, np.float32)) == 0).all()
    with pytest.raises(ValueError, match="at most two"):
        tap.column_tables(np.array([1.0, 2.0, 3.0], np.float32))


def test_sweeps_count_their_split_plan(card, nprng, monkeypatch):
    """Each sweep adds 1 to counter ``affinity.sweeps`` and its split count
    to ``affinity.splits`` while the recorder runs: two label groups make
    two sweeps of the plan's splits."""
    monkeypatch.setattr(profiling, "_forced", True)
    profiling.reset()
    hd, wd, cap, k = 16, 20, 45, 9
    p = hd * wd
    feats, labels, tgt = _inputs(nprng, card, cap, 1, p, p, 256, 72, 70)
    idx, valid, dense = sample_frames(50, 40, k)
    tap.affinity_from_bank_batched(feats, labels, tgt, idx % cap, feature_hw=(hd, wd), temperature=1.0,
                                   valid=valid, dense=dense)
    torch.cuda.synchronize()
    splits, _ = tap._plan("affinity_bank", card.index or 0, k, 1, p, 256, p, wd)
    counters = profiling.summary()["counters"]
    profiling.reset()
    assert counters["affinity.sweeps"] == 2
    assert counters["affinity.splits"] == 2 * splits
