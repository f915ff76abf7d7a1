"""The bank sweep split into parts (slot groups and row ranges) and combined
again: ``combine_partials_plain``, the plain version of the combine kernel
of ``csrc/affinity_bank.cu``, on the partial statistics of
``affinity_from_bank_plain``, against the unsplit plain version at float32
and against the JAX Pallas kernel in interpret mode. The combine kernel
itself is held against its plain version on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.ops import affinity_pallas as jap
from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
from semi_supervised_vos_tpu_torch.ops import affinity as tap
from tests.test_pallas_affinity import _assert_argmax_close

P_PAD, C, D_PAD = 128, 32, 24

CASES = {
    # name: (hd, wd, cap, k, frame_idx, spatial, b, slot groups, row cuts, invalid slots)
    "slot_groups": (6, 8, 12, 9, 50, True, 1, [[0, 1, 2], [3, 4, 5], [6, 7, 8]], [0], []),
    "slot_groups_rows": (6, 8, 12, 9, 50, True, 1, [[0, 1, 2, 3], [4, 5, 6, 7, 8]], [0, 24], []),
    "invalid_group": (6, 8, 12, 9, 50, True, 1, [[0, 1], [2, 3, 4, 5, 6, 7, 8]], [0], [0, 1]),
    "all_invalid": (6, 8, 12, 5, 9, True, 1, [[0, 1], [2, 3, 4]], [0], [0, 1, 2, 3, 4]),
    "k1": (6, 8, 12, 1, 1, True, 1, [[0]], [0, 16, 32], []),
    "ragged_p": (5, 7, 12, 9, 50, True, 1, [[0, 1, 2, 3, 4], [5, 6, 7, 8]], [0, 32, 64], []),
    "batched": (6, 8, 12, 5, 9, True, 2, [[0, 1, 2], [3, 4]], [0, 40], []),
    "probability": (6, 8, 12, 5, 11, False, 1, [[0], [1, 2], [3, 4]], [0, 20], []),
}


def _inputs(rng, case):
    hd, wd, cap, k, frame_idx, spatial, b, groups, cuts, invalid = CASES[case]
    p = hd * wd
    feats = np.zeros((cap, b, P_PAD, C), np.float32)
    labels = np.zeros((cap, b, P_PAD, D_PAD), np.float32)
    feats[:, :, :p] = rng.standard_normal((cap, b, p, C)) * 0.3
    cls = rng.integers(0, 5, size=(cap, b, p))
    labels[np.arange(cap)[:, None, None], np.arange(b)[None, :, None], np.arange(p)[None, None], cls] = 1.0
    tgt = (rng.standard_normal((b, p, C)) * 0.3).astype(np.float32)
    idx, valid, dense = sample_frames(frame_idx, 40, k)
    valid = np.array(valid, bool)
    valid[invalid] = False
    kw = dict(feature_hw=(hd, wd), temperature=1.1, sigma_1=8.0, sigma_2=21.0, spatial=spatial)
    return feats, labels, tgt, idx % cap, valid, np.asarray(dense, bool), groups, cuts, kw


def _partials(feats, labels, tgt, slots, valid, dense, groups, cuts, kw):
    """Stats of every (slot group, row range) part, stacked: (S, B, P),
    (S, B, P), (S, B, D_pad, P)."""
    bounds = list(cuts) + [feats.shape[2]]
    parts = []
    for grp in groups:
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            parts.append(tap.affinity_from_bank_plain(
                feats[:, :, lo:hi], labels[:, :, lo:hi], tgt, slots[grp], valid=valid[grp], dense=dense[grp],
                row_base=lo, return_stats=True, **kw,
            ))
    return tuple(torch.stack(x) for x in zip(*parts))


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_combined_parts_match_unsplit_plain(rng, case, stats):
    """At float32 the combined parts are the unsplit result up to summation
    order."""
    feats, labels, tgt, slots, valid, dense, groups, cuts, kw = _inputs(rng, case)
    feats, labels, tgt = torch.as_tensor(feats), torch.as_tensor(labels), torch.as_tensor(tgt)
    m, l, acc = _partials(feats, labels, tgt, slots, valid, dense, groups, cuts, kw)
    got = tap.combine_partials(m, l, acc, return_stats=stats)
    expect = tap.affinity_from_bank_plain(feats, labels, tgt, slots, valid=valid, dense=dense, return_stats=stats,
                                          **kw)
    got, expect = (got, expect) if stats else ((got,), (expect,))
    for g, e in zip(got, expect):
        torch.testing.assert_close(g, e, rtol=1e-5, atol=1e-6)
    assert (got[-1][:, 5:] == 0).all()  # padded classes exactly zero


@pytest.mark.parametrize("case", sorted(CASES))
def test_combined_parts_match_pallas_interpret(rng, case):
    """bf16 banks: the combined parts against the JAX kernel, with the
    tolerances of ``tests/test_torch_affinity.py``."""
    feats, labels, tgt, slots, valid, dense, groups, cuts, kw = _inputs(rng, case)
    b, p = tgt.shape[:2]
    expect = np.asarray(jap.affinity_from_bank_batched(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(labels, jnp.bfloat16), jnp.asarray(tgt), jnp.asarray(slots),
        valid=valid, dense=dense, block_r=128, block_t=128, interpret=True, **kw,
    ))
    bf = lambda x: torch.as_tensor(x).to(torch.bfloat16)  # noqa: E731
    m, l, acc = _partials(bf(feats), bf(labels), torch.as_tensor(tgt), slots, valid, dense, groups, cuts, kw)
    got = tap.combine_partials_plain(m, l, acc).numpy()
    assert got.shape == expect.shape == (b, D_PAD, p)
    for v in range(b):
        _assert_argmax_close(got[v], expect[v])
    np.testing.assert_allclose(got, expect, rtol=0.05, atol=5e-3)


def test_one_part_is_the_identity(rng):
    """One part: the combine returns its statistics unchanged (the weight
    e^(m - m*) is exactly 1)."""
    feats, labels, tgt, slots, valid, dense, _, _, kw = _inputs(rng, "slot_groups")
    feats, labels, tgt = torch.as_tensor(feats), torch.as_tensor(labels), torch.as_tensor(tgt)
    m, l, acc = tap.affinity_from_bank_plain(feats, labels, tgt, slots, valid=valid, dense=dense, return_stats=True,
                                             **kw)
    got = tap.combine_partials(m[None], l[None], acc[None], return_stats=True)
    for g, e in zip(got, (m, l, acc)):
        assert torch.equal(g, e)
