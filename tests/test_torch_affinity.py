"""Port parity: the bank-affinity kernel's plain PyTorch version against the
JAX Pallas kernel (interpret mode) and the float32 golden, on the cases of
``tests/test_affinity_from_bank.py``. The CUDA kernel against the plain
version is in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.core.propagation import affinity_propagate as j_golden
from semi_supervised_vos_tpu.core.spatial import spatial_weight as j_spatial_weight
from semi_supervised_vos_tpu.ops import affinity_pallas as jap
from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
from semi_supervised_vos_tpu_torch.ops import affinity as tap
from tests.test_pallas_affinity import _assert_argmax_close


def _bank(rng, cap, b, p, p_pad, c, d_pad, n_cls=5):
    feats = np.zeros((cap, b, p_pad, c), np.float32)
    labels = np.zeros((cap, b, p_pad, d_pad), np.float32)
    feats[:, :, :p] = rng.standard_normal((cap, b, p, c)) * 0.3
    cls = rng.integers(0, n_cls, size=(cap, b, p))
    labels[np.arange(cap)[:, None, None], np.arange(b)[None, :, None], np.arange(p)[None, None], cls] = 1.0
    return feats, labels


def _bf16(x):
    """numpy f32 → the bf16-rounded values, as f32 (both frameworks round
    to nearest even)."""
    return torch.as_tensor(x).to(torch.bfloat16)


CASES = {
    # name: (hd, wd, cap, k, frame_idx, temperature, spatial, b)
    "single": (6, 8, 12, 5, 7, 1.3, True, 1),
    "batched": (6, 8, 12, 5, 9, 0.8, True, 2),
    "probability": (6, 8, 12, 5, 11, 1.1, False, 1),
    "wrapped_late": (8, 16, 12, 9, 50, 1.0, True, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(rng, case):
    hd, wd, cap, k, frame_idx, temp, spatial, b = CASES[case]
    p, c, d_pad = hd * wd, 32, 24
    feats, labels = _bank(rng, cap, b, p, 128, c, d_pad)
    idx, valid, dense = sample_frames(frame_idx, 40, k)
    slots = idx % cap
    tgt = (rng.standard_normal((b, p, c)) * 0.3).astype(np.float32)
    kw = dict(feature_hw=(hd, wd), temperature=temp, valid=valid, dense=dense, spatial=spatial)
    expect = np.asarray(
        jap.affinity_from_bank_batched(
            jnp.asarray(feats, jnp.bfloat16), jnp.asarray(labels, jnp.bfloat16), jnp.asarray(tgt),
            jnp.asarray(slots), block_r=128, block_t=128, interpret=True, **kw,
        )
    )
    got = tap.affinity_from_bank_batched(
        _bf16(feats), _bf16(labels), torch.as_tensor(tgt), slots, **kw
    ).numpy()
    assert got.shape == expect.shape == (b, d_pad, p)
    for v in range(b):
        _assert_argmax_close(got[v], expect[v])
    np.testing.assert_allclose(got, expect, rtol=0.05, atol=5e-3)
    assert (got[:, 5:] == 0).all()  # padded classes exactly zero


def test_stats_shards_combine_to_full(rng):
    hd, wd, c, d_pad, cap, k = 6, 8, 32, 24, 10, 5
    p = hd * wd
    n_shards, p_loc = 4, 16
    feats, labels = _bank(rng, cap, 1, p, n_shards * p_loc, c, d_pad)
    feats, labels = feats[:, 0], labels[:, 0]
    idx, valid, dense = sample_frames(9, 40, k)
    slots = idx % cap
    tgt = (rng.standard_normal((p, c)) * 0.3).astype(np.float32)
    kw = dict(feature_hw=(hd, wd), temperature=0.9, valid=valid, dense=dense)
    full = np.asarray(
        jap.affinity_from_bank(
            jnp.asarray(feats, jnp.bfloat16), jnp.asarray(labels, jnp.bfloat16), jnp.asarray(tgt),
            jnp.asarray(slots), block_r=16, block_t=64, interpret=True, **kw,
        )
    )
    ms, ls, accs = [], [], []
    for s in range(n_shards):
        rows = slice(s * p_loc, (s + 1) * p_loc)
        m, l, acc = tap.affinity_from_bank_stats(
            _bf16(feats[:, rows]), _bf16(labels[:, rows]), torch.as_tensor(tgt), slots,
            row_base=s * p_loc, **kw,
        )
        ms.append(m.numpy()); ls.append(l.numpy()); accs.append(acc.numpy())
    m_g = np.max(ms, axis=0)
    scale = [np.exp(m - m_g) for m in ms]
    combined = sum(a * sc[None] for a, sc in zip(accs, scale)) / np.maximum(
        sum(l * sc for l, sc in zip(ls, scale)), 1e-30
    )[None]
    _assert_argmax_close(combined, full)
    # shard-local maxima rescale e before its bf16 rounding (~4e-3 rel)
    np.testing.assert_allclose(combined, full, rtol=1.5e-2, atol=5e-3)


@pytest.mark.parametrize("frame_idx,spatial", [(7, True), (30, True), (12, False)])
def test_plain_f32_matches_golden(rng, frame_idx, spatial):
    """With float32 banks the plain version is the golden math."""
    hd, wd, c, d_pad, cap, k = 6, 8, 32, 24, 45, 9
    p = hd * wd
    feats, labels = _bank(rng, cap, 1, p, 64, c, d_pad)
    idx, valid, dense = sample_frames(frame_idx, 40, k)
    slots = idx % cap
    tgt = (rng.standard_normal((p, c)) * 0.3).astype(np.float32)
    got = tap.affinity_from_bank(
        torch.as_tensor(feats[:, 0]), torch.as_tensor(labels[:, 0]), torch.as_tensor(tgt), slots,
        feature_hw=(hd, wd), temperature=1.2, valid=valid, dense=dense, spatial=spatial,
    ).numpy()
    expect = np.asarray(
        j_golden(
            feats[slots, 0, :p], tgt, labels[slots, 0, :p], temperature=1.2, valid=valid, dense=dense,
            weight_dense=np.asarray(j_spatial_weight((hd, wd), 8.0)) if spatial else None,
            weight_sparse=np.asarray(j_spatial_weight((hd, wd), 21.0)) if spatial else None,
            precision="highest",
        )
    )
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_other_devices():
    bank = torch.zeros((4, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tap.affinity_from_bank_batched(bank, bank, bank[0], [0], feature_hw=(2, 4), temperature=1.0)
