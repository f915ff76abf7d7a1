"""Port parity for the lockstep engine itself: ``BatchedPropagationEngine``
at B = 3 against three single engines and against the JAX
``BatchedPropagationEngine`` on the same weights (float32 on the CPU,
across a ring-bank wrap), ``grouped_map`` against the JAX one, and the
card's lane envelope (``_hbm_lanes_cap`` / ``_clamp_video_batch``) pinned to
the port's own anchors."""

import jax
import numpy as np
import pytest
import torch

import semi_supervised_vos_tpu.infer.batched as jbatched
from semi_supervised_vos_tpu.infer.engine import EngineConfig as JConfig
from semi_supervised_vos_tpu.infer.engine import grouped_map as jgrouped_map
from semi_supervised_vos_tpu_torch.infer import batched
from semi_supervised_vos_tpu_torch.infer.engine import BankState, EngineConfig, PropagationEngine, grouped_map
from semi_supervised_vos_tpu_torch.models.resnet import out_spatial
from tests.test_torch_models import jax_variables, port_net

H = W = 32
T_TOTAL, CHUNK, B = 15, 6, 3


def _inputs(rng):
    frames = rng.integers(0, 255, size=(T_TOTAL, B, H, W, 3), dtype=np.uint8)
    labels = np.zeros((B, H, W), np.int32)
    labels[0, :, : W // 2] = 1
    labels[1, 20:, 20:] = 2
    labels[2, :10] = 1
    labels[2, 24:, :8] = 2
    return frames, labels


@pytest.mark.parametrize("probability", [False, True])
def test_lockstep_engine_matches_single_engines_and_jax(rng, probability):
    """Masks (label mode) and scores (probability mode) of the lockstep
    engine against three single engines and the JAX lockstep engine, chunk
    by chunk across a ring wrap. The masks and bank labels equal the single
    engines' exactly. Scores are held to float32 rounding: on the CPU, torch
    sums a dilated convolution of one image in another order than of
    several, so frame 0's features (one image in each single engine, B in
    the lockstep one) differ in their last bits. Given the same features and
    banks, one lockstep step equals the three single steps exactly."""
    temperature = 0.02 if probability else 1.3
    jnet, variables = jax_variables("resnet18", 5)
    jcfg = JConfig(ref_num=5, frame_range=6, temperature=temperature, probability_propagation=probability,
                   compute_dtype=np.float32, matmul_precision="highest")
    cfg = EngineConfig(ref_num=5, frame_range=6, temperature=temperature, probability_propagation=probability)
    assert cfg.capacity < T_TOTAL  # the ring wraps
    net = port_net("resnet18", variables)
    engine = batched.BatchedPropagationEngine(net, (H, W), B, cfg, "cpu")
    singles = [PropagationEngine(net, (H, W), cfg, "cpu") for _ in range(B)]
    jengine = jbatched.BatchedPropagationEngine(jnet, variables, (H, W), B, jcfg)
    frames, labels = _inputs(rng)

    state = engine.start_videos(frames[0], labels)
    states = [e.start_video(frames[0, b], labels[b]) for b, e in enumerate(singles)]
    jstate = jengine.start_videos(frames[0], labels)
    assert state.feats.shape == (cfg.capacity, B, engine.p, 256) and state.labels.dtype == torch.float32
    np.testing.assert_array_equal(state.labels.numpy(), np.asarray(jstate.labels))
    seen = set()
    for start in range(1, T_TOTAL, CHUNK):
        batch = frames[start : start + CHUNK]
        if probability:
            got, state = engine.step_chunk_scores(batch, state, start)
            jgot, jstate = jengine.step_chunk_scores(batch, jstate, start)
            assert got.shape == (len(batch), B, cfg.num_classes, engine.p)
            for b, e in enumerate(singles):
                single, states[b] = e.step_chunk_scores(batch[:, b], states[b], start)
                torch.testing.assert_close(got[:, b], single, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-4, atol=1e-5)
        else:
            got, state = engine.step_chunk_small(batch, state, start)
            jgot, jstate = jengine.step_chunk_small(batch, jstate, start)
            assert got.shape == (len(batch), B, engine.hd, engine.wd) and got.dtype == torch.uint8
            for b, e in enumerate(singles):
                single, states[b] = e.step_chunk_small(batch[:, b], states[b], start)
                assert torch.equal(got[:, b], single), (start, b)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jgot), err_msg=f"chunk at {start}")
            seen.update(np.unique(got.numpy()).tolist())
    if probability:
        lab = state.labels.numpy()
        assert ((lab > 1e-3) & (lab < 1 - 1e-3)).any()  # soft labels, not one-hots
    else:
        assert len(seen) > 1  # the comparison is not between constant masks
        for b, st in enumerate(states):
            assert torch.equal(state.labels[:, b], st.labels)

    # one step from identical features and banks: exact
    feats = torch.stack([e.encode(frames[T_TOTAL - 1, b : b + 1])[0] for b, e in enumerate(singles)])
    banks = BankState(torch.stack([s.feats for s in states], dim=1), torch.stack([s.labels for s in states], dim=1))
    lockstep = engine._step(feats, banks, T_TOTAL)
    for b, e in enumerate(singles):
        assert torch.equal(lockstep[b], e._step(feats[b], states[b], T_TOTAL))
        assert torch.equal(banks.labels[:, b], states[b].labels)


def test_step_and_step_chunk_fuse_lanes(rng):
    """``step`` / ``step_chunk`` with hor-flip lanes: one fused full-resolution
    mask per video, equal to the lanes' masks unflipped and maxed, and
    ``step`` equals a one-frame ``step_chunk``."""
    _, variables = jax_variables("resnet18", 5)
    cfg = EngineConfig(ref_num=5, frame_range=6)
    fusion = batched.LaneFusion((None, "h"))
    net = port_net("resnet18", variables)
    engine = batched.BatchedPropagationEngine(net, (H, W), 4, cfg, "cpu", fusion)
    plain = batched.BatchedPropagationEngine(net, (H, W), 4, cfg, "cpu")
    frames, labels = _inputs(rng)
    lanes = np.stack([frames[:, 0], frames[:, 0, :, ::-1], frames[:, 1], frames[:, 1, :, ::-1]], axis=1)
    lane_labels = np.stack([labels[0], labels[0, :, ::-1], labels[1], labels[1, :, ::-1]])
    st, pst = engine.start_videos(lanes[0], lane_labels), plain.start_videos(lanes[0], lane_labels)
    fused, st = engine.step_chunk(lanes[1:4], st, 1)
    per_lane, pst = plain.step_chunk(lanes[1:4], pst, 1)
    assert fused.shape == (3, 2, H, W) and per_lane.shape == (3, 4, H, W)
    expect = torch.maximum(per_lane[:, 0::2], torch.flip(per_lane[:, 1::2], dims=(3,)))
    assert torch.equal(fused, expect)
    again, _ = engine.step_chunk(lanes[4:5], BankState(st.feats.clone(), st.labels.clone()), 4)
    one, _ = engine.step(lanes[4], st, 4)
    assert torch.equal(one, again[0])
    with pytest.raises(ValueError, match="multiple"):
        batched.BatchedPropagationEngine(net, (H, W), 3, cfg, "cpu", fusion)


def test_grouped_map_matches_jax():
    """Full groups of ``cap`` rows and one remainder call, for cap dividing
    n, cap coprime with n and cap >= n: the rows of the JAX function's."""
    x = np.arange(9 * 4, dtype=np.float32).reshape(9, 4)
    for cap in (1, 2, 3, 4, 9, 100):
        calls = []

        def fn(xb):
            calls.append(len(xb))
            return torch.sin(torch.as_tensor(xb)) * 2.0

        expect = np.asarray(jgrouped_map(lambda xb: jax.numpy.sin(xb) * 2.0, x, cap))
        np.testing.assert_allclose(grouped_map(fn, x, cap).numpy(), expect, rtol=1e-6)
        g = min(cap, 9)
        assert calls == [g] * (9 // g) + ([9 % g] if 9 % g else [])


def _p(hw):
    hd, wd = out_spatial(*hw)
    return hd * wd


def test_lane_cap_anchors_and_clamp():
    """The envelope at and outside the port's two anchors, monotone between
    them, and the runners' clamps for one and two lanes a video."""
    small, large = batched._HBM_LANE_PX_SMALL, batched._HBM_LANE_PX_LARGE
    assert _p((480, 854)) == batched._HBM_ANCHOR_P_SMALL and _p((1080, 1920)) == batched._HBM_ANCHOR_P_LARGE
    cap480, cap1080 = small // _p((480, 854)), large // _p((1080, 1920))
    assert batched._hbm_lanes_cap((480, 854)) == cap480 >= 8  # the main path's B = 8 runs unclamped
    assert batched._hbm_lanes_cap((240, 427)) == small // _p((240, 427))  # below: the 480p budget
    assert batched._hbm_lanes_cap((1080, 1920)) == cap1080 >= 2
    assert batched._hbm_lanes_cap((2160, 3840)) == max(1, large // _p((2160, 3840)))  # above: the 1080p budget
    caps = [batched._hbm_lanes_cap((h, int(h * 16 / 9))) for h in range(480, 1081, 40)]
    assert caps == sorted(caps, reverse=True) and cap480 > batched._hbm_lanes_cap((720, 1280)) > cap1080
    for lanes in (1, 2):
        assert batched._clamp_video_batch(10**6, lanes, (480, 854)) == cap480 // lanes
        assert batched._clamp_video_batch(10**6, lanes, (1080, 1920)) == max(1, cap1080 // lanes)
    assert batched._clamp_video_batch(3, 2, (480, 854)) == 3  # under the envelope: as asked
    # two engines (2-scale): the larger frame governs
    assert batched._clamp_video_batch(10**6, 2, (480, 854), (1080, 1920)) == max(1, cap1080 // 2)
    assert batched._clamp_video_batch(10**6, 1, (1080, 1920), n_chips=4) == 4 * cap1080


@pytest.mark.parametrize("hw", [(240, 427), (480, 854), (552, 983), (720, 1280), (1080, 1920), (2160, 3840)])
@pytest.mark.parametrize("lanes", [1, 2])
def test_lane_cap_is_the_jax_rule_on_the_port_anchors(monkeypatch, hw, lanes):
    """The same rule as the JAX function once that function is given the
    port's anchors (its own are another device's)."""
    for name in ("_HBM_ANCHOR_P_SMALL", "_HBM_ANCHOR_P_LARGE", "_HBM_LANE_PX_SMALL", "_HBM_LANE_PX_LARGE"):
        monkeypatch.setattr(jbatched, name, getattr(batched, name))
    assert batched._hbm_lanes_cap(hw) == jbatched._hbm_lanes_cap(hw)
    assert batched._clamp_video_batch(10**6, lanes, hw) == jbatched._clamp_video_batch(10**6, lanes, hw)
