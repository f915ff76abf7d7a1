"""Port parity: the engine's masks equal the JAX engine's on the CPU across a
ring-bank wraparound (float32, dense golden affinity on both sides)."""

import jax
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.infer.engine import EngineConfig as JConfig
from semi_supervised_vos_tpu.infer.engine import PropagationEngine as JEngine
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from tests.test_torch_models import jax_variables, port_net


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_engine_masks_match_jax_over_ring_wrap(rng, arch):
    h = w = 32
    t_total, chunk = 15, 6
    jnet, variables = jax_variables(arch, 0)
    jcfg = JConfig(ref_num=5, frame_range=6, temperature=1.3, compute_dtype=np.float32,
                   matmul_precision="highest")
    cfg = EngineConfig(ref_num=5, frame_range=6, temperature=1.3)
    assert cfg.capacity == jcfg.capacity < t_total  # the ring genuinely wraps
    jengine = JEngine(jnet, variables, (h, w), jcfg)
    engine = PropagationEngine(port_net(arch, variables), (h, w), cfg, "cpu")

    frames = rng.integers(0, 255, size=(t_total, h, w, 3), dtype=np.uint8)
    label0 = np.zeros((h, w), np.int32)
    label0[:, : w // 2] = 1
    label0[20:, 20:] = 2

    jstate = jengine.start_video(frames[0], label0)
    state = engine.start_video(frames[0], label0)
    np.testing.assert_array_equal(state.labels.numpy(), np.asarray(jstate.labels))
    seen = set()
    for start in range(1, t_total, chunk):
        batch = frames[start : start + chunk]
        jmasks, jstate = jengine.step_chunk_small(batch, jstate, start)
        masks, state = engine.step_chunk_small(batch, state, start)
        np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks), err_msg=f"chunk at {start}")
        seen.update(np.unique(masks.numpy()).tolist())
    assert len(seen) > 1  # the comparison is not between constant masks
    np.testing.assert_array_equal(state.labels.numpy(), np.asarray(jax.device_get(jstate.labels)))


def test_engine_scores_match_jax_in_probability_mode(rng):
    """``step_chunk_scores`` with soft scores written back into the bank and
    no spatial prior, across a ring wrap: the raw (N, D, P) scores and the
    soft bank labels equal the JAX engine's to float32 rounding. This random
    network's similarities reach ~8e3, ~170 after the temperature, so sums
    in another order move a logit by ~1e-5 and a score by as much,
    relatively."""
    h = w = 32
    t_total, chunk = 15, 6
    jnet, variables = jax_variables("resnet18", 2)
    jcfg = JConfig(ref_num=5, frame_range=6, temperature=0.02, probability_propagation=True,
                   compute_dtype=np.float32, matmul_precision="highest")
    cfg = EngineConfig(ref_num=5, frame_range=6, temperature=0.02, probability_propagation=True)
    jengine = JEngine(jnet, variables, (h, w), jcfg)
    engine = PropagationEngine(port_net("resnet18", variables), (h, w), cfg, "cpu")
    assert engine._wd is None and engine._ws is None  # no (P, P) prior matrices

    frames = rng.integers(0, 255, size=(t_total, h, w, 3), dtype=np.uint8)
    label0 = np.zeros((h, w), np.int32)
    label0[:, : w // 2] = 1
    label0[20:, 20:] = 2
    jstate = jengine.start_video(frames[0], label0)
    state = engine.start_video(frames[0], label0)
    for start in range(1, t_total, chunk):
        batch = frames[start : start + chunk]
        jscores, jstate = jengine.step_chunk_scores(batch, jstate, start)
        scores, state = engine.step_chunk_scores(batch, state, start)
        assert scores.shape == (len(batch), cfg.num_classes, engine.p) and scores.dtype == torch.float32
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-4, atol=1e-5)
    labels = state.labels.numpy()
    assert ((labels > 1e-3) & (labels < 1 - 1e-3)).any()  # soft labels, not one-hots
    np.testing.assert_allclose(labels, np.asarray(jax.device_get(jstate.labels)), rtol=1e-4, atol=1e-5)
