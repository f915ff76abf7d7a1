"""SAM 2.1 Hiera-L's card path (``models/hiera.py::SamHiera.encode``: bf16
products and attention, float32 LayerNorm statistics, residual stream and
neck sum) at its published widths on a 480 x 854 frame (upsampled to 960 x
1708, padded to 960 x 1728: 103,680 stage-1 tokens), against the plain
float32 reference (``tests/plain_sam2_hiera.py``), and the lockstep lane
envelope of ``sam2_hiera_l`` at 480p, on an NVIDIA Hopper card; skips
without one.

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_hiera.py
"""

import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu_torch.models.hiera import SamHiera
import plain_sam2_hiera as plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90)")
    return torch.device("cuda")


def test_card_path_at_published_widths_matches_plain(card):
    """One frame of ImageNet-normalised noise: the relative error of the
    bf16 features, ‖card − plain‖ / ‖plain‖. bf16 keeps 8 bits (each
    rounding up to 2^-9 relative) and a value's path through 48 blocks rounds
    it a few hundred times: 3 % allowed. The float8 control of the
    benchmark's cell (the same reference with every activation in e4m3)
    reads above 10 % on every seed, so it fails; a float32 path would read
    ~1e-6, and the check also asks the error to be above 1e-4, so the bf16
    path ran."""
    sd = plain.seeded_state_dict(21, plain.HIERA_L)
    net = SamHiera("sam2_hiera_l")
    net.load_state_dict(sd)
    net = net.to(card).eval()
    sd = {k: v.to(card) for k, v in sd.items()}
    x = torch.randn((1, 480, 854, 3), generator=torch.Generator(device=card).manual_seed(0), device=card)
    got = net.encode(x, torch.bfloat16).float().permute(0, 3, 1, 2)
    with torch.no_grad():
        want = plain.forward(sd, x.permute(0, 3, 1, 2))
    assert got.shape == want.shape == (1, 256, 60, 107)
    rel = ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()
    print(f"relative error {rel:.4e}")
    assert 1e-4 < rel < 0.03, rel


def test_lane_cap_fills_under_85_percent(card):
    """``start_videos`` and one 8-step chunk of a lockstep engine at
    ``_hbm_lanes_cap`` lanes for ``sam2_hiera_l`` at 480p (one step of every
    lane per encode call, as at the cap): the card's peak stays under 85 %
    of its memory (the budget aims at 70 %)."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine, _hbm_lanes_cap
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig

    torch.manual_seed(0)
    net = SamHiera("sam2_hiera_l").to(card).eval()
    hw = (480, 854)
    lanes = _hbm_lanes_cap(hw, "sam2_hiera_l")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (9,) + hw + (3,), dtype=np.uint8)
    label = np.zeros(hw, np.int64)
    label[100:200, 100:300] = 1
    label[250:400, 500:700] = 2
    engine = BatchedPropagationEngine(net, hw, lanes, EngineConfig(temperature=10.0), card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = engine.start_videos(np.ascontiguousarray(np.broadcast_to(frames[0], (lanes,) + frames.shape[1:])),
                                np.ascontiguousarray(np.broadcast_to(label, (lanes,) + hw)))
    masks, state = engine.step_chunk_small(np.broadcast_to(frames[1:, None], (8, lanes) + frames.shape[1:]), state, 1)
    torch.cuda.synchronize()
    share = torch.cuda.max_memory_allocated() / torch.cuda.get_device_properties(0).total_memory
    print(f"{lanes} lanes: peak {share:.4f} of the card")
    assert masks.shape == (8, lanes, 60, 107)
    assert share < 0.85, share
