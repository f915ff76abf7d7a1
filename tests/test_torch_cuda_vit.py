"""DINO ViT-B/8's card path (``models/vit.py::DinoViT.encode``: bf16
products and attention, float32 LayerNorm statistics and residual stream)
at its published widths on 480 x 856 frames (60 x 107 patches, 6,421
tokens), against the plain float32 reference (``tests/plain_dino_vit.py``),
on an NVIDIA Hopper card; skips without one.

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_vit.py
"""

import pytest
import torch

from semi_supervised_vos_tpu_torch.models.vit import DinoViT
import plain_dino_vit as plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90)")
    return torch.device("cuda")


def test_card_path_at_published_widths_matches_plain(card):
    """Two frames of ImageNet-normalised noise: the worst frame's relative
    error of the bf16 features, ‖card − plain‖ / ‖plain‖. bf16 keeps 8 bits
    (each rounding up to 2^-9 relative) and 12 blocks round ~100 times a
    value's path: 3 % allowed; a float32 path would read ~1e-6 and the
    check also asks the error to be above 1e-4, so the bf16 path ran."""
    sd = plain.seeded_state_dict(21, 768, 12, 3072)
    net = DinoViT("dino_vitb8")
    net.load_state_dict(sd)
    net = net.to(card).eval()
    sd = {k: v.to(card) for k, v in sd.items()}
    x = torch.randn((2, 480, 856, 3), generator=torch.Generator(device=card).manual_seed(0), device=card)
    got = net.encode(x, torch.bfloat16).float().permute(0, 3, 1, 2)
    want = plain.forward(sd, x.permute(0, 3, 1, 2), 12)
    assert got.shape == want.shape == (2, 768, 60, 107)
    rel = ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()
    print(f"relative error {rel:.4e}")
    assert 1e-4 < rel < 0.03, rel
