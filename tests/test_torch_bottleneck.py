"""Port parity: the fused bottleneck kernel's plain PyTorch version against
the JAX Pallas kernel (interpret mode) on the shapes of
``tests/test_bottleneck_pallas.py``. The CUDA kernel against the plain
version is in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.ops.bottleneck_pallas import bottleneck_block as j_block
from semi_supervised_vos_tpu_torch.ops import bottleneck as tb


def _weights(rng, c, c4, scale=0.2):
    return (
        (rng.standard_normal((c, c4)) * scale).astype(np.float32),
        (rng.standard_normal(c4) * 0.1).astype(np.float32),
        (rng.standard_normal((3, 3, c4, c4)) * scale).astype(np.float32),
        (rng.standard_normal(c4) * 0.1).astype(np.float32),
        (rng.standard_normal((c4, c)) * scale).astype(np.float32),
        (rng.standard_normal(c) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("bsz,h,w,c,c4", [(1, 12, 14, 64, 16), (2, 10, 9, 64, 16), (1, 8, 11, 32, 8)])
def test_plain_matches_pallas_interpret(rng, bsz, h, w, c, c4):
    x = (rng.standard_normal((bsz, h, w, c)) * 0.5).astype(np.float32)
    wts = _weights(rng, c, c4)
    expect = np.asarray(j_block(jnp.asarray(x), *wts, interpret=True))
    got = tb.bottleneck_block(torch.as_tensor(x), *map(torch.as_tensor, wts)).numpy()
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-4)


def test_plain_bf16_rounding_points(rng):
    """In bf16 the plain version rounds y1, y2 and the output as the JAX
    kernel does."""
    c, c4 = 64, 16
    x = (rng.standard_normal((1, 6, 7, c)) * 0.5).astype(np.float32)
    wts = _weights(rng, c, c4)
    expect = np.asarray(j_block(jnp.asarray(x, jnp.bfloat16), *wts, interpret=True), np.float32)
    got = tb.bottleneck_block(torch.as_tensor(x).to(torch.bfloat16), *map(torch.as_tensor, wts))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), expect, rtol=2e-2, atol=2e-2)
