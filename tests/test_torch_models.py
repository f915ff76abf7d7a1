"""Port parity: torch VOSNet modules, with weights carried across by
``state_dict_from_jax``, and the BN-folded ``fast_encode`` against the JAX
package's forwards on the CPU (float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.models.infer_fast import build_fast_encoder
from semi_supervised_vos_tpu.models.vos_net import VOSNet as JVOSNet
from semi_supervised_vos_tpu_torch.models.convert import (
    load_torch_checkpoint,
    save_torch_checkpoint,
    state_dict_from_jax,
)
from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
from semi_supervised_vos_tpu_torch.models.infer_fast import fast_encode
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet


def jax_variables(arch, seed):
    """Random flax variables with perturbed BN stats (non-trivial folding)."""
    net = JVOSNet(model=arch)
    variables = net.init(jax.random.PRNGKey(seed), np.zeros((1, 32, 32, 3), np.float32))
    nprng = np.random.default_rng(seed + 4)

    def perturb(path, x):
        z = nprng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "mean":
            return jnp.asarray(z * 0.1)
        return jnp.asarray(np.abs(z) * 0.5 + 0.5)

    stats = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    return net, {"params": variables["params"], "batch_stats": stats}


def port_net(arch, variables):
    net = VOSNet(arch).eval()
    net.load_state_dict(state_dict_from_jax(variables, net))
    return net


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def arch_pair(request):
    jnet, variables = jax_variables(request.param, 3)
    return request.param, jnet, variables, port_net(request.param, variables)


def test_module_matches_flax(arch_pair, rng):
    arch, jnet, variables, net = arch_pair
    x = (rng.standard_normal((2, 40, 48, 3)) * 0.7).astype(np.float32)
    expect = np.asarray(jnet.apply(variables, x, train=False))
    with torch.no_grad():
        got = net(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-4)


def test_fast_encode_matches_jax_fast_encoder(arch_pair, rng):
    arch, _, variables, net = arch_pair
    x = (rng.standard_normal((2, 48, 40, 3)) * 0.7).astype(np.float32)
    encode = build_fast_encoder(variables, dtype=jnp.float32, use_fused_stack=True, interpret=True, arch=arch)
    expect = np.asarray(encode(jnp.asarray(x)))
    with torch.no_grad():
        got = fast_encode(fold_vosnet(net, torch.float32), torch.as_tensor(x), torch.float32, arch=arch).numpy()
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-4)


def test_checkpoint_round_trip(tmp_path):
    """A reference-format ``.pth.tar`` (with DataParallel ``module.``
    prefixes) loads back into the module unchanged."""
    net = VOSNet("resnet18")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in net.parameters():
            t.normal_(generator=g)
    save_torch_checkpoint(net, tmp_path / "a.pth.tar")
    sd = torch.load(tmp_path / "a.pth.tar")["state_dict"]
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, tmp_path / "b.pth.tar")
    back = load_torch_checkpoint(tmp_path / "b.pth.tar", VOSNet("resnet18"))
    for (k, a), (_, b) in zip(net.state_dict().items(), back.state_dict().items()):
        assert torch.equal(a, b), k
