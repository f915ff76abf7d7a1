"""Port parity for the JAX package's last public names: the unused
descriptor and temporal weights, ``affinity_logits``, ``TripletLossTrainDataset``
and ``ANTIALIAS``, the resnet34 / resnet152 backbones with converted
weights, ``bottleneck_stack`` against the Pallas stack in interpret mode,
and the subpackage exports."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.core import propagation as jprop
from semi_supervised_vos_tpu.core import spatial as jspatial
from semi_supervised_vos_tpu.data import davis as jdavis
from semi_supervised_vos_tpu.models import resnet as jresnet
from semi_supervised_vos_tpu.ops.bottleneck_pallas import bottleneck_stack as j_stack
from semi_supervised_vos_tpu_torch.core import propagation as tprop
from semi_supervised_vos_tpu_torch.core import spatial as tspatial
from semi_supervised_vos_tpu_torch.data import davis as tdavis
from semi_supervised_vos_tpu_torch.models import convert, resnet as tresnet
from semi_supervised_vos_tpu_torch.ops import bottleneck as tb
from tests.helpers import make_davis_dataset

ROOT = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("core", "data", "eval", "infer", "models", "ops", "parallel", "train")


def max_ulp(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in float32 units in the last place."""
    return int(np.max(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))))


# ---- core: descriptor and temporal weights, affinity logits --------------


@pytest.mark.parametrize("p", [0.5, 2.0, 1.0 / 3.0])
def test_descriptor_weight_matches_jax(rng, p):
    """Equal to the JAX function but for the last bit of ``pow``, which XLA
    and PyTorch compute with different approximations (at most 1 ulp apart
    on these inputs; negative bases give NaN in both)."""
    a = (rng.standard_normal((64, 32)) * 3.0).astype(np.float32)
    expect = np.asarray(jspatial.descriptor_weight(jnp.asarray(a), p))
    got = tspatial.descriptor_weight(torch.as_tensor(a), p).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(expect))
    ok = ~np.isnan(expect)
    assert ok.any() and max_ulp(got[ok], expect[ok]) <= 1


@pytest.mark.parametrize("t_temp", [None, 0.1])
def test_temporal_weight_matches_jax(rng, t_temp):
    """The squared differences sum to the same bits; ``exp`` may differ in
    the last one (XLA's and PyTorch's approximations)."""
    f1 = rng.standard_normal((50, 8)).astype(np.float32)
    f2 = rng.standard_normal((8, 50)).astype(np.float32)
    expect = np.asarray(jspatial.temporal_weight(jnp.asarray(f1), jnp.asarray(f2), 3.0, t_temp))
    got = tspatial.temporal_weight(torch.as_tensor(f1), torch.as_tensor(f2), 3.0, t_temp).numpy()
    assert got.shape == expect.shape == (50,)
    assert max_ulp(got, expect) <= 1


@pytest.mark.parametrize("temperature,with_valid", [(1.0, False), (0.5, True)])
def test_affinity_logits_matches_jax(rng, temperature, with_valid):
    k, p, c = 4, 30, 16
    ref = rng.standard_normal((k, p, c)).astype(np.float32)
    tgt = rng.standard_normal((p, c)).astype(np.float32)
    valid = np.array([True, False, True, True]) if with_valid else None
    expect = np.asarray(jprop.affinity_logits(jnp.asarray(ref), jnp.asarray(tgt), temperature,
                                              None if valid is None else jnp.asarray(valid)))
    got = tprop.affinity_logits(torch.as_tensor(ref), torch.as_tensor(tgt), temperature,
                                None if valid is None else torch.as_tensor(valid)).numpy()
    assert got.dtype == np.float32 and got.shape == (k, p, p)
    np.testing.assert_allclose(got, expect, rtol=0, atol=1e-5)
    if with_valid:
        assert (got[1] == tprop.NEG_INF).all()


def test_affinity_propagate_goes_through_affinity_logits(rng, monkeypatch):
    """``affinity_propagate`` takes its logits from ``affinity_logits``."""
    calls = []
    real = tprop.affinity_logits
    monkeypatch.setattr(tprop, "affinity_logits", lambda *a: calls.append(a) or real(*a))
    ref = torch.as_tensor(rng.standard_normal((2, 6, 4)).astype(np.float32))
    lab = torch.as_tensor(rng.random((2, 6, 3)).astype(np.float32))
    tprop.affinity_propagate(ref, ref[0], lab, temperature=1.0)
    assert len(calls) == 1


# ---- data: TripletLossTrainDataset, ANTIALIAS ------------------------------


def test_antialias_is_the_jax_filter():
    assert tdavis.ANTIALIAS == jdavis.ANTIALIAS


def test_triplet_dataset_items_match_jax(tmp_path):
    make_davis_dataset(tmp_path, videos=("a", "b", "c"), frames=4, size=(32, 40), objects=2)
    args = (tmp_path / "JPEGImages/480p", tmp_path / "Annotations/480p")
    ours, theirs = tdavis.TripletLossTrainDataset(*args), jdavis.TripletLossTrainDataset(*args)
    assert len(ours) == len(theirs) == 3
    for i in range(len(ours)):
        got, expect = ours[i], theirs[i]
        assert len(got) == len(expect) == 4
        for (gi, ga), (ei, ea) in zip(got, expect):
            assert gi.dtype == ga.dtype == np.uint8 and gi.shape == ga.shape == (32, 40, 3)
            assert np.array_equal(gi, ei) and np.array_equal(ga, ea)


# ---- models: the resnet factories -----------------------------------------


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152"])
def test_resnet_factories_build_the_jax_layouts(name):
    jnet = getattr(jresnet, name)()
    net = getattr(tresnet, name)()
    assert isinstance(net, tresnet.ResNet)
    block = tresnet.BasicBlock if jnet.block == "basic" else tresnet.Bottleneck
    for stage, (blocks, planes) in enumerate(zip(jnet.layers, jnet.stage_planes), start=1):
        layer = getattr(net, f"layer{stage}")
        assert len(layer) == blocks and all(isinstance(b, block) for b in layer)
        assert layer[0].conv1.out_channels == planes
    assert net.out_channels == jnet.stage_planes[-1] * (1 if jnet.block == "basic" else 4)


def _jax_backbone(name, seed):
    """A JAX backbone's random variables, BN statistics perturbed (as
    ``tests/test_torch_models.py`` does for VOSNet) and each residual
    branch's last BN scale cut to a tenth (as ``chip_smoke.py``'s calibrated
    network has it): without the cut resnet152's 50 blocks grow the
    activations to hundreds, where float32 summation order alone moves an
    output by more than the 2e-4 bar."""
    jnet = getattr(jresnet, name)()
    variables = jnet.init(jax.random.PRNGKey(seed), np.zeros((1, 32, 32, 3), np.float32))
    nprng = np.random.default_rng(seed + 4)

    def perturb(path, x):
        z = nprng.standard_normal(x.shape).astype(np.float32)
        return jnp.asarray(z * 0.1) if path[-1].key == "mean" else jnp.asarray(np.abs(z) * 0.5 + 0.5)

    def cut(path, x):
        last = "bn2" if jnet.block == "basic" else "bn3"
        return x * 0.1 if path[-2].key == last and path[-1].key == "scale" else x

    stats = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    params = jax.tree_util.tree_map_with_path(cut, variables["params"])
    return jnet, {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module", params=["resnet34", "resnet152"])
def backbone_pair(request):
    jnet, variables = _jax_backbone(request.param, 5)
    net = getattr(tresnet, request.param)().eval()
    net.load_state_dict(convert.state_dict_from_jax(variables, net))
    return jnet, variables, net


def test_backbone_matches_flax(backbone_pair):
    jnet, variables, net = backbone_pair
    x = (np.random.default_rng(11).standard_normal((1, 32, 32, 3)) * 0.7).astype(np.float32)
    expect = np.asarray(jnet.apply(variables, x, train=False))
    with torch.no_grad():
        got = net(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == expect.shape == (1, 4, 4, net.out_channels)
    assert 1.0 < np.abs(expect).max() < 100.0
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-4)


# ---- ops: bottleneck_stack -------------------------------------------------


def _block(rng, c, c4, scale=0.2):
    return (
        (rng.standard_normal((c, c4)) * scale).astype(np.float32),
        (rng.standard_normal(c4) * 0.1).astype(np.float32),
        (rng.standard_normal((3, 3, c4, c4)) * scale).astype(np.float32),
        (rng.standard_normal(c4) * 0.1).astype(np.float32),
        (rng.standard_normal((c4, c)) * scale).astype(np.float32),
        (rng.standard_normal(c) * 0.1).astype(np.float32),
    )


def test_bottleneck_stack_matches_pallas_interpret(rng):
    c, c4 = 64, 16
    x = (rng.standard_normal((2, 10, 9, c)) * 0.5).astype(np.float32)
    blocks = [_block(rng, c, c4) for _ in range(3)]
    expect = np.asarray(j_stack(jnp.asarray(x), blocks, interpret=True))
    launches = (tb.bottleneck_block.launches, tb.bottleneck_block.launches_f32)
    got = tb.bottleneck_stack(torch.as_tensor(x), [tuple(map(torch.as_tensor, b)) for b in blocks]).numpy()
    np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-4)
    # the CPU runs the plain version: no kernel launch is counted
    assert (tb.bottleneck_block.launches, tb.bottleneck_block.launches_f32) == launches


def test_bottleneck_stack_is_blocks_in_sequence(rng):
    c, c4 = 32, 8
    x = torch.as_tensor((rng.standard_normal((1, 6, 7, c)) * 0.5).astype(np.float32))
    blocks = [tuple(map(torch.as_tensor, _block(rng, c, c4))) for _ in range(2)]
    expect = tb.bottleneck_block(tb.bottleneck_block(x, *blocks[0]), *blocks[1])
    assert torch.equal(tb.bottleneck_stack(x, blocks, planes=[None, None]), expect)
    with pytest.raises(ValueError, match="1 planes for 2 blocks"):
        tb.bottleneck_stack(x, blocks, planes=[None])


# ---- the subpackage exports ------------------------------------------------


def _exported(path: Path) -> list:
    """Names an ``__init__.py`` imports from its submodules."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_exports_cover_the_jax_names(sub):
    """Every name a JAX ``__init__`` exports has a counterpart of the same
    name in the port's (``ResNetBackbone``: ``ResNet``), or the port's
    docstring names it; and every name the port's ``__init__`` imports is
    there."""
    import importlib

    mod = importlib.import_module(f"semi_supervised_vos_tpu_torch.{sub}")
    ours = _exported(ROOT / "semi_supervised_vos_tpu_torch" / sub / "__init__.py")
    assert ours and all(hasattr(mod, name) for name in ours)
    renamed = {"ResNetBackbone": "ResNet"}
    for name in _exported(ROOT / "semi_supervised_vos_tpu" / sub / "__init__.py"):
        assert hasattr(mod, renamed.get(name, name)) or name in (mod.__doc__ or ""), f"{sub}: {name}"


def test_exports_import_light():
    """Importing the package and every subpackage's exports needs no CUDA,
    builds no kernel and imports nothing of JAX."""
    code = (
        "import sys, importlib\n"
        "import semi_supervised_vos_tpu_torch\n"
        f"for sub in {SUBPACKAGES!r}:\n"
        "    importlib.import_module('semi_supervised_vos_tpu_torch.' + sub)\n"
        "from semi_supervised_vos_tpu_torch.models import VOSNet, resnet34, resnet152\n"
        "from semi_supervised_vos_tpu_torch.ops import _build\n"
        "assert not _build._LIBS\n"
        "assert not [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'semi_supervised_vos_tpu.'))]\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
