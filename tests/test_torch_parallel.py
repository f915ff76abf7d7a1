"""Port parity for the multi-device layer on the CPU: the collectives, the
distributed softmax combine, the sharded affinity and the bank-sharded
engine against the JAX package's, which runs on the 8 virtual host devices
that ``tests/conftest.py`` forces (plain path), while the port's mesh is the
CPU named n times. Also: every kernel launch of ``ops/`` runs with its
tensor's device current."""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from semi_supervised_vos_tpu.core.spatial import spatial_weight as jspatial_weight
from semi_supervised_vos_tpu.infer.engine import EngineConfig as JConfig
from semi_supervised_vos_tpu.parallel import collectives as jcol
from semi_supervised_vos_tpu.parallel.engine_sharded import ShardedPropagationEngine as JSharded
from semi_supervised_vos_tpu.parallel.mesh import make_mesh as jmake_mesh
from semi_supervised_vos_tpu.parallel.sharded_affinity import distributed_softmax_combine as jcombine
from semi_supervised_vos_tpu.parallel.sharded_affinity import sharded_affinity_propagate as jsharded_propagate
from semi_supervised_vos_tpu_torch.core.propagation import affinity_propagate
from semi_supervised_vos_tpu_torch.core.spatial import spatial_weight
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.parallel import collectives, make_mesh, sharded_affinity_propagate
from semi_supervised_vos_tpu_torch.parallel.engine_sharded import ShardedPropagationEngine
from semi_supervised_vos_tpu_torch.parallel.mesh import replicate, shard_batch
from semi_supervised_vos_tpu_torch.parallel.sharded_affinity import distributed_softmax_combine
from tests.test_torch_models import jax_variables, port_net

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _cpu_mesh(n_data, n_model):
    return make_mesh(n_data, n_model, devices=[CPU] * (n_data * n_model))


def test_mesh_shape_and_placement():
    mesh = _cpu_mesh(2, 3)
    assert mesh.shape == {"data": 2, "model": 3} and mesh.axis_names == ("data", "model")
    assert mesh.distinct_devices == [CPU]
    assert make_mesh(n_model=2, devices=[CPU] * 5).shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="needs more"):
        make_mesh(3, 3, devices=[CPU] * 8)
    table = {"a": torch.ones(2), "b": [torch.zeros(1), (torch.ones(3),)]}
    copies = replicate(mesh, table)
    assert list(copies) == [CPU] and copies[CPU]["a"] is table["a"]
    x = np.arange(12).reshape(6, 2)
    (blocks,) = shard_batch(mesh, x)
    assert [b.tolist() for b in blocks] == [x[:3].tolist(), x[3:].tolist()]


# (name, port function, JAX function in a shard_map body, rows per shard)
COLLECTIVES = [
    ("psum", collectives.psum, lambda s: jcol.psum(s, "model"), 2),
    ("pmean", collectives.pmean, lambda s: jcol.pmean(s, "model"), 2),
    ("pmax", collectives.pmax, lambda s: jcol.pmax(s, "model"), 2),
    ("all_gather", collectives.all_gather, lambda s: jcol.all_gather(s, "model"), 2),
    ("ppermute_shift", collectives.ppermute_shift, lambda s: jcol.ppermute_shift(s, "model", 1), 2),
    ("reduce_scatter", collectives.reduce_scatter, lambda s: jcol.reduce_scatter(s, "model"), 8),
    ("ring_all_gather", collectives.ring_all_gather, lambda s: jcol.ring_all_gather(s, "model"), 2),
]


@pytest.mark.parametrize("name,port_fn,jax_fn,rows", COLLECTIVES, ids=[c[0] for c in COLLECTIVES])
def test_collective_matches_jax(rng, name, port_fn, jax_fn, rows):
    """Each collective over 8 shards against JAX's under ``shard_map`` on
    the 8 virtual devices: shard i's result, for every i."""
    x = rng.standard_normal((8 * rows, 3)).astype(np.float32)
    f = jcol.shard_mapped(jmake_mesh(n_data=1, n_model=8), [P("model")], P("model"), jax_fn, check_vma=False)
    expect = np.asarray(f(x))
    got = port_fn(list(torch.from_numpy(x).chunk(8)))
    assert len(got) == 8
    np.testing.assert_allclose(torch.cat(got).numpy(), expect, rtol=1e-6, atol=1e-6)
    if name == "ring_all_gather":
        for a, b in zip(got, collectives.all_gather(list(torch.from_numpy(x).chunk(8)))):
            assert torch.equal(a, b)  # bitwise


@pytest.mark.parametrize("lanes", [(), (3,)])
def test_distributed_softmax_combine_matches_jax(rng, lanes):
    """Four shards' statistics, one of them all padding (m = -1e30), against
    JAX's combine under ``shard_map``, and against the unsharded result."""
    n, d, p = 4, 5, 7
    m = (rng.standard_normal((n,) + lanes + (p,)) * 3).astype(np.float32)
    m[2] = -1e30
    l = rng.uniform(0.5, 20, (n,) + lanes + (p,)).astype(np.float32)
    acc = (rng.uniform(0, 1, (n,) + lanes + (d, p)) * l[..., None, :]).astype(np.float32)
    mesh = jmake_mesh(n_data=1, n_model=n, devices=jax.devices()[:n])
    f = jcol.shard_mapped(mesh, [P("model")] * 3, P(), lambda a, b, c: jcombine(a[0], b[0], c[0], "model"),
                          check_vma=False)
    expect = np.asarray(f(m, l, acc))
    got = distributed_softmax_combine(*(list(torch.from_numpy(a)) for a in (m, l, acc)))
    assert got.shape == lanes + (d, p)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-6)
    w = np.exp(m - m.max(axis=0))
    np.testing.assert_allclose(got.numpy(), (acc * w[..., None, :]).sum(0) / (l * w).sum(0)[..., None, :],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("prob", [False, True])
def test_sharded_affinity_propagate_matches_jax(rng, prob):
    """K = 11 frames over 4 shards (padded with masked slots), padding and
    sparse slots, against JAX's sharded function and the dense op."""
    n, k, (h, w), c, d = 4, 11, (5, 6), 8, 5
    p = h * w
    ref = rng.standard_normal((k, p, c)).astype(np.float32)
    tgt = rng.standard_normal((p, c)).astype(np.float32)
    lab = rng.random((k, p, d)).astype(np.float32)
    valid = np.ones(k, bool)
    valid[9:] = False
    dense = np.zeros(k, bool)
    dense[5:9] = True
    wd = None if prob else np.asarray(jspatial_weight((h, w), 8.0))
    ws = None if prob else np.asarray(jspatial_weight((h, w), 21.0))
    expect = jsharded_propagate(jmake_mesh(n_data=1, n_model=n, devices=jax.devices()[:n]), ref, tgt, lab,
                                temperature=1.6, valid=valid, dense=dense, weight_dense=wd, weight_sparse=ws,
                                precision="highest")
    t = torch.from_numpy
    kw = dict(temperature=1.6, valid=t(valid), dense=t(dense),
              weight_dense=None if prob else spatial_weight((h, w), 8.0),
              weight_sparse=None if prob else spatial_weight((h, w), 21.0))
    got = sharded_affinity_propagate(_cpu_mesh(1, n), t(ref), t(tgt), t(lab), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-6)
    dense_op = affinity_propagate(t(ref), t(tgt), t(lab), **kw)
    np.testing.assert_allclose(got.numpy(), dense_op.numpy(), rtol=1e-5, atol=1e-6)


H, W = 40, 48  # a 5 x 6 feature grid: P = 30 leaves a ragged last shard at 4 shards
N_FRAMES = 13  # past a ring wrap at frame_range 6


def _video(rng):
    frames = rng.integers(0, 255, size=(N_FRAMES, H, W, 3), dtype=np.uint8)
    label = np.zeros((H, W), np.int32)
    label[:, : W // 2] = 1
    label[24:, 24:] = 2
    return frames, label


@pytest.fixture(scope="module")
def nets():
    jnet, variables = jax_variables("resnet18", 5)
    return jnet, variables, port_net("resnet18", variables)


@pytest.mark.parametrize("n,prob", [(2, False), (4, False), (4, True)])
def test_sharded_engine_matches_jax_and_single(rng, nets, monkeypatch, n, prob):
    """``ShardedPropagationEngine`` at n shards (4: a ragged last shard) on
    the JAX engine's weights, chunk by chunk across a ring wrap.

    Given the JAX encoder's features, its scores equal the JAX sharded
    engine's and the port's one-device engine's to float32 rounding. Through the port's own encoder its masks agree with
    the JAX engine's, and ``step`` gives the chunk paths' masks."""
    jnet, variables, net = nets
    # this random network's similarities reach ~8e3, ~16 after the temperature:
    # logits of ~1e2 would carry the encoders' last-bit differences to 1e-4
    # of a score
    temperature = 0.002
    jcfg = JConfig(ref_num=5, frame_range=6, temperature=temperature, probability_propagation=prob,
                   compute_dtype=np.float32, use_pallas=False)
    cfg = EngineConfig(ref_num=5, frame_range=6, temperature=temperature, probability_propagation=prob)
    jengine = JSharded(jnet, variables, (H, W), jcfg, jmake_mesh(n_data=1, n_model=n, devices=jax.devices()[:n]))
    engine = ShardedPropagationEngine(net, (H, W), cfg, _cpu_mesh(1, n))
    single = PropagationEngine(net, (H, W), cfg, "cpu")
    assert engine._wd is None and engine.p_loc == -(-engine.p // n)
    if n == 4:
        assert engine.p % n  # ragged
    frames, label = _video(rng)

    # the port's own encoder: masks against the JAX engine's, step against the chunks
    jmasks, _ = jengine.step_chunk_small(frames[1:], jengine.start_video(frames[0], label), 1)
    masks, _ = engine.step_chunk_small(frames[1:], engine.start_video(frames[0], label), 1)
    agree = float((masks.numpy() == np.asarray(jmasks)).mean())
    assert agree >= 0.999, agree
    assert len(np.unique(masks.numpy())) > 1  # the masks are not constant
    st = engine.start_video(frames[0], label)
    scores, _ = engine.step_chunk_scores(frames[1:5], engine.start_video(frames[0], label), 1)
    for i in range(4):
        # the CPU sums a dilated convolution of one image in another order
        # than of four, so the features, and the scores, differ in their last bits
        one, st = engine.step(frames[1 + i], st, 1 + i)
        torch.testing.assert_close(one, scores[i], rtol=1e-3, atol=1e-5)
        assert torch.equal(one.argmax(0), scores[i].argmax(0))
    assert torch.equal(masks[:4], scores.argmax(1).view(masks[:4].shape).to(torch.uint8))

    # the JAX encoder's features into both port engines
    jencode = jax.jit(lambda f: jengine._encode_batch(jengine.enc_params, f))
    for e in (engine, single):
        monkeypatch.setattr(e, "encode", lambda f: torch.from_numpy(np.array(jencode(np.asarray(f)))))
    jst, st, sst = (e.start_video(frames[0], label) for e in (jengine, engine, single))
    assert len(st.feats) == n and st.feats[0].shape == (cfg.capacity, engine.p_loc, 256)
    for start in range(1, N_FRAMES, 4):
        batch = frames[start : start + 4]
        scores, st = engine.step_chunk_scores(batch, st, start)
        jscores, jst = jengine.step_chunk_scores(batch, jst, start)
        sscores, sst = single.step_chunk_scores(batch, sst, start)
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(scores, sscores, rtol=1e-5, atol=1e-6)
        assert torch.equal(scores.argmax(1), sscores.argmax(1))


def test_sharded_bank_holds_row_blocks(rng, nets):
    """Each shard holds its global row block of every slot; the last shard's
    rows past P stay zero."""
    _, _, net = nets
    cfg = EngineConfig(ref_num=5, frame_range=6)
    engine = ShardedPropagationEngine(net, (H, W), cfg, _cpu_mesh(1, 4))
    single = PropagationEngine(net, (H, W), cfg, "cpu")
    frames, label = _video(rng)
    st, sst = engine.start_video(frames[0], label), single.start_video(frames[0], label)
    _, st = engine.step_chunk_small(frames[1:4], st, 1)
    _, sst = single.step_chunk_small(frames[1:4], sst, 1)
    full_f = torch.cat(st.feats, dim=1)
    full_l = torch.cat(st.labels, dim=1)
    p = engine.p
    torch.testing.assert_close(full_f[:, :p], sst.feats, rtol=0, atol=0)
    assert torch.equal(full_l[:, :p], sst.labels)
    assert not full_f[:, p:].any() and not full_l[:, p:].any()


def _launch_calls(tree):
    """Calls of a ctypes library function whose name ends in ``_launch`` or
    ``_plan``, and a local ``fn(...)`` (the bottleneck wrapper's launch)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else f.id if isinstance(f, ast.Name) else ""
            if name.endswith("_launch") or name.endswith("_plan") or name == "fn":
                yield node


def _device_scoped(tree, call) -> bool:
    """Whether ``call`` lies inside ``with torch.cuda.device(...)``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
            ast.unparse(item.context_expr).startswith("torch.cuda.device(") for item in node.items
        ):
            if any(inner is call for inner in ast.walk(node)):
                return True
    return False


@pytest.mark.parametrize("module", ["affinity.py", "bottleneck.py"])
def test_kernel_launches_run_on_their_tensors_device(module):
    """The libraries' host code works on the CUDA runtime's current device:
    every plan and launch call sits inside ``with torch.cuda.device(...)``
    (a card other than the current one would fail or run on the wrong
    context otherwise; ``tests/test_torch_cuda.py`` runs it on a second
    card)."""
    tree = ast.parse((REPO / "semi_supervised_vos_tpu_torch" / "ops" / module).read_text())
    calls = list(_launch_calls(tree))
    # affinity.py: the plan (in _plan and its caller), the sweep and the combine
    assert len(calls) == (4 if module == "affinity.py" else 1)
    for call in calls:
        assert _device_scoped(tree, call), ast.unparse(call)[:80]
