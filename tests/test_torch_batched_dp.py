"""Port parity for lockstep inference over a mesh on the CPU:
``DataParallelBatchedEngine`` (lanes over the data rows, optionally bank rows
over each row's devices) against the JAX package's on the 8 virtual host
devices and against the port's one-device lockstep engine; how the CLI
counts cards and the lane cap scales over a mesh. The CLI's
``--bank-shards`` / ``--dp-shards`` runs are in ``test_torch_batched_dp_pngs.py``,
its refusals in ``test_torch_batched_dp_cli.py``."""

import jax
import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu.infer.batched import LaneFusion as JLaneFusion
from semi_supervised_vos_tpu.infer.engine import EngineConfig as JConfig
from semi_supervised_vos_tpu.parallel.batched_dp import DataParallelBatchedEngine as JDataParallel
from semi_supervised_vos_tpu.parallel.mesh import make_mesh as jmake_mesh
from semi_supervised_vos_tpu_torch.infer import batched
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig
from semi_supervised_vos_tpu_torch.parallel.batched_dp import BankShardedBatchedEngine, DataParallelBatchedEngine
from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_batched_dp_cli import one_compute_thread  # noqa: F401  (an autouse fixture)
from tests.test_torch_models import jax_variables, port_net

H, W = 40, 48  # a 5 x 6 feature grid: P = 30, ragged over 4 bank shards
N_FRAMES = 9


@pytest.fixture(scope="module")
def nets():
    jnet, variables = jax_variables("resnet18", 5)
    return jnet, variables, port_net("resnet18", variables)


def _lanes(rng, videos, flips):
    """(N, videos x lanes, H, W, 3) frames and lane labels, video-major, each
    video's lanes its frames flipped by ``flips``."""
    vids = rng.integers(0, 255, size=(N_FRAMES, videos, H, W, 3), dtype=np.uint8)
    labels = np.zeros((videos, H, W), np.int32)
    for v in range(videos):
        labels[v, 8 + 2 * v : 30 + 2 * v, 10 : 36 + 3 * v] = 1 + v % 2
        labels[v, 30:, :12] = 2 - v % 2
    frames = np.stack([vids[:, v][:, :, ::-1] if f == "h" else vids[:, v] for v in range(videos) for f in flips],
                      axis=1)
    lane_labels = np.stack([labels[v][:, ::-1] if f == "h" else labels[v] for v in range(videos) for f in flips])
    return np.ascontiguousarray(frames), np.ascontiguousarray(lane_labels)


# (id, data rows, bank shards, videos, fused hor-flip lanes, probability)
CASES = [
    ("dp2-pad", 2, 1, 3, False, False),
    ("dp2xbank2", 2, 2, 2, False, False),
    ("dp2xbank2-prob", 2, 2, 3, False, True),
    ("dp2-fused-pad", 2, 1, 3, True, False),
    ("dp2xbank2-fused", 2, 2, 2, True, False),
]


@pytest.mark.parametrize("name,n_data,n_bank,videos,fused,prob", CASES, ids=[c[0] for c in CASES])
def test_mesh_engine_matches_jax_and_lockstep(rng, nets, name, n_data, n_bank, videos, fused, prob):
    """The mesh engine on the port's CPU mesh (the CPU named n_data x n_bank
    times) against the JAX mesh engine on the virtual devices and the port's
    one-device lockstep engine, at the global, unpadded shapes: masks equal
    with lanes over data rows alone (as the JAX tests demand of the JAX
    engine), >= 99.9 % of pixels with bank shards (float32 sums in another
    order may flip a near-tie); in probability mode the scores within float32
    rounding (the encode batch differs, and the CPU sums a dilated
    convolution of one image in another order than of several)."""
    jnet, variables, net = nets
    flips = (None, "h") if fused else (None,)
    temperature = 0.02 if prob else 1.0
    jcfg = JConfig(ref_num=5, frame_range=6, temperature=temperature, probability_propagation=prob,
                   compute_dtype=np.float32, use_pallas=False)
    cfg = EngineConfig(ref_num=5, frame_range=6, temperature=temperature, probability_propagation=prob)
    b = videos * len(flips)
    jfusion = JLaneFusion(pred_flips=flips) if fused else None
    fusion = batched.LaneFusion(flips) if fused else None
    jmesh = jmake_mesh(n_data=n_data, n_model=n_bank, devices=jax.devices()[: n_data * n_bank])
    jengine = JDataParallel(jnet, variables, (H, W), b, jcfg, jfusion, mesh=jmesh)
    mesh = make_mesh(n_data, n_bank, devices=[torch.device("cpu")] * (n_data * n_bank))
    engine = DataParallelBatchedEngine(net, (H, W), b, cfg, mesh, fusion)
    lockstep = batched.BatchedPropagationEngine(net, (H, W), b, cfg, "cpu", fusion)
    assert engine.b_pad == jengine.b_pad and engine.per_row == jengine.inner.b
    assert all(isinstance(e, BankShardedBatchedEngine) == (n_bank > 1) for e in engine.engines)
    frames, labels = _lanes(rng, videos, flips)
    jst, st, lst = (e.start_videos(frames[0], labels) for e in (jengine, engine, lockstep))
    agree, seen = [], set()
    for start in range(1, N_FRAMES, 4):
        batch = frames[start : start + 4]
        if prob:
            got, st = engine.step_chunk_scores(batch, st, start)
            jgot, jst = jengine.step_chunk_scores(batch, jst, start)
            ref, lst = lockstep.step_chunk_scores(batch, lst, start)
            assert got.shape == (len(batch), b, cfg.num_classes, engine.p)
            np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
            got, jgot, ref = got.argmax(2), np.asarray(jgot).argmax(2), ref.argmax(2)
        else:
            step = "step_chunk" if fused else "step_chunk_small"
            got, st = getattr(engine, step)(batch, st, start)
            jgot, jst = getattr(jengine, step)(batch, jst, start)
            ref, lst = getattr(lockstep, step)(batch, lst, start)
            assert got.shape == ((len(batch), videos, H, W) if fused else (len(batch), b, engine.hd, engine.wd))
        agree += [float((got.numpy() == np.asarray(jgot)).mean()), (got == ref).float().mean().item()]
        seen.update(np.unique(ref.numpy()).tolist())
    assert len(seen) > 1  # the masks are not constant
    assert min(agree) >= (0.999 if n_bank > 1 else 1.0), agree


def test_cli_counts_cards_on_the_card_only(monkeypatch):
    """On the card ``--dp-shards x --bank-shards`` may not exceed the cards
    (the JAX message); with ``--device cpu`` the mesh is virtual, so the CPU
    takes any count."""
    import click

    from semi_supervised_vos_tpu_torch.cli.inference import make_meshes

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(click.ClickException, match=r"--dp-shards 1 x --bank-shards 2 exceeds the 1 available"):
        make_meshes(torch.device("cuda"), 1, 2, 1)
    mesh, mesh_dp = make_meshes(torch.device("cpu"), 8, 4, 2)
    assert mesh is None and mesh_dp.shape == {"data": 2, "model": 4}
    assert mesh_dp.distinct_devices == [torch.device("cpu")]
    mesh, mesh_dp = make_meshes(torch.device("cpu"), 1, 3, 1)
    assert mesh_dp is None and mesh.shape == {"data": 1, "model": 3}
    assert make_meshes(torch.device("cpu"), 4, 1, 1) == (None, None)


def test_lane_cap_scales_by_distinct_cards():
    """The lockstep lane cap scales by the distinct cards that encode: a
    virtual mesh naming one card in every row keeps one card's cap, a mesh
    over two cards doubles it (no card is touched: devices are names)."""
    from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh

    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    virtual = Mesh([[cuda0, cuda0], [cuda0, cuda0]])
    two_cards = Mesh([[cuda0], [cuda1]])
    assert batched._mesh_data_chips(None) == 1
    assert batched._mesh_data_chips(virtual) == 1
    assert batched._mesh_data_chips(two_cards) == 2
    assert batched._mesh_data_chips(make_mesh(4, 1, devices=[torch.device("cpu")] * 4)) == 1
    hw = (480, 854)
    one = batched._clamp_video_batch(10_000, 1, hw)
    assert batched._clamp_video_batch(10_000, 1, hw, n_chips=batched._mesh_data_chips(virtual)) == one
    assert batched._clamp_video_batch(10_000, 1, hw, n_chips=batched._mesh_data_chips(two_cards)) == 2 * one
