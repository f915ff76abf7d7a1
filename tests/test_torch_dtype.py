"""Port parity of the compute-dtype knobs and the profiling module:

* ``SVOS_INFER_DTYPE`` (``cli/inference.py::infer_dtype``): the default per
  device and a bad value refused;
* the float32 bank (bf16 labels) that the float32 kernel takes:
  ``affinity_from_bank_plain`` against the JAX Pallas kernel in interpret
  mode on the same float32 bank, and with one-hot labels against the
  float32 golden;
* the float32 ``fast_encode`` (its fused blocks on the plain bottleneck)
  against the JAX package's (``interpret=True``), resnet50 and facebook;
* the port CLI under ``SVOS_INFER_DTYPE=bfloat16`` on the CPU against the
  JAX CLI under the same variable; ``SVOS_FAST_ENCODER=0``, ``SVOS_PROFILE``
  and ``SVOS_TRACE_DIR`` on the CPU.

The float32 CUDA kernels against their plain versions are in
``tests/test_torch_cuda.py``.
"""

import json
import logging
import re

import click
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from semi_supervised_vos_tpu.core.propagation import affinity_propagate as j_golden
from semi_supervised_vos_tpu.core.spatial import spatial_weight as j_spatial_weight
from semi_supervised_vos_tpu.models.infer_fast import build_fast_encoder
from semi_supervised_vos_tpu.ops import affinity_pallas as jap
from semi_supervised_vos_tpu_torch.__main__ import cli
from semi_supervised_vos_tpu_torch.cli.inference import infer_dtype
from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
from semi_supervised_vos_tpu_torch.infer import batched
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
from semi_supervised_vos_tpu_torch.models.infer_fast import fast_encode
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from semi_supervised_vos_tpu_torch.ops import affinity as tap
from tests.test_pallas_affinity import _assert_argmax_close
from tests.test_torch_affinity import _bank
from tests.test_torch_cli import _inference_args, davis_and_ckpt  # noqa: F401  (module fixture)
from tests.test_torch_models import jax_variables, port_net


# ---- SVOS_INFER_DTYPE ---------------------------------------------------------


@pytest.mark.parametrize(
    "device,value,expect",
    [("cpu", None, torch.float32), ("cuda", None, torch.bfloat16), ("cpu", "bfloat16", torch.bfloat16),
     ("cuda", "float32", torch.float32)],
)
def test_infer_dtype_default_per_device(monkeypatch, device, value, expect):
    """Unset: bf16 on the card, float32 on the CPU (the JAX CLI's defaults);
    set: as named. No card is touched: only the device's type is read."""
    if value is None:
        monkeypatch.delenv("SVOS_INFER_DTYPE", raising=False)
    else:
        monkeypatch.setenv("SVOS_INFER_DTYPE", value)
    assert infer_dtype(torch.device(device)) == expect


@pytest.mark.parametrize("value", ["float16", "fp32", ""])
def test_infer_dtype_refuses_other_values(monkeypatch, davis_and_ckpt, tmp_path, value):  # noqa: F811
    monkeypatch.setenv("SVOS_INFER_DTYPE", value)
    with pytest.raises(click.UsageError, match="float32 or bfloat16"):
        infer_dtype(torch.device("cpu"))
    root, ckpt = davis_and_ckpt
    res = CliRunner().invoke(cli, _inference_args(root, ckpt, tmp_path / "out") + ["--device", "cpu"])
    assert res.exit_code == 2 and "SVOS_INFER_DTYPE must be float32 or bfloat16" in res.output
    assert not list(tmp_path.rglob("*.png"))


def test_engine_dtypes_follow_the_config():
    """On the CPU, bf16 rounds the features (the bank) and keeps float32
    labels and the unpadded class budget, as the JAX CPU path does."""
    net = VOSNet("resnet18").eval()
    for dtype, expect in ((None, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)):
        engine = PropagationEngine(net, (64, 80), EngineConfig(compute_dtype=dtype), "cpu")
        state = engine.init_state()
        assert (engine.dtype, state.feats.dtype, state.labels.dtype) == (expect, expect, torch.float32)
        assert state.labels.shape[-1] == EngineConfig().num_classes
        frame = np.random.default_rng(0).integers(0, 255, (64, 80, 3), dtype=np.uint8)
        assert engine.encode(frame[None]).dtype == expect
    with pytest.raises(ValueError, match="compute_dtype"):
        PropagationEngine(net, (64, 80), EngineConfig(compute_dtype=torch.float16), "cpu")


def test_float32_lane_envelope():
    """A float32 bank doubles the feature bytes a lane: the float32 budget is
    below the bf16 one at both anchors, per network, and the clamp reads
    the dtype it is given (bf16 by default, as the JAX package's)."""
    for hw in ((480, 854), (1080, 1920)):
        for arch in ("resnet50", "facebook"):
            f32 = batched._hbm_lanes_cap(hw, arch, torch.float32)
            assert 1 <= f32 < batched._hbm_lanes_cap(hw, arch)
            assert batched._clamp_video_batch(10**6, 1, hw, archs=(arch,), dtype=torch.float32) == f32
    assert batched._clamp_video_batch(10**6, 1, (480, 854)) == batched._hbm_lanes_cap((480, 854))


# ---- the float32 bank ---------------------------------------------------------

# name: (hd, wd, cap, k, frame_idx, temperature, spatial, b, slots_kept, one_valid)
BANK_CASES = {
    "batched": (6, 8, 12, 5, 9, 0.8, True, 2, None, False),
    "k1": (6, 8, 12, 1, 9, 1.0, True, 1, 1, False),
    "ragged_p": (5, 7, 12, 5, 11, 1.1, True, 1, None, False),
    "one_valid": (6, 8, 12, 9, 50, 1.0, True, 1, None, True),
    "probability": (6, 8, 12, 5, 11, 1.1, False, 1, None, False),
}


def _slots(k, frame_idx, cap, kept, one_valid):
    idx, valid, dense = sample_frames(frame_idx, 40, k)
    if kept is not None:
        idx, valid, dense = idx[:kept], valid[:kept], dense[:kept]
    if one_valid:
        valid = np.zeros_like(valid)
        valid[len(valid) // 2] = True
    return idx % cap, valid, dense


@pytest.mark.parametrize("case", sorted(BANK_CASES))
def test_f32_bank_plain_matches_pallas_interpret(rng, case):
    """A float32 bank and target with bf16 labels, the engine's float32 card
    bank. Tolerance as ``tests/test_torch_affinity.py``: the JAX kernel
    rounds e·w to bf16 once, the plain version keeps a bf16 hi and lo."""
    hd, wd, cap, k, frame_idx, temp, spatial, b, kept, one_valid = BANK_CASES[case]
    p, c, d_pad = hd * wd, 32, 24
    feats, labels = _bank(rng, cap, b, p, 128, c, d_pad)
    slots, valid, dense = _slots(k, frame_idx, cap, kept, one_valid)
    tgt = (rng.standard_normal((b, p, c)) * 0.3).astype(np.float32)
    kw = dict(feature_hw=(hd, wd), temperature=temp, valid=valid, dense=dense, spatial=spatial)
    expect = np.asarray(
        jap.affinity_from_bank_batched(
            jnp.asarray(feats), jnp.asarray(labels, jnp.bfloat16), jnp.asarray(tgt), jnp.asarray(slots),
            block_r=128, block_t=128, interpret=True, **kw,
        )
    )
    got = tap.affinity_from_bank_batched(
        torch.as_tensor(feats), torch.as_tensor(labels).to(torch.bfloat16), torch.as_tensor(tgt), slots, **kw
    ).numpy()
    assert got.shape == expect.shape == (b, d_pad, p)
    for v in range(b):
        _assert_argmax_close(got[v], expect[v])
    np.testing.assert_allclose(got, expect, rtol=0.05, atol=5e-3)
    assert (got[:, 5:] == 0).all()  # padded classes exactly zero


def test_f32_bank_stats_with_row_base_match_pallas_interpret(rng):
    """Stats mode on four float32 shards of 16 rows (the last past P),
    each against the JAX kernel's stats for the same shard and row_base."""
    hd, wd, c, d_pad, cap, k = 6, 9, 32, 24, 10, 5
    p, n_shards, p_loc = hd * wd, 4, 16
    feats, labels = _bank(rng, cap, 1, p, n_shards * p_loc, c, d_pad)
    feats, labels = feats[:, 0], labels[:, 0]
    slots, valid, dense = _slots(k, 9, cap, None, False)
    tgt = (rng.standard_normal((p, c)) * 0.3).astype(np.float32)
    kw = dict(feature_hw=(hd, wd), temperature=0.9, valid=valid, dense=dense)
    for s in range(n_shards):
        rows = slice(s * p_loc, (s + 1) * p_loc)
        expect = jap.affinity_from_bank_stats(
            jnp.asarray(feats[:, rows]), jnp.asarray(labels[:, rows], jnp.bfloat16), jnp.asarray(tgt),
            jnp.asarray(slots), row_base=s * p_loc, block_r=16, block_t=64, interpret=True, **kw,
        )
        got = tap.affinity_from_bank_stats(
            torch.as_tensor(feats[:, rows]), torch.as_tensor(labels[:, rows]).to(torch.bfloat16),
            torch.as_tensor(tgt), slots, row_base=s * p_loc, **kw,
        )
        m_e, l_e, a_e = (np.asarray(x) for x in expect)
        m_g, l_g, a_g = (x.numpy() for x in got)
        np.testing.assert_allclose(m_g, m_e, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(l_g, l_e, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a_g, a_e, rtol=0.05, atol=5e-3)


@pytest.mark.parametrize("frame_idx,spatial", [(7, True), (30, True), (12, False)])
def test_f32_bank_one_hot_labels_match_golden(rng, frame_idx, spatial):
    """With one-hot bf16 labels the float32 bank's plain version is the
    float32 golden to 1e-5 (``tests/test_torch_affinity.py``): hi + lo keeps
    e·w to 2^-17."""
    hd, wd, c, d_pad, cap, k = 6, 8, 32, 24, 45, 9
    p = hd * wd
    feats, labels = _bank(rng, cap, 1, p, 64, c, d_pad)
    slots, valid, dense = _slots(k, frame_idx, cap, None, False)
    tgt = (rng.standard_normal((p, c)) * 0.3).astype(np.float32)
    got = tap.affinity_from_bank(
        torch.as_tensor(feats[:, 0]), torch.as_tensor(labels[:, 0]).to(torch.bfloat16), torch.as_tensor(tgt), slots,
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


# ---- the float32 encoder --------------------------------------------------------


@pytest.mark.parametrize("arch", ["resnet50", "facebook"])
def test_f32_fast_encode_matches_jax(rng, arch):
    """The float32 table and ``fast_encode`` (its fused blocks on the plain
    bottleneck in float32) against the JAX fast encoder at float32 in
    interpret mode: min per-pixel cosine >= 0.99999."""
    _, variables = jax_variables(arch, 5)
    net = port_net(arch, variables)
    x = (rng.standard_normal((1, 32, 40, 3)) * 0.7).astype(np.float32)
    encode = build_fast_encoder(variables, dtype=jnp.float32, use_fused_stack=True, interpret=True, arch=arch)
    expect = np.asarray(encode(jnp.asarray(x)))
    with torch.no_grad():
        got = fast_encode(fold_vosnet(net, torch.float32), torch.as_tensor(x), torch.float32, arch=arch)
    assert got.dtype == torch.float32 and got.shape == expect.shape == (1, 4, 5, 256)
    cos = torch.nn.functional.cosine_similarity(got.reshape(-1, 256), torch.as_tensor(expect).reshape(-1, 256), dim=-1)
    assert cos.min().item() >= 0.99999


# ---- the CLI ----------------------------------------------------------------------


def _pngs(root):
    return {p.relative_to(root): np.asarray(Image.open(p)) for p in sorted(root.rglob("*.png"))}


def _port_run(root, ckpt, out, monkeypatch, **env):
    with monkeypatch.context() as m:
        for key, value in env.items():
            m.setenv(key, value)
        res = CliRunner().invoke(cli, _inference_args(root, ckpt, out) + ["--device", "cpu"])
    assert res.exit_code == 0, res.output
    return _pngs(out)


@pytest.fixture(scope="module")
def port_default(davis_and_ckpt, tmp_path_factory):  # noqa: F811
    """The port CLI's PNGs at the CPU's default dtype (float32)."""
    root, ckpt = davis_and_ckpt
    out = tmp_path_factory.mktemp("port_default")
    res = CliRunner().invoke(cli, _inference_args(root, ckpt, out) + ["--device", "cpu"])
    assert res.exit_code == 0, res.output
    return _pngs(out)


def test_cli_bf16_matches_jax_cli(davis_and_ckpt, tmp_path, monkeypatch):  # noqa: F811
    """``SVOS_INFER_DTYPE=bfloat16`` on the CPU in both CLIs: bf16 features
    and bank, float32 labels and golden affinity. The PNGs are byte-identical
    here; the contract allows 0.999 of pixels, where torch's CPU product of
    the upcast bf16 features sums in another order than XLA's."""
    from semi_supervised_vos_tpu.cli.inference import inference_command_impl

    root, ckpt = davis_and_ckpt
    monkeypatch.setenv("SVOS_INFER_DTYPE", "bfloat16")
    inference_command_impl(
        ref_num=9, data=str(root), resume=str(ckpt), model="resnet18", temperature=1.0,
        frame_range=40, sigma_1=8.0, sigma_2=21.0, save=str(tmp_path / "jax"), device="cpu",
        inference_strategy="single", additional_resume=None, additional_model_type="resnet18",
        probability_propagation=False, scale=1.15, reduction="mean", disable=True,
    )
    jax_pngs = _pngs(tmp_path / "jax")
    port = _port_run(root, ckpt, tmp_path / "port", monkeypatch)
    assert sorted(port) == sorted(jax_pngs) and len(port) == 10
    same = sum(int((port[k] == jax_pngs[k]).sum()) for k in port)
    total = sum(v.size for v in port.values())
    assert same / total >= 0.999
    assert {c for v in port.values() for c in np.unique(v).tolist()} == {0, 1, 2}


def test_fast_encoder_off_changes_nothing_on_the_cpu(davis_and_ckpt, port_default, tmp_path, monkeypatch):  # noqa: F811
    """The CPU never takes the fast encoder (as in JAX, where it is
    TPU-only): ``SVOS_FAST_ENCODER=0`` gives the same PNGs."""
    root, ckpt = davis_and_ckpt
    got = _port_run(root, ckpt, tmp_path / "out", monkeypatch, SVOS_FAST_ENCODER="0")
    assert sorted(got) == sorted(port_default)
    assert all((got[k] == port_default[k]).all() for k in got)


def test_profile_logs_the_chunk_phases(davis_and_ckpt, port_default, tmp_path, monkeypatch):  # noqa: F811
    """``SVOS_PROFILE=1``: one ``phase timing`` report of the recorder's
    spans and counters (the JAX format), and the same PNGs."""
    root, ckpt = davis_and_ckpt
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logging.getLogger("svos_torch").addHandler(handler)
    try:
        got = _port_run(root, ckpt, tmp_path / "out", monkeypatch, SVOS_PROFILE="1")
    finally:
        logging.getLogger("svos_torch").removeHandler(handler)
    report = [r for r in records if r.startswith("phase timing | ")]
    assert len(report) == 1, records
    # two videos of 4 propagated frames: one chunk each
    assert re.search(r"\| engine\.step: [0-9.]+s \(2x, ", report[0]), report[0]
    for name in ("engine.start", "engine.upload", "engine.encode", "engine.propagate", "engine.write",
                 "drain.job", "png.write", "upload.pageable_bytes"):
        assert f"{name}: " in report[0], name
    assert all((got[k] == port_default[k]).all() for k in got)


def test_trace_dir_writes_a_trace(davis_and_ckpt, port_default, tmp_path, monkeypatch):  # noqa: F811
    """``SVOS_TRACE_DIR``: one Chrome trace of the loop (CPU activity here),
    and the same PNGs; unset, no trace."""
    root, ckpt = davis_and_ckpt
    trace_dir = tmp_path / "trace"
    got = _port_run(root, ckpt, tmp_path / "out", monkeypatch, SVOS_TRACE_DIR=str(trace_dir))
    traces = list(trace_dir.glob("trace-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert all((got[k] == port_default[k]).all() for k in got)
