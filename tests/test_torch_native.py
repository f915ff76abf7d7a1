"""The port's native host loaders (``csrc/host/decode.cpp`` through
``data/native_decode.py``, ``csrc/host/upsample.cpp`` through
``ops/native_upsample.py``) against PIL, the numpy mapping and the JAX
package's loaders, byte for byte; their wiring into the datasets and
``nearest_resize_host``; a self-check that disagrees; and where the build
writes."""

import hashlib
import io

import numpy as np
import pytest
from PIL import Image

from semi_supervised_vos_tpu_torch.data import native_decode
from semi_supervised_vos_tpu_torch.ops import _build, native_upsample
from tests.helpers import make_davis_dataset

REPO_NATIVE = _build._PKG.parent / "native"


def _jpegs(rng, n, hw=(48, 64), quality=93):
    blobs = []
    for _ in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(buf, format="JPEG", quality=quality)
        blobs.append(buf.getvalue())
    return blobs


def _pil(blob):
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def _reset(*modules):
    for m in modules:
        m._state, m.reason = None, ""


@pytest.fixture
def decoders(monkeypatch):
    """The port's decoder and the JAX package's, both on."""
    from semi_supervised_vos_tpu.data import native_decode as jax_decode

    monkeypatch.setenv("SVOS_NATIVE_DECODE", "1")
    _reset(native_decode)
    jax_decode._state = None
    assert native_decode.available(), native_decode.reason
    assert jax_decode.available()
    yield native_decode, jax_decode
    _reset(native_decode)
    jax_decode._state = None


@pytest.fixture
def upsamplers(monkeypatch):
    from semi_supervised_vos_tpu.ops import native_upsample as jax_upsample

    monkeypatch.delenv("SVOS_NATIVE_UPSAMPLE", raising=False)
    _reset(native_upsample)
    jax_upsample._state = None
    assert native_upsample.available(), native_upsample.reason
    yield native_upsample, jax_upsample
    _reset(native_upsample)
    jax_upsample._state = None


@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (120, 214)])
def test_decode_equals_pil_and_jax(decoders, hw):
    port, jax_dec = decoders
    blobs = _jpegs(np.random.default_rng(hw[0]), 5, hw)
    pil = np.stack([_pil(b) for b in blobs])
    for b, want in zip(blobs, pil):
        got = port.decode_jpeg(b)
        assert got.dtype == np.uint8 and got.shape == (*hw, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_dec.decode_jpeg(b))
    for threads in (0, 1, 4):
        got = port.decode_jpeg_batch(blobs, threads=threads)
        np.testing.assert_array_equal(got, pil)
        np.testing.assert_array_equal(got, jax_dec.decode_jpeg_batch(blobs, threads=threads))


def test_row_bands_equal_whole_decode(decoders):
    port, jax_dec = decoders
    blob = _jpegs(np.random.default_rng(1), 1, (80, 64), quality=88)[0]
    full = _pil(blob)
    for y0, nrows in ((0, 80), (0, 13), (7, 21), (33, 47), (79, 1), (40, 40), (15, 17)):
        band = port.decode_jpeg_rows(blob, y0, nrows)
        np.testing.assert_array_equal(band, full[y0 : y0 + nrows])
        np.testing.assert_array_equal(band, jax_dec.decode_jpeg_rows(blob, y0, nrows))


def test_shape_probe_and_errors(decoders):
    port, jax_dec = decoders
    blob = _jpegs(np.random.default_rng(2), 1, (30, 42))[0]
    assert port.jpeg_shape(blob) == jax_dec.jpeg_shape(blob) == (30, 42)
    for bad in (b"not a jpeg at all", blob[:20]):
        with pytest.raises(ValueError, match="not a decodable JPEG"):
            port.jpeg_shape(bad)
    other = _jpegs(np.random.default_rng(3), 1, (31, 42))[0]  # a batch takes the first image's size
    with pytest.raises(RuntimeError, match="1/2 images failed"):
        port.decode_jpeg_batch([blob, other])


@pytest.mark.parametrize("shape,out_hw", [
    ((3, 60, 107), (480, 854)),  # the single runner's drain: (T, h, w)
    ((4, 2, 60, 107), (480, 854)),  # the lockstep drain: (T, B, h, w)
    ((5, 13, 17), (31, 40)),
    ((2, 3, 7, 9), (7, 9)),
    ((1, 61, 33), (17, 101)),  # downsampling rows, upsampling columns
    ((9, 11), (50, 23)),
])
def test_nearest_u8_equals_numpy_and_jax(upsamplers, shape, out_hw):
    from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize_host

    port, jax_up = upsamplers
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = port.nearest_u8(x, out_hw)
    want = native_upsample._numpy_twin(x, out_hw)
    assert got.shape == want.shape == shape[:-2] + out_hw
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_up.nearest_u8(x, out_hw))
    # through nearest_resize_host, on a strided view too
    hw_axes = (x.ndim - 2, x.ndim - 1)
    np.testing.assert_array_equal(nearest_resize_host(x, out_hw, hw_axes=hw_axes), want)
    view = np.flip(x, axis=-1)
    np.testing.assert_array_equal(nearest_resize_host(view, out_hw, hw_axes=hw_axes),
                                  native_upsample._numpy_twin(view, out_hw))


def test_nearest_resize_host_routes(upsamplers, monkeypatch):
    """uint8 with H, W last takes the native path; other dtypes and layouts
    keep numpy; ``SVOS_NATIVE_UPSAMPLE=0`` turns it off, with the same
    bytes."""
    from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize_host

    port, _ = upsamplers
    calls = []
    real = port.nearest_u8
    monkeypatch.setattr(port, "nearest_u8", lambda x, hw: calls.append(x.shape) or real(x, hw))
    x = np.random.default_rng(3).integers(0, 22, (2, 60, 107), dtype=np.uint8)
    on = nearest_resize_host(x, (480, 854), hw_axes=(1, 2))
    nearest_resize_host(x.astype(np.int32), (480, 854), hw_axes=(1, 2))
    nearest_resize_host(np.moveaxis(x, 0, -1), (480, 854), hw_axes=(0, 1))
    assert calls == [(2, 60, 107)]
    monkeypatch.setattr(port, "nearest_u8", real)
    monkeypatch.setenv("SVOS_NATIVE_UPSAMPLE", "0")
    _reset(port)
    assert not port.available() and "SVOS_NATIVE_UPSAMPLE" in port.reason
    assert port.nearest_u8(x, (480, 854)) is None
    np.testing.assert_array_equal(nearest_resize_host(x, (480, 854), hw_axes=(1, 2)), on)


@pytest.mark.parametrize("strategy", ["single", "hor-flip"])
def test_inference_dataset_equals_jax(decoders, tmp_path, strategy):
    from semi_supervised_vos_tpu.data.davis import InferenceDataset as JaxInferenceDataset
    from semi_supervised_vos_tpu_torch.data.davis import InferenceDataset

    port, _ = decoders
    make_davis_dataset(tmp_path / "davis", videos=("a", "b"), frames=3, size=(48, 64))
    root = str(tmp_path / "davis" / "JPEGImages" / "480p")
    ours, ref = InferenceDataset(root, strategy), JaxInferenceDataset(root, strategy)
    calls = []
    real = port.decode_jpeg
    port.decode_jpeg = lambda b: calls.append(1) or real(b)
    try:
        for i in range(len(ref)):
            (got, gname), (want, wname) = ours[i], ref[i]
            assert gname == wname
            for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(g, np.asarray(w))
    finally:
        port.decode_jpeg = real
    # frame-only strategies decode natively, the PIL-image strategies do not
    assert len(calls) == (len(ref) if strategy == "single" else 0)


def test_train_dataset_row_bands_equal_pil(tmp_path, monkeypatch):
    from semi_supervised_vos_tpu_torch.data.davis import TrainDataset

    make_davis_dataset(tmp_path / "davis", videos=("a", "b"), frames=6, size=(96, 120))
    roots = (tmp_path / "davis" / "JPEGImages" / "480p", tmp_path / "davis" / "Annotations" / "480p")

    def items(native):
        monkeypatch.setenv("SVOS_NATIVE_DECODE", "1" if native else "0")
        _reset(native_decode)
        ds = TrainDataset(*roots, cropping=40, frame_num=3)
        assert native_decode.available() == native
        out = []
        for seed in range(6):  # both flips, several crops
            ds.seed(seed)
            out += [ds[i] for i in range(len(ds))]
        return out

    calls = []
    real = native_decode.decode_jpeg_rows
    monkeypatch.setattr(native_decode, "decode_jpeg_rows", lambda *a: calls.append(a[1:]) or real(*a))
    try:
        got, want = items(True), items(False)
    finally:
        _reset(native_decode)
    assert len(calls) == 3 * 12 * 6 and all(n == 40 for _, n in calls)
    assert len({y0 for y0, _ in calls}) > 3
    for (gi, ga, gv), (wi, wa, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(ga, wa)
        assert gv == wv


@pytest.mark.parametrize("which", ["decode", "upsample"])
def test_disagreeing_self_check_turns_the_path_off(monkeypatch, which):
    lines = []
    monkeypatch.setattr("semi_supervised_vos_tpu_torch.utils.logging.logger.info", lines.append)
    if which == "decode":
        monkeypatch.setenv("SVOS_NATIVE_DECODE", "1")
        real = native_decode._decode_batch_raw
        monkeypatch.setattr(native_decode, "_decode_batch_raw", lambda *a: real(*a) ^ np.uint8(1))
        module = native_decode
    else:
        monkeypatch.delenv("SVOS_NATIVE_UPSAMPLE", raising=False)
        monkeypatch.setattr(native_upsample, "_numpy_twin", lambda x, hw: np.zeros(x.shape[:-2] + tuple(hw), np.uint8))
        module = native_upsample
    _reset(module)
    try:
        assert not module.available() and not module.available()  # decided once
        assert "differ" in module.reason
        assert len(lines) == 1 and "off" in lines[0] and "differ" in lines[0], lines
        if which == "upsample":
            assert module.nearest_u8(np.zeros((2, 3), np.uint8), (4, 6)) is None
    finally:
        _reset(module)


def test_failed_build_turns_the_path_off(monkeypatch):
    import subprocess

    lines = []
    monkeypatch.setattr("semi_supervised_vos_tpu_torch.utils.logging.logger.info", lines.append)

    def fail(name, flags):  # the compiler's message on a host without libjpeg's headers
        raise subprocess.CalledProcessError(1, ["g++"], stderr=b"decode.cpp:20:10: fatal error: jpeglib.h: No such "
                                                                b"file or directory\ncompilation terminated.\n")

    monkeypatch.setattr(_build, "build_host", fail)
    monkeypatch.setattr(native_decode, "_lib", None)
    monkeypatch.setenv("SVOS_NATIVE_DECODE", "1")
    monkeypatch.delenv("SVOS_NATIVE_UPSAMPLE", raising=False)
    _reset(native_decode, native_upsample)
    try:
        assert not native_decode.available() and not native_upsample.available()
        assert "build or load failed" in native_decode.reason and "build or load failed" in native_upsample.reason
        assert "fatal error: jpeglib.h: No such file or directory" in native_decode.reason
        assert len(lines) == 2
    finally:
        _reset(native_decode, native_upsample)


def test_build_writes_under_build_and_leaves_native_alone(tmp_path, monkeypatch):
    from semi_supervised_vos_tpu.data import native_decode as jax_decode
    from semi_supervised_vos_tpu.ops import native_upsample as jax_upsample

    # the JAX package's loaders build into native/ themselves: build them
    # first, so that the snapshot below holds what they wrote
    monkeypatch.setenv("SVOS_NATIVE_DECODE", "1")
    jax_decode._state = jax_upsample._state = None
    jax_decode.available(), jax_upsample._decide()

    # by default the libraries go to the checkout's build/, which .gitignore lists
    assert _build.HOST_BUILD_DIR == _build._PKG.parent / "build" / "host"

    def snapshot():
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(REPO_NATIVE.iterdir()) if p.is_file()}

    before = snapshot()
    commands = []
    real_run = _build.subprocess.run
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw: commands.append(cmd) or real_run(cmd, **kw))
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "build" / "host")
    monkeypatch.setattr(native_decode, "_lib", None)
    _reset(native_decode, native_upsample)
    try:
        assert native_decode.available() and native_upsample.available()
    finally:
        _reset(native_decode, native_upsample)
    assert snapshot() == before
    assert len(commands) == 2
    for cmd in commands:
        out = cmd[cmd.index("-o") + 1]
        assert out.startswith(str(tmp_path / "build" / "host")), cmd
        src = cmd[cmd.index("-o") + 2]
        assert "semi_supervised_vos_tpu_torch/csrc/host/" in src, cmd
    assert sorted(p.suffix for p in (tmp_path / "build" / "host").iterdir()) == [".so", ".so"]
