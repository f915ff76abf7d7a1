"""The port's visualization renderers and CLI
(``python -m semi_supervised_vos_tpu_torch.visualization``) against the JAX
package's ``viz/render.py`` on the same inputs: the ffmpeg argv (a stub
binary records it) for all three commands, and with ``SVOS_FFMPEG=0`` the
OpenCV videos, decoded frame by frame; the stale ``*.noback.png`` cleanup,
the error without any backend, ``AverageMeter``, and that neither module
imports JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

from semi_supervised_vos_tpu.utils.meters import AverageMeter as JAverageMeter
from semi_supervised_vos_tpu.viz import render as jrender
from semi_supervised_vos_tpu_torch.utils.meters import AverageMeter
from semi_supervised_vos_tpu_torch.viz import render
from semi_supervised_vos_tpu_torch.visualization import cli
from tests.test_torch_cli import FORBIDDEN

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def frames(tmp_path):
    """4 source JPEGs (32x48) and 4 palette prediction PNGs at half
    resolution (16x24), a moving red blob (``tests/test_viz.py``'s inputs)."""
    src_dir, pred_dir = tmp_path / "src", tmp_path / "pred"
    src_dir.mkdir()
    pred_dir.mkdir()
    rng = np.random.default_rng(7)
    palette = [0, 0, 0, 255, 0, 0] + [0] * (254 * 3)
    for t in range(4):
        Image.fromarray(rng.integers(0, 255, size=(32, 48, 3), dtype=np.uint8)).save(src_dir / f"{t:05d}.jpg",
                                                                                      quality=95)
        mask = np.zeros((16, 24), np.uint8)
        mask[4 : 8 + t, 6:18] = 1
        p = Image.fromarray(mask, mode="P")
        p.putpalette(palette)
        p.save(pred_dir / f"{t:05d}.png")
    return src_dir, pred_dir


def _read_video(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


@pytest.fixture()
def stub_ffmpeg(tmp_path, monkeypatch):
    """A fake ffmpeg, selected through SVOS_FFMPEG, that records its argv
    and touches its output (the last argument)."""
    rec = tmp_path / "ffmpeg_args.txt"
    stub = tmp_path / "ffmpeg"
    stub.write_text("#!/bin/sh\n" f"printf '%s\\n' \"$@\" > \"{rec}\"\n" "for last; do :; done\n" 'touch "$last"\n')
    stub.chmod(0o755)
    monkeypatch.setenv("SVOS_FFMPEG", str(stub))
    return rec


COMMANDS = {
    "overlay": lambda p, s, o: ["overlay", "-p", p, "-s", s, "-o", o, "-f", "10", "--bw"],
    "overlay --color": lambda p, s, o: ["overlay", "-p", p, "-s", s, "-o", o, "--color"],
    "side-by-side": lambda p, s, o: ["side-by-side", "-p", p, "-s", s, "-o", o, "-f", "12"],
    "prediction-only": lambda p, s, o: ["prediction-only", "-p", p, "-o", o],
}
JAX_CALLS = {
    "overlay": lambda p, s, o: jrender.render_overlay(p, s, o, 10, True),
    "overlay --color": lambda p, s, o: jrender.render_overlay(p, s, o, 15, False),
    "side-by-side": lambda p, s, o: jrender.render_side_by_side(p, s, o, 12),
    "prediction-only": lambda p, s, o: jrender.render_prediction_only(p, o, 15),
}


@pytest.mark.parametrize("command", list(COMMANDS))
def test_ffmpeg_argv_equals_jax(frames, tmp_path, stub_ffmpeg, command):
    """The same argv as the JAX renderer's, the overlay's ``.noback.png``
    intermediates made for the run and removed after it."""
    src_dir, pred_dir = frames
    JAX_CALLS[command](pred_dir, src_dir, tmp_path / "out.mp4")
    want = stub_ffmpeg.read_text().splitlines()
    res = CliRunner().invoke(cli, COMMANDS[command](str(pred_dir), str(src_dir), str(tmp_path / "out.mp4")),
                             catch_exceptions=False)
    assert res.exit_code == 0
    got = stub_ffmpeg.read_text().splitlines()
    assert got == want and got[0] == "-y" and got[-1] == str(tmp_path / "out.mp4")
    if command.startswith("overlay"):
        assert f"{pred_dir}/*.noback.png" in got
    assert not list(pred_dir.glob("*.noback.png"))


@pytest.mark.parametrize("command", list(COMMANDS))
def test_opencv_videos_equal_jax(frames, tmp_path, monkeypatch, command):
    """``SVOS_FFMPEG=0``: OpenCV videos that decode frame-equal to the JAX
    renderer's (the ``--bw`` overlay with a grey background)."""
    monkeypatch.setenv("SVOS_FFMPEG", "0")
    src_dir, pred_dir = frames
    JAX_CALLS[command](pred_dir, src_dir, tmp_path / "jax.mp4")
    res = CliRunner().invoke(cli, COMMANDS[command](str(pred_dir), str(src_dir), str(tmp_path / "port.mp4")),
                             catch_exceptions=False)
    assert res.exit_code == 0
    want, got = _read_video(tmp_path / "jax.mp4"), _read_video(tmp_path / "port.mp4")
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    shape = {"side-by-side": (32, 96, 3), "prediction-only": (16, 24, 3)}.get(command, (32, 48, 3))
    assert got[0].shape == shape
    if command == "overlay":
        bg = got[0][24:, :].astype(np.float32)
        assert abs(bg[:, :, 0].mean() - bg[:, :, 2].mean()) < 6  # greyscale source
        fg = got[0][8:16, 12:36].astype(np.float32)
        assert fg[:, :, 2].mean() > fg[:, :, 0].mean() + 30  # the red mask at alpha 128


def test_stale_noback_frames_are_cleaned(frames, tmp_path, stub_ffmpeg, monkeypatch):
    """``*.noback.png`` files left by a killed overlay run are removed before
    an ffmpeg render and never read as frames by the OpenCV one."""
    src_dir, pred_dir = frames
    stale = pred_dir / "00000.png.noback.png"
    Image.new("RGBA", (24, 16)).save(stale)
    render.render_side_by_side(pred_dir, src_dir, tmp_path / "a.mp4")
    assert not stale.exists()
    Image.new("RGBA", (24, 16)).save(stale)
    monkeypatch.setenv("SVOS_FFMPEG", "0")
    render.render_prediction_only(pred_dir, tmp_path / "b.mp4")
    assert len(_read_video(tmp_path / "b.mp4")) == 4


def test_no_backend_is_an_error(frames, tmp_path, monkeypatch):
    monkeypatch.setenv("SVOS_FFMPEG", "0")
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    _, pred_dir = frames
    with pytest.raises(RuntimeError, match="ffmpeg binary .* or OpenCV"):
        render.render_prediction_only(pred_dir, tmp_path / "x.mp4")
    assert not (tmp_path / "x.mp4").exists()


def test_average_meter_matches_jax():
    port, ref = AverageMeter(), JAverageMeter()
    for val, n in ((3.0, 1), (1.5, 4), (7, 2)):
        port.update(val, n)
        ref.update(val, n)
        assert (port.val, port.sum, port.count, port.avg) == (ref.val, ref.sum, ref.count, ref.avg)
    port.reset()
    assert (port.val, port.sum, port.count, port.avg) == (0, 0, 0, 0)


def test_visualization_never_imports_jax(frames, tmp_path):
    src_dir, pred_dir = frames
    code = (
        "import os, sys\n"
        "os.environ['SVOS_FFMPEG'] = '0'\n"
        "from semi_supervised_vos_tpu_torch.visualization import cli\n"
        f"cli(['overlay', '-p', {str(pred_dir)!r}, '-s', {str(src_dir)!r}, '-o', {str(tmp_path / 'o.mp4')!r}], "
        "standalone_mode=False)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("clean")
    assert (tmp_path / "o.mp4").exists()
    proc = subprocess.run([sys.executable, "-m", "semi_supervised_vos_tpu_torch.visualization", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and all(c in proc.stdout for c in ("overlay", "side-by-side", "prediction-only"))
