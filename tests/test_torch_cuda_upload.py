"""The engine's frame upload on an NVIDIA Hopper card: host frames go
through pinned staging memory and are copied without a host wait, so
``_upload`` returns while the card still works through what was queued
before it, the caller's array is free to overwrite at once, and a chunk
counts staged bytes and no pageable ones. Every test needs the card and
skips without one; this file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_upload.py
"""

import time

import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from semi_supervised_vos_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

H, W = 480, 854
CHUNK = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90)")
    return torch.device("cuda")


@pytest.fixture
def engine(card):
    torch.manual_seed(0)
    return PropagationEngine(VOSNet("resnet18"), (H, W), EngineConfig(), card)


def _sleep_cycles(ms: float) -> int:
    """``torch.cuda._sleep`` cycles that keep the card busy about ``ms``."""
    n = 10_000_000
    torch.cuda._sleep(n)  # warm
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(n)
    stop.record()
    stop.synchronize()
    return int(n * ms / start.elapsed_time(stop))


def _chunk(rng):
    frames = rng.integers(0, 255, (CHUNK, H, W, 3), dtype=np.uint8)
    frames.flags.writeable = False  # as decoded frames come
    return frames


def test_upload_returns_while_the_card_is_busy(engine):
    """With ~50 ms of work queued ahead, ``_upload`` of a read-only 480p
    chunk returns in under 10 ms and before that work is done; a pageable
    ``.to(device)`` of the same bytes waits for it (so the test can tell)."""
    rng = np.random.default_rng(0)
    frames = _chunk(rng)
    engine._upload(frames)  # the staging block's first allocation
    torch.cuda.synchronize()
    cycles = _sleep_cycles(50.0)

    torch.cuda._sleep(cycles)
    ahead = torch.cuda.Event()
    ahead.record()
    t = time.perf_counter()
    x = engine._upload(frames)
    dt = (time.perf_counter() - t) * 1e3
    still_busy = not ahead.query()
    torch.cuda.synchronize()
    assert dt < 10.0 and still_busy, (dt, still_busy)
    assert torch.equal(x.cpu(), torch.from_numpy(frames.copy()))

    torch.cuda._sleep(cycles)
    t = time.perf_counter()
    torch.from_numpy(frames.copy()).to(engine.device)
    waited = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    print(f"staged upload {dt:.3f} ms, pageable {waited:.3f} ms behind ~50 ms of queued work")
    assert waited > 30.0, waited


def test_source_overwritten_at_once_arrives_intact(engine):
    """The caller's array is overwritten right after ``_upload`` returns,
    while the copy is still queued behind other work: the card gets the
    bytes as they were at the call."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, 255, (CHUNK, H, W, 3), dtype=np.uint8)
    want = torch.from_numpy(src.copy())
    cycles = _sleep_cycles(30.0)
    torch.cuda._sleep(cycles)
    x = engine._upload(src)
    src[...] = 0
    torch.cuda.synchronize()
    assert torch.equal(x.cpu(), want)


def test_twenty_back_to_back_uploads_arrive_intact(engine):
    """Twenty chunks through one source array, each overwritten with the
    next right after its upload, all queued behind work on the card before
    any copy runs: every chunk arrives as it was given (no staging block is
    refilled while its copy is pending)."""
    rng = np.random.default_rng(2)
    src = np.empty((CHUNK, H, W, 3), np.uint8)
    torch.cuda._sleep(_sleep_cycles(100.0))
    got, want = [], []
    for _ in range(20):
        src[...] = rng.integers(0, 255, src.shape, dtype=np.uint8)
        want.append(torch.from_numpy(src.copy()))
        got.append(engine._upload(src))
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a.cpu(), b), k


def test_a_chunk_counts_staged_bytes_and_keeps_its_masks(engine):
    """Over one ``step_chunk_small`` of host frames the counters read the
    chunk's bytes as staged and none pageable; its masks equal those of
    the same chunk handed over already on the card."""
    rng = np.random.default_rng(3)
    frames = _chunk(rng)
    first = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    label = np.zeros((H, W), np.int64)
    label[100:300, 200:500] = 1
    label[350:, 600:] = 2

    state = engine.start_video(first, label)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        masks, _ = engine.step_chunk_small(frames, state, 1)
        torch.cuda.synchronize()
    counters = profiling.summary()["counters"]
    profiling.reset()
    assert counters.get("upload.pageable_bytes", 0) == 0, counters
    assert counters["upload.staged_bytes"] == counters["upload.bytes"] == frames.nbytes, counters

    state = engine.start_video(torch.from_numpy(first).to(engine.device), label)
    on_card, _ = engine.step_chunk_small(torch.from_numpy(frames.copy()).to(engine.device), state, 1)
    assert torch.equal(masks, on_card)
