"""The engine's frame and label uploads on a CPU engine: the frames stay
where they are, nothing is pinned or staged, and the masks are those of a
plain ``from_numpy`` upload; on an engine that stands for a card (plain
memory standing in for pinned), host frames and labels take the staged
route and count as staged, never as pageable. The card's own checks are
``tests/test_torch_cuda_upload.py``."""

import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu_torch.infer import engine as engine_mod
from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from semi_supervised_vos_tpu_torch.utils import profiling

H, W = 32, 48
CFG = EngineConfig(ref_num=3, frame_range=4)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def net():
    torch.manual_seed(0)
    return VOSNet("resnet18")


def _frames(n, seed=0):
    frames = np.random.default_rng(seed).integers(0, 255, (n, H, W, 3), dtype=np.uint8)
    frames.flags.writeable = False  # as decoded frames come
    return frames


def _label():
    label = np.zeros((H, W), np.int32)
    label[:, : W // 2] = 1
    label[20:, 30:] = 2
    return label


def _recorded(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.summary()["counters"]


def _refuse_staging(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU engine staged an upload")

    monkeypatch.setattr(engine_mod, "_staged", refuse)


def test_cpu_upload_keeps_the_frames_and_pins_nothing(net, monkeypatch):
    """A read-only numpy chunk and a CPU tensor come back equal to their
    source, unpinned; the tensor is the caller's own, not a copy."""
    _refuse_staging(monkeypatch)
    engine = PropagationEngine(net, (H, W), CFG, "cpu")
    frames = _frames(4)
    x, counters = _recorded(lambda: engine._upload(frames))
    assert x.dtype == torch.uint8 and x.device.type == "cpu" and not x.is_pinned()
    np.testing.assert_array_equal(x.numpy(), frames)
    assert counters == {"upload.calls": 1, "upload.bytes": frames.nbytes, "upload.pageable_bytes": frames.nbytes}
    t = torch.from_numpy(frames.copy())
    y = engine._upload(t)
    assert y.data_ptr() == t.data_ptr() and not y.is_pinned()
    assert torch.equal(y, t)
    label = engine._upload_labels(_label())
    assert label.dtype == torch.int64 and not label.is_pinned()
    np.testing.assert_array_equal(label.numpy(), _label())
    with pytest.raises(TypeError, match="uint8"):
        engine._upload(t.float())


def test_cpu_masks_equal_the_plain_upload(net, monkeypatch):
    """``step_chunk_small``'s masks and the bank equal those of an engine
    whose upload is a plain ``from_numpy`` of a writable copy (the path
    before staging), bit for bit, over two chunks; no staged bytes count."""
    _refuse_staging(monkeypatch)
    frames, label = _frames(7, seed=1), _label()

    def run(engine):
        state = engine.start_video(frames[0], label)
        out = []
        for start in (1, 4):
            masks, state = engine.step_chunk_small(frames[start: start + 3], state, start)
            out.append(masks.clone())
        return out, state

    plain = PropagationEngine(net, (H, W), CFG, "cpu")
    plain._upload = lambda f: torch.from_numpy(np.array(f, np.uint8))
    want, want_state = run(plain)
    (got, state), counters = _recorded(lambda: run(PropagationEngine(net, (H, W), CFG, "cpu")))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(state.feats, want_state.feats) and torch.equal(state.labels, want_state.labels)
    assert len(torch.unique(torch.cat(got))) > 1  # not a comparison of constant masks
    assert "upload.staged_bytes" not in counters
    assert counters["upload.pageable_bytes"] == counters["upload.bytes"] == frames.nbytes


@pytest.mark.parametrize("kind", ["numpy", "read-only numpy", "tensor"])
def test_card_route_stages_host_frames_and_counts_them(net, monkeypatch, kind):
    """An engine that stands for a card (``on_card`` set; ``torch.empty``
    records that pinned memory was asked for and hands out plain memory,
    which this CPU build has no other kind of): host frames, a numpy array,
    read-only or not, or an unpinned CPU tensor, and the first label (int32
    here) go through ``_staged`` into fresh pinned blocks as uint8 and
    int64, equal to their source and no longer tied to it; the counters
    read staged bytes and no pageable ones."""
    pinned = []
    empty = torch.empty

    def pinning_empty(*a, pin_memory=False, **k):
        pinned.append(pin_memory)
        return empty(*a, **k)

    engine = PropagationEngine(net, (H, W), CFG, "cpu")
    engine.on_card = True
    monkeypatch.setattr(torch, "empty", pinning_empty)
    frames = _frames(3)
    src = {"numpy": frames.copy(), "read-only numpy": frames, "tensor": torch.from_numpy(frames.copy())}[kind]
    x, counters = _recorded(lambda: engine._upload(src))
    assert x.dtype == torch.uint8 and pinned == [True]
    np.testing.assert_array_equal(x.numpy(), frames)
    if kind != "read-only numpy":
        src[...] = 0  # the caller's array is free on return
        np.testing.assert_array_equal(x.numpy(), frames)
    assert counters == {"upload.calls": 1, "upload.bytes": frames.nbytes, "upload.staged_bytes": frames.nbytes}
    label = engine._upload_labels(_label())
    assert pinned == [True, True] and label.dtype == torch.int64
    np.testing.assert_array_equal(label.numpy(), _label())


def test_lockstep_start_uploads_labels_through_the_engine(net, monkeypatch):
    """``start_videos`` takes its labels through ``_upload_labels`` as
    ``start_video`` does: on the CPU the int64 annotations as given."""
    seen = []
    real = PropagationEngine._upload_labels

    def spy(self, labels):
        seen.append(np.shape(labels))
        return real(self, labels)

    monkeypatch.setattr(PropagationEngine, "_upload_labels", spy)
    _refuse_staging(monkeypatch)
    engine = BatchedPropagationEngine(net, (H, W), 2, CFG, "cpu")
    labels = np.stack([_label(), _label()[:, ::-1]])
    state = engine.start_videos(np.stack([_frames(1)[0], _frames(1, seed=2)[0]]), labels)
    assert seen == [(2, H, W)]
    assert state.labels.shape[1] == 2 and not torch.equal(state.labels[0, 0], state.labels[0, 1])
