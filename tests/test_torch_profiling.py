"""The port's recorder of spans and counters (``utils/profiling.py``) on the
CPU: when it records, what a chunk of the engine and a train step record,
the identifiers the mask drain carries, the Chrome trace of ``trace()``
with the drain thread's spans on the trace's time base, the idle summary,
the cap on single spans and the ``SVOS_PROFILE`` report."""

import json
import logging
import threading

import numpy as np
import pytest
import torch

from semi_supervised_vos_tpu_torch.infer import batched
from semi_supervised_vos_tpu_torch.infer.drain import MaskDrain
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize_host
from semi_supervised_vos_tpu_torch.utils import profiling

H = W = 32
CHUNK = 3


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    return PropagationEngine(VOSNet("resnet18"), (H, W), EngineConfig(ref_num=3, frame_range=4), "cpu")


def _video(n=1 + 2 * CHUNK):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (n, H, W, 3), dtype=np.uint8)
    label = np.zeros((H, W), np.int64)
    label[:, : W // 2] = 1
    return frames, label


def _run_video(engine, drain):
    """Start a video and step it in two chunks, each chunk's masks upsampled
    on the drain; returns the masks."""
    frames, label = _video()
    state = engine.start_video(frames[0], label)
    for c in range(2):
        masks, state = engine.step_chunk_small(frames[1 + CHUNK * c: 1 + CHUNK * (c + 1)], state, 1 + CHUNK * c)
        drain.submit(lambda m=masks: nearest_resize_host(m.numpy(), (2 * H, 2 * W), hw_axes=(1, 2)))
    return drain.drain()


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_the_profiler_flag_is_the_installed_torchs():
    """Recording follows ``torch.autograd.profiler._is_profiler_enabled``,
    which the installed torch sets while a ``torch.profiler`` session runs
    and clears after it."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False and not profiling.recording()
    with _profiler():
        assert flag() is True and profiling.recording()
    assert flag() is False and not profiling.recording()


def test_spans_off_record_nothing_and_never_enter_record_function(engine, monkeypatch):
    """Off, a span is one shared object that does nothing: no
    ``record_function``, no record; counters stay empty; the engine's masks
    are the same as when recording."""

    def refuse(*a, **k):
        raise AssertionError("entered while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_range", refuse)
    assert profiling.span("a") is profiling.span("b", device=torch.device("cpu"), new_id=True)
    with profiling.span("a"):
        profiling.count("c", 5)
    drain = MaskDrain()
    try:
        off = _run_video(engine, drain)
    finally:
        drain.close()
    assert profiling.summary() == {"spans": {}, "counters": {}, "kept": 0, "dropped": 0}
    assert profiling.records() == []
    monkeypatch.undo()
    drain = MaskDrain()
    try:
        with _profiler():
            on = _run_video(engine, drain)
    finally:
        drain.close()
    assert all((a == b).all() for a, b in zip(off, on))


def test_an_engine_chunk_records_its_spans(engine):
    """Inside ``torch.profiler.profile()``: one ``engine.step`` a chunk with
    its ``engine.upload``, ``engine.encode`` and N ``engine.propagate`` and
    ``engine.write``, all children of it; self time is the step less its
    children; the drain's spans carry the chunk's identifier; each span is
    also a ``svos.*`` range of the profiler."""
    drain = MaskDrain()
    try:
        with _profiler() as prof:
            _run_video(engine, drain)
    finally:
        drain.close()
    s = profiling.summary()
    spans = s["spans"]
    assert spans["engine.step"]["count"] == 2 and spans["engine.start"]["count"] == 1
    inside = {name: spans[name]["within"].get("engine.step", {}).get("count")
              for name in ("engine.upload", "engine.encode", "engine.propagate", "engine.write")}
    assert inside == {"engine.upload": 2, "engine.encode": 2, "engine.propagate": 2 * CHUNK,
                      "engine.write": 2 * CHUNK}
    assert spans["engine.upload"]["count"] == 3  # the start's too
    assert all(r["device_s"] is None for r in spans.values())
    children = sum(spans[n]["within"]["engine.step"]["host_s"] for n in inside)
    step = spans["engine.step"]
    assert step["self_s"] == pytest.approx(step["host_s"] - children, abs=1e-8)
    assert 0 < step["self_s"] < step["host_s"]
    assert s["counters"] == {"upload.calls": 3, "upload.bytes": (1 + 2 * CHUNK) * H * W * 3,
                             "upload.pageable_bytes": (1 + 2 * CHUNK) * H * W * 3, "engine.frames": 2 * CHUNK}

    recs = profiling.records()
    main = threading.get_native_id()
    steps = [r for r in recs if r["name"] == "engine.step"]
    assert len({r["id"] for r in steps}) == 2
    for st in steps:
        mine = [r for r in recs if r["id"] == st["id"] and r is not st]
        on_main = [r for r in mine if r["thread"] == main]
        assert all(r["parent"] == "engine.step" and st["start_ns"] <= r["start_ns"] <= r["stop_ns"] <= st["stop_ns"]
                   for r in on_main)
        assert sorted(r["name"] for r in on_main) == sorted(
            ["engine.upload", "engine.encode"] + ["engine.propagate", "engine.write"] * CHUNK)
        drained = {r["name"]: r for r in mine if r["thread"] != main}
        assert set(drained) == {"drain.queue", "drain.job", "drain.upsample"}
        assert drained["drain.upsample"]["parent"] == "drain.job"
        assert st["stop_ns"] <= drained["drain.queue"]["start_ns"] <= drained["drain.queue"]["stop_ns"] \
            <= drained["drain.job"]["start_ns"]
    names = {e.name for e in prof.events()}
    assert {"svos.engine.step", "svos.engine.upload", "svos.engine.encode", "svos.engine.propagate",
            "svos.engine.write", "svos.engine.start"} <= names


def test_trace_writes_the_drain_threads_spans(engine, tmp_path):
    """``trace()`` adds the spans of the drain's worker, which the profiler
    does not see, to the Chrome trace on its own thread's row and inside
    the trace's window; the main thread's spans are there as the
    profiler's own ranges. No card here: no idle summary."""
    drain = MaskDrain()
    try:
        with profiling.trace(str(tmp_path)) as out:
            _run_video(engine, drain)
    finally:
        drain.close()
    assert out["idle"] is None and out["spans_added"] == 6
    events = json.loads(out["path"].read_text())["traceEvents"]
    own = [e for e in events if e.get("ph") == "X" and e.get("cat") != "svos_span"]
    lo, hi = min(e["ts"] for e in own), max(e["ts"] + e["dur"] for e in own)
    added = [e for e in events if e.get("cat") == "svos_span"]
    assert sorted(e["name"] for e in added) == sorted(["svos.drain.queue", "svos.drain.job", "svos.drain.upsample"] * 2)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in added)
    assert threading.get_native_id() not in {e["tid"] for e in added}
    # each job starts after its chunk's step has ended on the main thread
    steps = sorted(e["ts"] + e["dur"] for e in events
                   if e.get("cat") in profiling.HOST_CATS and e["name"] == "svos.engine.step")
    jobs = sorted(e["ts"] for e in added if e["name"] == "svos.drain.job")
    assert len(steps) == 2 and all(a <= b for a, b in zip(steps, jobs))


def test_idle_summary_names_each_gap_by_the_innermost_span():
    """Idle share from the first step span (the first device op without
    one) to the last device op, the set-up before it left out, and the
    gaps longest first, each named by the latest-started span open at its
    start on any thread, else ``host.other``."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 20.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 35.0, "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "name": "svos.engine.step", "ts": 5.0, "dur": 20.0, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "svos.engine.upload", "ts": 8.0, "dur": 10.0, "tid": 1},
        {"ph": "X", "cat": "svos_span", "name": "svos.drain.job", "ts": 6.0, "dur": 2.0, "tid": 2},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "svos.engine.step", "ts": 30.0, "dur": 9.0},
    ]
    idle = profiling.idle_summary(events)
    assert idle["idle_share"] == pytest.approx(15 / 35)
    assert idle["window_s"] == pytest.approx(35e-6) and idle["setup_s"] == pytest.approx(5e-6)
    assert idle["gaps_ms"] == [("engine.upload", pytest.approx(0.01)), ("host.other", pytest.approx(0.005))]
    no_step = events[:3] + events[4:]
    idle = profiling.idle_summary(no_step)
    assert idle["idle_share"] == pytest.approx(15 / 40)
    assert idle["window_s"] == pytest.approx(40e-6) and idle["setup_s"] == 0.0
    assert idle["gaps_ms"] == [("engine.upload", pytest.approx(0.01)), ("host.other", pytest.approx(0.005))]
    assert profiling.idle_summary(events[3:6]) is None


def test_a_train_step_records_its_four_parts():
    """A CPU train step: ``train.step`` holding ``train.forward``,
    ``train.loss``, ``train.backward`` and ``train.optimizer`` once each,
    device seconds None (no card); no gradient is left after the step."""
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec, make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    torch.manual_seed(0)
    net = VOSNet("resnet18").train()
    step = make_train_step(net, LossSpec(), make_optimizer(net.parameters()))
    rng = np.random.default_rng(1)
    imgs = torch.as_tensor(rng.integers(0, 255, (1, 3, H, W, 3), dtype=np.uint8))
    anns = torch.zeros((1, 3, H, W, 3), dtype=torch.uint8)
    anns[..., : W // 2, 0] = 128
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32)
    with _profiler():
        loss = step(imgs, anns, centroids, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    spans = profiling.summary()["spans"]
    parts = ("train.forward", "train.loss", "train.backward", "train.optimizer")
    assert {n: spans[n]["count"] for n in ("train.step",) + parts} == dict.fromkeys(("train.step",) + parts, 1)
    assert all(spans[n]["within"]["train.step"]["count"] == 1 for n in parts)
    assert all(spans[n]["device_s"] is None for n in ("train.step",) + parts)
    ids = {r["id"] for r in profiling.records()}
    assert len(ids) == 1
    assert all(p.grad is None for p in net.parameters())


def test_svos_profile_records_a_run_and_logs_one_report(monkeypatch):
    """``profiled_run`` under ``SVOS_PROFILE=1``: recording on for the
    block, off after, and one ``phase timing`` line of spans and counters;
    without the variable nothing records."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logging.getLogger("svos_torch").addHandler(handler)
    try:
        monkeypatch.delenv("SVOS_PROFILE", raising=False)
        monkeypatch.delenv("SVOS_TRACE_DIR", raising=False)
        with profiling.profiled_run():
            assert not profiling.recording()
        monkeypatch.setenv("SVOS_PROFILE", "1")
        with profiling.profiled_run():
            assert profiling.recording()
            for _ in range(2):
                with profiling.span("engine.step"):
                    profiling.count("upload.bytes", 3)
        assert not profiling.recording()
    finally:
        logging.getLogger("svos_torch").removeHandler(handler)
    report = [r for r in records if r.startswith("phase timing | ")]
    assert len(report) == 1
    assert "engine.step: " in report[0] and "(2x, " in report[0] and "upload.bytes: 6" in report[0]


def test_single_spans_are_capped_and_totals_are_not(monkeypatch):
    """Past ``MAX_SPANS`` single spans are dropped, and counted; the totals
    keep every span."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    monkeypatch.setattr(profiling, "_forced", True)
    for _ in range(5):
        with profiling.span("x"):
            pass
    s = profiling.summary()
    assert s["spans"]["x"]["count"] == 5 and s["kept"] == 3 and s["dropped"] == 2
    assert len(profiling.records()) == 3


def test_lockstep_runner_counts_useful_and_computed_lane_steps(monkeypatch):
    """``_run_group`` counts each chunk's computed steps of every video
    (``lockstep.lane_steps``) and the real ones (``lockstep.real_lane_steps``),
    and hands each mask to the writers under the chunk's identifier."""
    monkeypatch.setenv("SVOS_CHUNK", "4")
    monkeypatch.setattr(profiling, "_forced", True)
    lengths = [7, 3]
    seen = []

    def step(batch, t, n):
        with profiling.span("engine.step", new_id=True):
            pass
        return lambda: np.zeros((n, 2, 1, 1), np.uint8)

    batched._run_group(["a", "b"], lengths, lambda t: np.zeros(1), lambda first: None, step,
                       lambda v, t, m: seen.append((v, t, profiling.current_id())), None)
    counters = profiling.summary()["counters"]
    # steps 1..6 in chunks of 4 and 2, each padded to 4 rows
    assert counters == {"lockstep.lane_steps": 2 * 4 * 2, "lockstep.real_lane_steps": 6 + 2}
    ids = {r["id"]: r["start_ns"] for r in profiling.records() if r["name"] == "engine.step"}
    assert sorted({i for _, t, i in seen if t <= 4}) == [min(ids)]
    assert sorted({i for _, t, i in seen if t > 4}) == [max(ids)]
    assert len(seen) == 6 + 2


def test_threads_lose_no_span_or_count(monkeypatch):
    """More threads than cores recording at once, with the interpreter
    switching threads as often as it can: every span and every count is
    kept, and each thread's spans carry its own identifier."""
    import os
    import sys

    monkeypatch.setattr(profiling, "_forced", True)
    n_threads, reps = 2 * (os.cpu_count() or 2) + 2, 300
    ids = {}

    def work(k):
        with profiling.span("outer", new_id=True):
            ids[k] = profiling.current_id()
            for _ in range(reps):
                with profiling.span("inner"):
                    profiling.count("hits")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = profiling.summary()
    assert s["counters"] == {"hits": n_threads * reps}
    assert s["spans"]["inner"]["count"] == n_threads * reps == s["spans"]["inner"]["within"]["outer"]["count"]
    assert s["spans"]["outer"]["count"] == n_threads and len(set(ids.values())) == n_threads
    recs = profiling.records()
    outer = {r["thread"]: r["id"] for r in recs if r["name"] == "outer"}
    assert all(r["id"] == outer[r["thread"]] for r in recs if r["name"] == "inner")
