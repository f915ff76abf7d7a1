"""What the port's recorder (``utils/profiling.py``) costs and what it shows
on the card.

    python3 prof_torch/recorder_cost.py [cell,cell,...]

(1) Host ns per ``with span(...)`` and per ``count(...)`` with recording
off, on under ``SVOS_PROFILE`` (no profiler) and on under
``torch.profiler`` (each span also a ``record_function`` range), a
``contextlib.nullcontext()`` loop beside them. (2) ``inference`` through
the CLI on ``chip_smoke.py``'s 480p main-path tree (videos of 56 and 9
frames, calibrated random resnet50), once plain and once under
``SVOS_PROFILE=1`` and ``SVOS_TRACE_DIR``: the frames a second of both,
the recorder's report and the card's idle share with its ten longest idle
gaps, each named by span. (3) The benchmark's inference cells named
(default ``r50-480p-single``) in this process, each traced, the single
cell first untraced too, plain and with the recorder forced on as under
``SVOS_PROFILE`` (no profiler): the traced line's metrics, the host ms a
chunk of each span inside ``engine.step`` and each counter a chunk, and
the frames a second the engine was stepped at inside the traced slice
(counter ``engine.frames`` over the first to the last ``engine.step``)
beside the untraced ``frames_per_s``; the forced run gives the same split
of a chunk off the profiler, over its chunks after the first fifth.
Prints a line per part and a JSON line last. Needs one NVIDIA card.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOOPS = 200_000


def per_call_ns(fn, loops: int = LOOPS) -> float:
    """Best of three: ns per call of ``fn`` over ``loops`` calls."""
    best = None
    for _ in range(3):
        t0 = time.perf_counter_ns()
        fn(loops)
        ns = (time.perf_counter_ns() - t0) / loops
        best = ns if best is None else min(best, ns)
    return best


def span_costs(torch) -> dict:
    from semi_supervised_vos_tpu_torch.utils import profiling

    def spans(n):
        for _ in range(n):
            with profiling.span("engine.write"):
                pass

    def counts(n):
        for _ in range(n):
            profiling.count("upload.calls")

    def null(n):
        for _ in range(n):
            with contextlib.nullcontext():
                pass

    out = {"nullcontext": per_call_ns(null), "span_off": per_call_ns(spans), "count_off": per_call_ns(counts)}
    profiling.reset()
    profiling._forced = True
    try:
        out["span_on"] = per_call_ns(spans)
        out["count_on"] = per_call_ns(counts)
    finally:
        profiling._forced = False
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["span_on_profiler"] = per_call_ns(spans, LOOPS // 10)
    profiling.reset()
    return out


def cli_runs(torch, work: Path) -> dict:
    import chip_smoke as cs
    from semi_supervised_vos_tpu_torch.models.convert import save_torch_checkpoint

    videos = {"long": 56, "short": 9}
    cs.make_davis_tree(work / "davis", videos, (cs.H480, cs.W480), seed=1)
    frames, _ = cs.load_video(work, "davis", "long", 4)
    ckpt = work / "resnet50.pth.tar"
    save_torch_checkpoint(cs.calibrated_vosnet(torch, torch.device("cuda"), 0, frames), ckpt)
    args = ["inference", "-d", str(work / "davis"), "-r", str(ckpt)]
    n = sum(videos.values())
    cs.cli_run(torch, args + ["-s", str(work / "warm")])  # kernels built, shapes warmed
    plain, _ = cs.cli_run(torch, args + ["-s", str(work / "plain")])
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logging.getLogger("svos_torch").addHandler(handler)
    try:
        with cs.infer_dtype("bfloat16", SVOS_PROFILE="1", SVOS_TRACE_DIR=str(work / "trace")):
            traced, _ = cs.cli_run(torch, args + ["-s", str(work / "traced")])
    finally:
        logging.getLogger("svos_torch").removeHandler(handler)
    report = next((r for r in records if r.startswith("phase timing |")), None)
    idle = next((r for r in records if r.startswith("device idle ")), None)
    return {"frames": n, "plain_fps": n / plain, "traced_fps": n / traced, "report": report, "idle": idle}


def per_chunk(summary: dict) -> dict:
    """Host ms a chunk of each span inside ``engine.step`` (and the step's
    own and self ms), and each counter a chunk."""
    spans, steps = summary["spans"], summary["spans"]["engine.step"]["count"]
    out = {"engine.step": spans["engine.step"]["host_s"] / steps * 1e3,
           "engine.step self": spans["engine.step"]["self_s"] / steps * 1e3}
    for name, r in spans.items():
        inside = r["within"].get("engine.step")
        if inside:
            out[name] = inside["host_s"] / steps * 1e3
    for name in ("drain.queue", "drain.job", "drain.upsample"):
        if name in spans:
            out[name] = spans[name]["host_s"] / spans[name]["count"] * 1e3
    out.update({f"{k} a chunk": v / steps for k, v in summary["counters"].items()})
    return out


def per_chunk_kept(summary: dict, records: list, skip: float = 0.2) -> dict:
    """:func:`per_chunk` from the single spans kept, over the
    ``engine.step`` spans after the first ``skip`` of them: a run recorded
    from its start, its warm-up and first chunks left out. Adds
    ``host_ms_per_frame``, the step less its upload over the frames a step."""
    steps = sorted((r for r in records if r["name"] == "engine.step"), key=lambda r: r["start_ns"])
    steps = steps[int(len(steps) * skip):]
    ids, n = {r["id"] for r in steps}, len(steps)
    main = {r["thread"] for r in steps}
    ms = defaultdict(float)
    jobs = defaultdict(int)
    for r in records:
        if r["id"] in ids:
            ms[r["name"]] += (r["stop_ns"] - r["start_ns"]) / 1e6
            jobs[r["name"]] += 1
    out = {name: v / n for name, v in ms.items() if name.startswith("engine.")}
    out["engine.step self"] = out["engine.step"] - sum(v for k, v in out.items() if k != "engine.step")
    out.update({name: ms[name] / jobs[name] for name in ("drain.queue", "drain.job", "drain.upsample") if jobs[name]})
    frames = summary["counters"].get("engine.frames", 0) / summary["spans"]["engine.step"]["count"]
    out["host_ms_per_frame"] = (out["engine.step"] - out.get("engine.upload", 0.0)) / frames
    out["chunks"], out["threads"] = n, len(main)
    return out


def bench_cells(cells) -> dict:
    """Each cell run in this process; ``r50-480p-single`` untraced first,
    plain and with the recorder forced on (same seed), then every cell
    traced: its line's metrics, its chunks' spans, and in the single cell
    the frames a second stepped inside the slice."""
    from semi_supervised_vos_tpu_torch.utils import profiling
    from vosbench import run

    out = {}
    runs = [("r50-480p-single", 0, False), ("r50-480p-single", 0, True)] if "r50-480p-single" in cells else []
    for cell, trace, forced in runs + [(c, 1, False) for c in cells]:
        profiling.reset()
        profiling._forced = forced
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = run.main(["--workload", cell, "--seed", str(3_000_000_017 + trace), "--seconds", "30",
                               "--trace", str(trace)], root=ROOT)
        finally:
            profiling._forced = False
        line = json.loads(buf.getvalue().strip().splitlines()[-1]) if rc == 0 else {}
        res = out.setdefault(cell, {})
        key = "trace0_recorder" if forced else f"trace{trace}"
        res[key] = {k: v["value"] for k, v in line.get("metrics", {}).items()}
        if forced:
            res["untraced_per_chunk_ms"] = per_chunk_kept(profiling.summary(), profiling.records())
            res["untraced_dropped"] = profiling.summary()["dropped"]
        if trace:
            res["busy_s"], res["window_s"] = line["device"].get("busy_s"), line["device"].get("window_s")
            res["breakdown"] = line.get("breakdown")
            summary = profiling.summary()
            res["per_chunk_ms"] = per_chunk(summary)
            steps = [r for r in profiling.records() if r["name"] == "engine.step"]
            span = (max(r["stop_ns"] for r in steps) - min(r["start_ns"] for r in steps)) / 1e9
            res["slice_frames_per_s"] = summary["counters"].get("engine.frames", 0) / span
        print(f"{cell} trace {trace}{' recorder' if forced else ''}: {json.dumps(res)}", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    os.environ.setdefault("SVOS_ZOO", "0")
    card = cs.card_line()
    costs = span_costs(torch)
    print("ns per call: " + ", ".join(f"{k} {v:.1f}" for k, v in costs.items()), flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cli = cli_runs(torch, Path(tmp))
    print(f"CLI 480p main path: {cli['plain_fps']:.3f} frames/s plain, {cli['traced_fps']:.3f} traced", flush=True)
    print(cli["report"], flush=True)
    print(cli["idle"], flush=True)
    bench = bench_cells(sys.argv[1].split(",") if len(sys.argv) > 1 else ["r50-480p-single"])
    print(card)
    print(json.dumps({"span_ns": costs, "cli": cli, "bench": bench, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
