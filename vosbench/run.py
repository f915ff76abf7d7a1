"""Run one cell of the benchmark once.

    python3 -m vosbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``. The cell is looked
up by name there; its configuration file, its traffic file
(``vosbench/traffic/<traffic>.json``, whose ``driver`` key names a module of
``vosbench/drivers/``), its limits (``vosbench/limits/<workload>.json``) and
each per-layer metric's reader (``vosbench/metrics/<metric>.py``) are found
by name, so a new cell, configuration, traffic mix or metric is new files
and entries.

The run makes its inputs and weights from the seed, sets the program up and
warms every shape (``setup_s``), measures for ``--seconds``, judges the
window's outputs against the plain reference, and prints the numbers
compared, each beside its limit, as the last lines of standard error, then
one JSON line as the last line of standard output. It exits 2 without the
cards the cell asks for, and 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "semi_supervised_vos_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_dirs(root: Path) -> Dict[str, str]:
    """Fixed directories inside the checkout for every build and kernel
    cache (the program builds its own kernels into ``build/kernels`` and
    ``build/host`` beside its package)."""
    return {"TORCH_EXTENSIONS_DIR": str(root / "build" / "torch_extensions"),
            "TRITON_CACHE_DIR": str(root / "build" / "triton")}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(root: Path, workload: str) -> dict:
    """The cell named ``workload`` of ``root/BENCHMARK.json`` with every
    file it names: workload, config, traffic, limits, end_to_end and
    per_layer (the metric entries that this cell reports)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reports(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    limits_path = root / "vosbench" / "limits" / f"{workload}.json"
    return {
        "bench": bench,
        "workload": cell,
        "config": json.loads((root / config_entry["file"]).read_text()),
        "traffic": json.loads((root / "vosbench" / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(limits_path.read_text()) if limits_path.exists() else {},
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def quantity_of(name: str, known) -> Optional[str]:
    """What a metric named ``name`` reports: ``name`` itself if ``known``, or
    else, for ``<quantity>.<qualifier>``, that of the name before its last
    dot. One quantity is split so over cells that need their own bound or
    move their own end-to-end metric, without new code."""
    while name:
        if known(name):
            return name
        name = name.rpartition(".")[0]
    return None


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not load, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def checks_of(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the cell's limits name, beside its limit; a limit with no
    reading fails."""
    return {name: {"value": readings.get(name), "limit": limit} for name, limit in sorted(limits.items())}


def correct_of(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(
        c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())


def device_record(torch, device, chips: int, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": int(peak)}


def power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None, root: Optional[Path] = None, device: Optional[str] = None) -> int:
    """Run the cell; ``device`` (the tests' "cpu") skips the look for cards.
    Returns the exit code."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(root) if root is not None else HERE.parent
    cell = resolve(root, args.workload)
    for key, value in cache_dirs(root).items():
        os.environ.setdefault(key, value)

    import torch

    if device is None:
        chips = cell["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"{args.workload} needs {chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda:0"
        log(f"card: {power_limit()}")
    from vosbench.harness import Context

    print(f"setup: torch imported at {time.perf_counter() - T_PROCESS:.3f} s", file=sys.stderr, flush=True)

    driver = load_module(root / "vosbench" / "drivers" / f"{cell['traffic']['driver']}.py",
                         f"vosbench_driver_{cell['traffic']['driver']}")
    ctx = Context(workload=args.workload, config=cell["config"], traffic=cell["traffic"],
                  seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=torch.device(device),
                  t_process=T_PROCESS)
    outcome = driver.run(ctx)
    setup_s = ctx.t_window - T_PROCESS

    bad = forbidden_modules()
    if bad:
        log(f"loaded in the measuring process: {', '.join(bad)}")
        return 3

    metrics: Dict[str, dict] = {}
    if not args.trace:
        values = dict(outcome.metrics, setup_s=(setup_s, "s"))
        for m in cell["end_to_end"]:
            q = quantity_of(m["name"], values.__contains__)
            if q is not None:
                v, unit = values[q]
                metrics[m["name"]] = dict({"value": v, "unit": unit}, **outcome.extra.get(q, {}))
    else:
        readers = root / "vosbench" / "metrics"
        for m in cell["per_layer"]:
            q = quantity_of(m["name"], lambda n: (readers / f"{n}.py").exists()) or m["name"]
            reader = load_module(readers / f"{q}.py", "vosbench_metric_" + q.replace(".", "_").replace("-", "_"))
            value = reader.read(outcome.slice) if outcome.slice is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = checks_of(outcome.readings, cell["limits"])
    correct = correct_of(checks) and outcome.failed == 0
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
            "device": device_record(torch, device, cell["workload"]["chips"], outcome.memory_peak_bytes)}
    if args.trace and outcome.slice is not None:
        s = outcome.slice
        line["device"].update({"busy_s": s.busy_s, "window_s": s.window_s})
        line["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(s.kernels.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in s.gaps[:10]]}
    detail = dict(outcome.extra.get("detail", {}), **{k: v for k, v in outcome.readings.items() if k not in checks})
    if detail:
        log(f"detail: {json.dumps(detail)}")
    if ctx.host:
        log(f"host: {json.dumps(ctx.host)}")
    line["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
