"""Shared set-up of the benchmark's own tests (``python3 -m pytest
vosbench/tests``): the checkout's root on the import path, a tiny copy of
the benchmark whose cells run on the CPU through the port's plain paths,
and the ``cuda`` marker's skip, decided inside a fixture."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the benchmark's configuration files, by name
CONFIGS = sorted(p.stem for p in (ROOT / "vosbench" / "configs").glob("*.json"))


def config_of(name: str):
    """(the configuration file ``name``, its network family's module)."""
    from vosbench import networks

    cfg = json.loads((ROOT / "vosbench" / "configs" / f"{name}.json").read_text())
    return cfg, networks.of(cfg)


# tiny cells: each stands for the named cell, with its limits
TINY = {
    "t-single": ("resnet50", "r50-480p-single", {"driver": "infer_stream", "hw": [64, 96], "video_batch": 1,
                                                 "chunk": 4, "in_flight": 2, "pool": 2, "lengths": [10, 14],
                                                 "objects": 2, "judge": {"videos": 2, "frames": 3}}),
    "t-lock": ("facebook", "fb-480p-vb8", {"driver": "infer_stream", "hw": [64, 96], "video_batch": 2, "chunk": 4,
                                            "in_flight": 2, "pool": 2, "lengths": [10, 14], "objects": 2,
                                            "judge": {"videos": 2, "frames": 3}}),
    "t-train": ("resnet50", "r50-train-256", {"driver": "train_step", "bs": 2, "frames": 4, "crop": 64, "ring": 4,
                                               "objects": 2}),
}


def make_tiny_root(dest: Path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``vosbench/``) with the
    tiny cells added as data files and entries."""
    shutil.copytree(ROOT / "vosbench", dest / "vosbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (config, like, traffic) in TINY.items():
        (dest / "vosbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        shutil.copy(ROOT / "vosbench" / "limits" / f"{like}.json", dest / "vosbench" / "limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": config, "traffic": name, "chips": 1, "why": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import torch

    torch.set_num_threads(2)
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def run_cell(root: Path, workload: str, capsys, seed: int = 4294967311, seconds: float = 2.0, trace: int = 0) -> dict:
    """One run of ``workload`` on the CPU → its result line."""
    from vosbench import run

    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                  root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")
