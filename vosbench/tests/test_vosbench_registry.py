"""A configuration, a network family, a traffic mix, a cell and a per-layer
metric are found by name when they are added as new files and entries,
with no edit to a file that is there; a configuration that names no family
or lacks a key fails before set-up, naming the problem."""

import json
import re
import shutil

import pytest

from conftest import ROOT, make_tiny_root, run_cell


def files_under_vosbench(root):
    return {p.relative_to(root): p.read_bytes() for p in (root / "vosbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def assert_unchanged(root, before):
    """No file that was under ``vosbench/`` changed or went away."""
    after = files_under_vosbench(root)
    assert {k: after.get(k) for k in before} == before


def add_config_cell(root, cfg: dict, name: str, like: str = "t-single") -> None:
    """``cfg`` as ``vosbench/configs/<name>.json`` and a cell ``t-<name>``
    with the traffic, limits and metrics of the tiny cell ``like``: new
    files and entries only."""
    (root / "vosbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    shutil.copy(root / "vosbench" / "limits" / f"{like}.json", root / "vosbench" / "limits" / f"t-{name}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "https://arxiv.org/abs/1512.03385",
                             "file": f"vosbench/configs/{name}.json", "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": f"t-{name}", "config": name, "traffic": like, "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(f"t-{name}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def resnet50_config() -> dict:
    return json.loads((ROOT / "vosbench" / "configs" / "resnet50.json").read_text())


def test_new_files_and_entries_are_found(tmp_path, capsys):
    root = make_tiny_root(tmp_path)
    before = files_under_vosbench(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = resnet50_config()
    (root / "vosbench" / "configs" / "resnet50-copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "vosbench" / "traffic" / "t-single.json").read_text())
    traffic["lengths"] = [9, 11]
    (root / "vosbench" / "traffic" / "t-short.json").write_text(json.dumps(traffic))
    shutil.copy(root / "vosbench" / "limits" / "t-single.json", root / "vosbench" / "limits" / "t-new.json")
    (root / "vosbench" / "metrics" / "chunks_in_slice.py").write_text(
        "def read(s):\n    return float(s.count.get('dispatch', 0)) or None\n")
    bench["configs"].append({"name": "resnet50-copy", "source": "https://arxiv.org/abs/2004.07193",
                             "file": "vosbench/configs/resnet50-copy.json", "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "t-new", "config": "resnet50-copy", "traffic": "t-short", "chips": 1,
                               "why": "new"})
    bench["per_layer"].append({"name": "chunks_in_slice", "unit": "chunks", "better": "higher",
                               "source": "program_span", "layer": "loop", "moves": "frames_per_s",
                               "workloads": ["t-new"]})
    for m in bench["end_to_end"]:
        if "t-single" in m.get("workloads", []):
            m["workloads"].append("t-new")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    from vosbench import run

    cell = run.resolve(root, "t-new")
    assert cell["traffic"]["lengths"] == [9, 11] and cell["config"]["model"] == "resnet50"
    assert [m["name"] for m in cell["per_layer"]] == ["chunks_in_slice"]
    line = run_cell(root, "t-new", capsys, seconds=4.0, trace=1)
    assert line["metrics"]["chunks_in_slice"]["value"] > 0
    assert line["correct"] is True
    assert_unchanged(root, before)


def test_a_configuration_of_a_family_there_is_one_file(tmp_path, capsys):
    """resnet101: its (3, 4, 23, 3) blocks are keys of its file alone."""
    from semi_supervised_vos_tpu_torch.utils import benchmarking as bm

    from vosbench import run

    root = make_tiny_root(tmp_path)
    before = files_under_vosbench(root)
    cfg = dict(resnet50_config(), model="resnet101", layers=[3, 4, 23, 3])
    add_config_cell(root, cfg, "resnet101")
    cell = run.resolve(root, "t-resnet101")
    assert cell["network"].__file__ == str(root / "vosbench" / "networks" / "resnet.py")
    assert cell["network"].frame_flops(cfg, 480, 854) == bm.vosnet_frame_flops("resnet101", (480, 854))
    line = run_cell(root, "t-resnet101", capsys)
    assert line["correct"] is True, line["checks"]
    assert_unchanged(root, before)


def test_a_new_family_is_one_new_module(tmp_path, capsys):
    """A family of basic-block ResNets, named by a resnet18 configuration,
    is found by name and runs the port's resnet18 correct."""
    from semi_supervised_vos_tpu_torch.utils import benchmarking as bm

    from vosbench import run

    root = make_tiny_root(tmp_path)
    before = files_under_vosbench(root)
    shutil.copy(ROOT / "vosbench" / "tests" / "basic_family.py", root / "vosbench" / "networks" / "basic.py")
    cfg = {k: v for k, v in resnet50_config().items() if k not in ("backbone_channels", "head", "expansion")}
    cfg.update(model="resnet18", network="basic", layers=[2, 2, 2, 2])
    add_config_cell(root, cfg, "resnet18")
    cell = run.resolve(root, "t-resnet18")
    assert cell["network"].__file__ == str(root / "vosbench" / "networks" / "basic.py")
    assert cell["network"].frame_flops(cfg, 480, 854) == bm.vosnet_frame_flops("resnet18", (480, 854))
    line = run_cell(root, "t-resnet18", capsys)
    assert line["correct"] is True, line["checks"]
    assert_unchanged(root, before)


@pytest.mark.parametrize("change, problem", [
    ({"network": "nonesuch"}, "unknown network 'nonesuch'"),
    ({"network": None}, "the key network names no family module"),
    ({"layers": None}, "needs the key(s) layers"),
    ({"head": [[1024, 512]]}, "head [[1024, 512]] does not lead from backbone_channels 1024 to feature_dim 256"),
    ({"stage_strides": [1, 2, 2, 1]}, "output_stride 8 is not 4 x the stage strides"),
], ids=["unknown-network", "no-network", "missing-key", "head", "stride"])
def test_a_bad_configuration_fails_in_resolve(tmp_path, change, problem):
    from vosbench import run

    root = make_tiny_root(tmp_path)
    before = files_under_vosbench(root)
    cfg = resnet50_config()
    cfg.update({k: v for k, v in change.items() if v is not None})
    for k in [k for k, v in change.items() if v is None]:
        del cfg[k]
    add_config_cell(root, cfg, "bad")
    with pytest.raises(ValueError, match=re.escape(problem)):
        run.resolve(root, "t-bad")
    assert_unchanged(root, before)


def test_quantity_of_a_qualified_name():
    from vosbench.run import quantity_of

    known = {"frames_per_s", "mfu.infer"}.__contains__
    assert quantity_of("frames_per_s", known) == "frames_per_s"
    assert quantity_of("frames_per_s.1080p", known) == "frames_per_s"
    assert quantity_of("mfu.infer.1080p", known) == "mfu.infer"
    assert quantity_of("mfu.train", known) is None
    assert quantity_of("chunk_p90_ms.1080p", known) is None


def test_a_qualified_entry_reports_its_quantity(tmp_path, capsys):
    """An end-to-end metric ``<quantity>.<qualifier>`` reports the driver's
    quantity, and a per-layer one reads with the quantity's reader: a
    quantity is split over cells by entries alone."""
    root = make_tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "t-single" in m.get("workloads", []):
            m["workloads"].remove("t-single")
    bench["end_to_end"].append({"name": "frames_per_s.tiny", "unit": "frames/s", "better": "higher", "bound": 0.5,
                                "source": "host_clock", "workloads": ["t-single"]})
    bench["per_layer"].append({"name": "dispatch_ms_per_chunk.tiny", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "loop", "moves": "frames_per_s.tiny",
                               "workloads": ["t-single"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    line = run_cell(root, "t-single", capsys)
    assert line["metrics"]["frames_per_s.tiny"]["value"] > 0 and "frames_per_s" not in line["metrics"]
    line = run_cell(root, "t-single", capsys, seconds=4.0, trace=1)
    assert sorted(line["metrics"]) == ["dispatch_ms_per_chunk.tiny"]
    assert line["metrics"]["dispatch_ms_per_chunk.tiny"]["value"] > 0
