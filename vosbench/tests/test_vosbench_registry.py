"""A configuration, a traffic mix, a cell and a per-layer metric are found
by name when they are added as new files and entries, with no edit to a
file that is there."""

import json
import shutil

from conftest import ROOT, make_tiny_root, run_cell


def test_new_files_and_entries_are_found(tmp_path, capsys):
    root = make_tiny_root(tmp_path)
    before = {p.relative_to(root): p.read_bytes() for p in (root / "vosbench").rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "vosbench" / "configs" / "resnet50.json").read_text())
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
    after = {p.relative_to(root): p.read_bytes() for p in (root / "vosbench").rglob("*") if p.is_file()
             and p.relative_to(root) in before}
    assert after == before


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
