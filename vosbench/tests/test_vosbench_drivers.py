"""The drivers run at a tiny size on the CPU through the port's plain
paths, print the contract's line, and are correct by the cells' limits."""

import pytest

from conftest import run_cell


@pytest.mark.parametrize("workload", ["t-single", "t-lock", "t-train"])
def test_a_run_prints_the_line(tiny_root, capsys, workload):
    line = run_cell(tiny_root, workload, capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    quantity = "train_steps_per_s" if workload == "t-train" else "frames_per_s"
    assert any(name.split(".")[0] == quantity for name in line["metrics"])


def test_a_traced_run_reads_its_slice(tiny_root, capsys):
    line = run_cell(tiny_root, "t-single", capsys, seconds=4.0, trace=1)
    assert line["correct"] is True
    assert line["device"]["window_s"] > 0
    assert "dispatch_ms_per_chunk" in line["metrics"]
    # no device on the CPU: the device readers find nothing and stay silent
    assert "affinity_roofline" not in line["metrics"] and "mfu.infer" not in line["metrics"]


def test_without_a_card_the_run_fails_and_prints_nothing(capsys):
    import torch

    from conftest import ROOT
    from vosbench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "r50-480p-single", "--seed", "1", "--seconds", "1", "--trace", "0"], root=ROOT)
    assert rc != 0
    assert capsys.readouterr().out == ""
