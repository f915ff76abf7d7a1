"""The control, on the card at the cells' own sizes: the reference with
float8 activations in place of the bfloat16 program (inference), the
program's own bfloat16 autocast path in place of float32 (training). Each
fails one of its cell's limits. Run on the card:

    python3 -m pytest vosbench/tests -m cuda -q
"""

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["r50-480p-single", "fb-480p-vb8", "r50-train-256", "r50-1080p-vb2"])
def test_control_fails_a_limit(cuda_device, workload):
    from vosbench import calibrate, run

    cell = run.resolve(ROOT, workload)
    if cell["traffic"]["driver"] == "train_step":
        row = calibrate.train_seed(cell, 3_141_592_653)
    else:
        row = calibrate.infer_seed(cell, 3_141_592_653, 5.0)
    limits = cell["limits"]
    assert all(row["program"][k] <= v for k, v in limits.items()), row["program"]
    assert any(row["control"][k] > v for k, v in limits.items()), row["control"]
