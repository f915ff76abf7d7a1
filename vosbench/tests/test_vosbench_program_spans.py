"""The metrics read from the program's own recorder
(``semi_supervised_vos_tpu_torch.utils.profiling.summary()``): a traced run
of an inference driver reports the upload's host ms a chunk and the host
ms a frame beside it, and a traced run of the train driver records the
step's four parts, whose device ms stay unreported on the CPU (nothing is
timed on a card); an untraced run records nothing."""

import importlib.util

import pytest

from conftest import ROOT, run_cell

TRAIN = ("forward_ms_per_step", "loss_ms_per_step", "backward_ms_per_step", "optimizer_ms_per_step")


@pytest.fixture(autouse=True)
def fresh_recorder():
    from semi_supervised_vos_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def reader(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "vosbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("workload, upload", [("t-single", "upload_ms_per_chunk"),
                                              ("t-lock", "upload_ms_per_chunk.vb8")])
def test_a_traced_inference_run_reports_the_upload(tiny_root, capsys, fresh_recorder, workload, upload):
    line = run_cell(tiny_root, workload, capsys, seconds=4.0, trace=1)
    assert line["correct"] is True
    assert line["metrics"][upload]["unit"] == "ms" and line["metrics"][upload]["value"] > 0
    if workload == "t-single":
        assert line["metrics"]["host_ms_per_frame"]["value"] > 0
    s = fresh_recorder.summary()
    steps = s["spans"]["engine.step"]["count"]
    assert steps > 0 and s["counters"]["upload.calls"] >= steps
    assert s["spans"]["drain.job"]["count"] > 0


def test_a_traced_train_run_times_its_four_parts(tiny_root, capsys, fresh_recorder):
    line = run_cell(tiny_root, "t-train", capsys, seconds=4.0, trace=1)
    assert line["correct"] is True
    spans = fresh_recorder.summary()["spans"]
    steps = spans["train.step"]["count"]
    assert steps > 0
    for part in ("train.forward", "train.loss", "train.backward", "train.optimizer"):
        assert spans[part]["within"]["train.step"]["count"] == steps
        assert spans[part]["device_s"] is None
    assert not any(name in line["metrics"] for name in TRAIN)
    assert all(reader(name)(None) is None for name in TRAIN)


def test_an_untraced_run_records_nothing(tiny_root, capsys, fresh_recorder):
    line = run_cell(tiny_root, "t-single", capsys)
    assert line["correct"] is True
    assert fresh_recorder.summary()["spans"] == {}
    assert reader("upload_ms_per_chunk")(None) is None and reader("host_ms_per_frame")(None) is None
