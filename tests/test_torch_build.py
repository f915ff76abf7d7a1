"""The kernel libraries' file names follow every source they are built from,
so an edited shared header can never load a stale library. No ``nvcc``
needed: only the paths are computed."""

import shutil

import pytest

from semi_supervised_vos_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    return copy


@pytest.mark.parametrize("name", _build.KERNELS)
def test_unchanged_copy_gives_the_same_library(csrc_copy, name):
    assert _build.library_path(name, csrc_copy) == _build.library_path(name)


@pytest.mark.parametrize("name", _build.KERNELS)
def test_new_header_changes_the_library(csrc_copy, name):
    before = _build.library_path(name, csrc_copy)
    (csrc_copy / "extra.cuh").write_text("#pragma once\nconstexpr int kExtra = 1;\n")
    assert _build.library_path(name, csrc_copy) != before


@pytest.mark.parametrize("name", _build.KERNELS)
def test_edited_shared_header_changes_the_library(csrc_copy, name):
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    before = _build.library_path(name, csrc_copy)
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    assert _build.library_path(name, csrc_copy) != before


@pytest.mark.parametrize("name", _build.KERNELS)
def test_other_files_leave_the_library(csrc_copy, name):
    before = _build.library_path(name, csrc_copy)
    (csrc_copy / "notes.txt").write_text("not a source")
    assert _build.library_path(name, csrc_copy) == before
