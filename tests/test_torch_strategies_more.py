"""Port parity, continued from ``tests/test_torch_strategies.py``: the port's
CLI on the CPU writes PNGs byte-identical to the JAX CLI's for multimodel and
3-scale in label mode, and for ``single`` with 20 reference frames (``-n
20``, more slots than the videos have frames)."""

import pytest

from tests.test_torch_strategies import assert_cli_matches_jax, make_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("davis"))


@pytest.mark.parametrize("strategy", ["multimodel", "3-scale"])
def test_label_strategy_pngs_byte_identical_to_jax(tree, tmp_path, monkeypatch, strategy):
    assert_cli_matches_jax(tree, tmp_path, monkeypatch, strategy)


def test_twenty_reference_frames_byte_identical_to_jax(tree, tmp_path, monkeypatch):
    assert_cli_matches_jax(tree, tmp_path, monkeypatch, "single", ref_num=20)
