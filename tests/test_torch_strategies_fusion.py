"""Port parity in probability mode, continued from
``tests/test_torch_strategies_prob.py``: 2-scale under ``--fusion maximum``
and multimodel under ``--fusion minimum`` write PNGs byte-identical to the
JAX CLI's on the CPU."""

import pytest

from tests.test_torch_strategies import assert_cli_matches_jax, make_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("davis"))


@pytest.mark.parametrize("strategy,fusion", [("2-scale", "maximum"), ("multimodel", "minimum")])
def test_probability_pngs_byte_identical_to_jax(tree, tmp_path, monkeypatch, strategy, fusion):
    assert_cli_matches_jax(tree, tmp_path, monkeypatch, strategy, probability=True, fusion=fusion)
