"""Port parity, continued from ``tests/test_torch_strategies.py``: the port's
CLI on the CPU writes PNGs byte-identical to the JAX CLI's for 2-scale and
hor-2-scale (a second engine at ceil((H, W) x 1.15)) in label mode."""

import pytest

from tests.test_torch_strategies import assert_cli_matches_jax, make_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("davis"))


@pytest.mark.parametrize("strategy", ["2-scale", "hor-2-scale"])
def test_label_strategy_pngs_byte_identical_to_jax(tree, tmp_path, monkeypatch, strategy):
    assert_cli_matches_jax(tree, tmp_path, monkeypatch, strategy)
