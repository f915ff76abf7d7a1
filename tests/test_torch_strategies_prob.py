"""Port parity in probability mode (``--probability``: soft scores written
back into the bank, no spatial prior, the fused maps rounded to float16
before the argmax): the port's CLI on the CPU writes PNGs byte-identical to
the JAX CLI's for ``single`` and hor-flip under ``--fusion mean``; the other
two fusions are in ``tests/test_torch_strategies_fusion.py``."""

import pytest

from tests.test_torch_strategies import assert_cli_matches_jax, make_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("davis"))


@pytest.mark.parametrize("strategy,fusion", [("single", "mean"), ("hor-flip", "mean")])
def test_probability_pngs_byte_identical_to_jax(tree, tmp_path, monkeypatch, strategy, fusion):
    assert_cli_matches_jax(tree, tmp_path, monkeypatch, strategy, probability=True, fusion=fusion)
