"""Port parity for the lockstep engine (``--video-batch``): the port's CLI on
the CPU at ``--video-batch 2`` writes PNGs byte-identical to the JAX CLI's at
``--video-batch 2``, for every strategy and the probability cases below (the
two videos of ``tests/test_torch_strategies.py``'s tree run as one lockstep
group). The rest of the cases are in ``tests/test_torch_batched_more.py``."""

import pytest

from tests.test_torch_strategies import assert_cli_matches_jax, make_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("davis"))


@pytest.mark.parametrize(
    "strategy,probability,fusion",
    [("single", False, "mean"), ("hor-flip", False, "mean"), ("hor-flip", True, "mean"), ("vert-flip", False, "mean"),
     ("2-scale", False, "mean")],
)
def test_video_batch_pngs_byte_identical_to_jax(tree, tmp_path, monkeypatch, strategy, probability, fusion):
    assert_cli_matches_jax(tree, tmp_path, monkeypatch, strategy, probability, fusion, video_batch=2)
