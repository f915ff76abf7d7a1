"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run driven on the CPU,
once for each fault the cells can have (no cell spans chips, so there is no
exchange between chips to leave out)."""

import pytest
import torch

from conftest import run_cell


def state_unchanged(monkeypatch):
    """Inference: a step propagates but leaves the bank as it was."""
    from semi_supervised_vos_tpu_torch.infer.engine import PropagationEngine

    monkeypatch.setattr(PropagationEngine, "_step", lambda self, target, state, i: self._propagate(target, state, i))


def answer_altered(monkeypatch):
    """Inference: every chunk's masks come out shifted by one cell."""
    from semi_supervised_vos_tpu_torch.infer.engine import PropagationEngine

    orig = PropagationEngine.step_chunk_small

    def altered(self, frames, state, start):
        masks, state = orig(self, frames, state, start)
        return torch.roll(masks, 1, dims=-1), state

    monkeypatch.setattr(PropagationEngine, "step_chunk_small", altered)


def half_the_lanes(monkeypatch):
    """Lockstep inference: the second half of the lanes is left out."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine

    orig = BatchedPropagationEngine._propagate

    def half(self, targets, state, i):
        pred = orig(self, targets, state, i)
        pred[pred.shape[0] // 2:] = 0
        return pred

    monkeypatch.setattr(BatchedPropagationEngine, "_propagate", half)


def train_state_unchanged(monkeypatch):
    """Training: the optimizer's step changes nothing."""
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)


def train_half_batch(monkeypatch):
    """Training: the loss over the first half of the batch, its mean taken
    over the rest."""
    from semi_supervised_vos_tpu_torch.train import loop

    orig = loop.make_loss_fn

    def make(spec, num_classes=22, bf16=False):
        fn = orig(spec, num_classes, bf16)
        return lambda net, imgs, anns, *a: fn(net, imgs[: len(imgs) // 2], anns[: len(anns) // 2], *a)

    monkeypatch.setattr(loop, "make_loss_fn", make)


def train_loss_altered(monkeypatch):
    """Training: the loss the step returns is altered where it is made."""
    from semi_supervised_vos_tpu_torch.train import loop

    orig = loop.make_loss_fn
    monkeypatch.setattr(loop, "make_loss_fn", lambda *a, **k: (lambda *x: orig(*a, **k)(*x) * 1.01))


@pytest.mark.parametrize("workload,fault", [
    ("t-single", state_unchanged), ("t-single", answer_altered),
    ("t-lock", state_unchanged), ("t-lock", answer_altered), ("t-lock", half_the_lanes),
    ("t-train", train_state_unchanged), ("t-train", train_half_batch), ("t-train", train_loss_altered),
])
def test_fault_comes_out_not_correct(tiny_root, capsys, monkeypatch, workload, fault):
    fault(monkeypatch)
    line = run_cell(tiny_root, workload, capsys)
    assert line["correct"] is False, line["checks"]
