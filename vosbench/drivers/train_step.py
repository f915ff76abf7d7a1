"""Training as the train CLI steps: ``train/loop.py::make_train_step`` with
the CLI's optimizer (``train/train_state.py::make_optimizer``), the VOS
network in training mode, channels-last on the card, on a ring of seeded
batches staged on the card (the loader is bypassed).

Set-up builds one step object and drives it through its first three steps
on the ring's first three batches, through the window's own call; the
window continues the same object from the fourth. Each step is ended by its
loss reaching the host; the host queues step k + 1 before it waits for the
loss of step k, as a loop that logs every loss would.

Traffic keys: ``bs``, ``frames``, ``crop``, ``ring``, ``objects``, ``loss``.
"""

from __future__ import annotations

import math
import time

import torch

from vosbench import counts, videos
from vosbench.harness import Context, Outcome
from vosbench.reference.judge import loss_gap, moving_leaves, norm_gaps, relative_error
from vosbench.reference.train import run_steps
from vosbench.reference.vosnet import float32_exact
from vosbench.weights import parameter_keys, train_state_dict

FIRST_STEPS = 3


def program(cfg: dict, sd, device, bf16: bool):
    """The system under test: (step(imgs, anns) -> loss, the network, its
    optimizer), as the train CLI builds them."""
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec, make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    with torch.device("meta"):
        net = VOSNet(cfg["model"])
    net = net.to_empty(device=device)
    net.load_state_dict(sd)
    if torch.device(device).type == "cuda":
        net = net.to(memory_format=torch.channels_last)
    net.train()
    t = cfg["train"]
    opt = make_optimizer(net.parameters(), base_lr=t["lr"], momentum=t["momentum"], weight_decay=t["weight_decay"],
                         nesterov=t["nesterov"])
    step = make_train_step(net, LossSpec(name=t["loss"]), opt, num_classes=cfg["num_classes"], bf16=bf16)
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32, device=device)
    generator = torch.Generator(device=device).manual_seed(1)
    return (lambda imgs, anns: step(imgs, anns, centroids, generator)), net, opt


def first_steps(step, net, opt, ring):
    """Steps 1 .. FIRST_STEPS through ``step``: (their losses, each leaf's
    first gradient as the optimizer took it, each leaf after the last)."""
    names = {p: k for k, p in net.named_parameters()}
    losses, grad1 = [], None
    for i in range(FIRST_STEPS):
        losses.append(float(step(*ring[i])))
        if i == 0:
            grad1 = {names[p]: s["momentum_buffer"].detach().float().clone() for p, s in opt.state.items()}
    params = {k: p.detach().float().clone() for k, p in net.named_parameters()}
    return losses, grad1, params


def reference_run(arch: str, seed: int, ring, device):
    """The plain reference over the first steps from the same weights:
    (losses, first gradients as the optimizer takes them, raw first
    gradients, the leaves before, the leaves after)."""
    sd = train_state_dict(arch, seed, device)
    leaves = {k: sd[k] for k in parameter_keys(sd)}
    start = {k: v.clone() for k, v in leaves.items()}
    with float32_exact():
        losses, grad1, raw = run_steps(leaves, arch, list(ring[:FIRST_STEPS]))
    return losses, grad1, raw, start, leaves


def compare(program_out, ref, weight_decay: float) -> dict:
    """The readings of a program's first steps against the reference's.
    The first gradient is worked out from the optimizer's state after one
    step (momentum buffer = gradient + weight decay · starting leaf); the
    keys starting with ``_`` say where the worst leaf was."""
    losses, buf1, params = program_out
    ref_losses, _, ref_raw, start, final = ref
    # a leaf the optimizer kept no state for got no gradient
    grad1 = {k: buf1[k] - weight_decay * start[k] if k in buf1 else torch.zeros_like(start[k]) for k in start}
    moving = moving_leaves(ref_raw)
    grad_gap, grad_leaf = norm_gaps(grad1, ref_raw)
    change_gap, change_leaf = norm_gaps({k: params[k] - start[k] for k in params},
                                        {k: final[k] - start[k] for k in final}, moving)
    return {"loss_gap": loss_gap(losses, ref_losses), "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_err": relative_error(torch.cat([grad1[k].flatten() for k in ref_raw])[None],
                                       torch.cat([ref_raw[k].flatten() for k in ref_raw])[None]),
            "_grad_leaf": grad_leaf, "_change_leaf": change_leaf, "_left_out": len(final) - len(moving),
            "_losses": losses, "_ref_losses": ref_losses}


def run(ctx: Context) -> Outcome:
    cfg, tr, dev, tracer = ctx.config, ctx.traffic, ctx.device, ctx.tracer
    on_card = torch.device(dev).type == "cuda"
    ring = videos.make_train_ring(tr, ctx.seed, dev)
    ctx.mark("batches made")
    sd = train_state_dict(cfg["model"], ctx.seed, dev)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    step, net, opt = program(cfg, sd, dev, bf16=cfg["train"]["bf16"])
    del sd
    ctx.mark("step built")
    out = first_steps(step, net, opt, ring)
    if on_card:
        torch.cuda.synchronize(dev)
    tracer.warm(dev)
    ctx.mark("first steps run")

    slice_at, slice_end = ctx.slice_bounds()
    losses, fetched = [], []
    k = FIRST_STEPS
    t0 = ctx.window_started()
    deadline = t0 + ctx.seconds
    prev = None
    t_end = t0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        tracer.tick(now - t0, slice_at, slice_end, dev)
        with tracer.range("step"):
            loss = step(*ring[k % len(ring)])
        k += 1
        if prev is not None:
            with tracer.range("fetch"):
                losses.append(float(prev))
            t_end = time.perf_counter()
            fetched.append(t_end)
        prev = loss
    if prev is not None:
        losses.append(float(prev))
        t_end = time.perf_counter()
        fetched.append(t_end)
    ctx.window_closed()
    trace_slice = tracer.finish(dev)
    window = t_end - t0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    del step, net, opt, prev, loss
    if on_card:
        torch.cuda.empty_cache()
    readings = compare(out, reference_run(cfg["model"], ctx.seed, ring, dev), cfg["train"]["weight_decay"])
    rate = len(losses) / window
    if trace_slice is not None:
        flops = counts.train_step_flops(cfg["model"], tr["bs"], tr["frames"], tr["crop"], cfg["feature_dim"],
                                        cfg["num_classes"])
        # the traced run's rate: the steps done before the slice opened
        pre = [t for t in fetched if t <= tracer.t_start]
        trace_slice.extra.update({"useful_flops_per_s": len(pre) / (pre[-1] - t0) * flops})
    failed = sum(1 for x in losses if not math.isfinite(x))
    return Outcome(attempted=len(losses), failed=failed, metrics={"train_steps_per_s": (rate, "steps/s")},
                   readings={k: v for k, v in readings.items() if not k.startswith("_")},
                   memory_peak_bytes=int(peak), slice=trace_slice,
                   extra={"detail": {k: v for k, v in readings.items() if k.startswith("_")}})
