"""The whole train step's share of the card's TF32 peak (the precision the
configuration states for training): steps a second over the window times
a step's counted work (the forward's convolutions and the loss's two
products, three times, ``vosbench/counts.py``) over 495 TFLOP/s."""

from vosbench.counts import PEAK_TF32_FLOPS


def read(s):
    v = s.extra.get("useful_flops_per_s")
    return 100.0 * v / PEAK_TF32_FLOPS if v and s.busy_s > 0 else None
