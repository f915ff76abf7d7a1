"""The whole inference step's share of the card's bf16 peak: real
lane-frames a second over the window times each frame's counted work (its
convolutions and its affinity op's valid slots, ``vosbench/counts.py``)
over 989 TFLOP/s."""

from vosbench.counts import PEAK_BF16_FLOPS


def read(s):
    v = s.extra.get("useful_flops_per_s")
    return 100.0 * v / PEAK_BF16_FLOPS if v and s.busy_s > 0 else None
