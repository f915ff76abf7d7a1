"""Share of its roofline the fused bottleneck block reaches: the least
time of each call's work (its three convolutions at the bf16 rate, or its
activations and weights once at the memory rate, ``vosbench/counts.py``)
over the device time of the kernels launched inside the calls."""

from vosbench.counts import bottleneck_call_bound


def read(s):
    calls = s.calls.get("bottleneck", [])
    dev = s.device_s.get("bottleneck", 0.0)
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(bottleneck_call_bound(*c["shape"], c["c4"]) for c in calls) / dev
