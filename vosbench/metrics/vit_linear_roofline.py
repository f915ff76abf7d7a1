"""Share of its roofline the ViT's four products a block reach (qkv,
proj, fc1, fc2): the least time of each call's work (2·m·k·n at the bf16
rate, or its operands and output once at the memory rate,
``vosbench/networks/vit.py::linear_call_bound``) over the device time of the
kernels launched inside the calls (the range ``vosbench.vit.linear``).
None where no call was traced."""

from vosbench.networks.vit import linear_call_bound


def read(s):
    calls = s.calls.get("vit.linear", [])
    dev = s.device_s.get("vit.linear", 0.0)
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(linear_call_bound(c["m"], c["k"], c["n"]) for c in calls) / dev
