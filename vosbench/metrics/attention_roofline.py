"""Share of its roofline the ViT's attention reaches: the least time of
each ``scaled_dot_product_attention`` call's work (its two products at the
bf16 rate, or its exps at the MUFU rate, or q, k, v and the output once at
the memory rate, ``vosbench/networks/vit.py::sdpa_call_bound``) over the
device time of the kernels launched inside the calls (the range
``vosbench.vit.sdpa``). None where no call was traced (a network without
it, or a program without the range)."""

from vosbench.networks.vit import sdpa_call_bound


def read(s):
    calls = s.calls.get("vit.sdpa", [])
    dev = s.device_s.get("vit.sdpa", 0.0)
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(sdpa_call_bound(c["b"], c["heads"], c["n"], c["kv"], c["d"]) for c in calls) / dev
