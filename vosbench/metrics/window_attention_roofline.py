"""Share of its roofline Hiera's windowed attention reaches: the least time
of the attention in each windowed or transition block's call (its two
products at the bf16 rate, or its exps at the MUFU rate, or q, k, v and the
output once at the memory rate,
``vosbench/networks/hiera.py::window_attention_call_bound``) over the device
time of the kernels launched inside the calls (the range
``vosbench.hiera.window``: the grid's padding, the partition into windows,
the queries' pooling and the unpartition besides attention, so the reading
shows what the layout costs). None where no call was traced (a network
without it, or a program without the function)."""

from vosbench.networks.hiera import window_attention_call_bound


def read(s):
    calls = s.calls.get("hiera.window", [])
    dev = s.device_s.get("hiera.window", 0.0)
    if not calls or dev <= 0:
        return None
    return 100.0 * sum(window_attention_call_bound(c["b"], c["heads"], c["n"], c["kv"], c["d"]) for c in calls) / dev
