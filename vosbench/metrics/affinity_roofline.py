"""Share of its roofline the affinity op reaches: the least time of each
call's work (the valid slots' similarity and label product at the bf16
rate or its exps at the MUFU rate, or each byte once at the memory rate,
``vosbench/counts.py``) over the device time of the kernels launched
inside the calls (the bank sweep and the combine)."""

from vosbench.counts import affinity_call_bound
from vosbench.reference.schedule import slot_inv_sigma2


def read(s):
    calls = s.calls.get("affinity", [])
    dev = s.device_s.get("affinity", 0.0)
    if not calls or dev <= 0:
        return None
    d = int(s.extra["num_classes"])
    cache, need = {}, 0.0
    for c in calls:
        valid = c["valid"]
        inv = slot_inv_sigma2(valid, c["dense"], *c["sigma"])[valid] if c["spatial"] else [0.0] * int(valid.sum())
        key = (tuple(float(x) for x in inv), c["lanes"], c["p"], c["hw"], c["c"], c["d_pad"])
        if key not in cache:
            cache[key] = affinity_call_bound(len(inv), c["lanes"], c["p"], c["hw"][1], c["c"], d, c["d_pad"], inv)
        need += cache[key]
    return 100.0 * need / dev
