"""The port's own recorder (``semi_supervised_vos_tpu_torch.utils.profiling``)
as the ``program_span`` readers see it after a traced run. Each lookup
gives None where the recorder holds nothing (a run with ``--trace 0``) or
the program has none."""


def summary():
    """The recorder's ``summary()``, or None."""
    try:
        from semi_supervised_vos_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    s = summary()
    return s if s.get("spans") else None


def steps(s, step: str):
    """How many spans ``step`` closed, or None."""
    row = s["spans"].get(step) if s else None
    return row["count"] if row and row.get("count") else None


def within(s, name: str, step: str):
    """Span ``name``'s totals inside span ``step``, or None."""
    return s["spans"].get(name, {}).get("within", {}).get(step) if s else None


def device_ms_per_step(name: str):
    """Device ms of span ``name`` inside ``train.step``, per ``train.step``."""
    s = summary()
    n, part = steps(s, "train.step"), within(s, name, "train.step")
    if not n or not part or part["device_s"] is None:
        return None
    return part["device_s"] / n * 1e3
