"""Host ms a frame's mask spends being written as a palette PNG: the
program's span ``png.write`` (``utils/image.py::save_prediction``) over its
count in the traced slice; None where nothing was written."""

from vosbench.spans import summary


def read(_slice):
    s = summary()
    row = s["spans"].get("png.write") if s else None
    if not row or not row.get("count"):
        return None
    return row["host_s"] / row["count"] * 1e3
