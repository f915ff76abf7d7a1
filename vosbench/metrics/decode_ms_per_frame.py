"""Host ms a frame spends being decoded from its JPEG: the program's span
``data.decode`` (``data/davis.py::InferenceDataset``, on the prefetch
threads) over the frames it decoded (counter ``data.frames``) in the traced
slice; None where the program has no such span."""

from vosbench.spans import summary


def read(_slice):
    s = summary()
    frames = s["counters"].get("data.frames") if s else None
    row = s["spans"].get("data.decode") if s else None
    if not frames or not row:
        return None
    return row["host_s"] / frames * 1e3
