"""Device ms a frame spends in Hiera's windowed and transition blocks'
attention halves (each such block's LN1, qkv, the windows' padding,
partition, pooling, attention and unpartition, proj, the transition's
shortcut and the residual): the program's span ``hiera.window_attention``,
timed on the card by CUDA events, over the frames Hiera encoded (counter
``hiera.frames``) in the traced slice; None where the program has no such
span or nothing was timed on a card."""

from vosbench.spans import summary


def read(_slice):
    s = summary()
    frames = s["counters"].get("hiera.frames") if s else None
    row = s["spans"].get("hiera.window_attention") if s else None
    if not frames or not row or row.get("device_s") is None:
        return None
    return row["device_s"] / frames * 1e3
